"""The frame loop on a card against the CPU port (marker ``cuda``; each test
skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_sim.py -m cuda --noconftest -q

* ``_trilinear``, ``advect_field`` (substeps 1 and 3) and
  ``advect_field_gather`` at n = 24 in f32 and f64, fields and velocities
  from a numpy seed, against the same call on the CPU;
* one ``simulate_frame`` of honey_coil 32^3 (tiled, tile 8, the device
  warm start on), f32, tol 1e-5, on the card against the CPU: both
  converge, velocities within VEL_ATOL of max |v| over the three
  components and the surface SDF within VEL_ATOL of max |SDF|.
"""
import numpy as np
import pytest
import torch

from polystokes_tpu_torch import PreconditionerType, SolverParams, sim
from polystokes_tpu_torch.grid import face_offsets
from polystokes_tpu_torch.scenes.builders import honey_coil

# the packed CELL_ARROW path, stated since the defaults became JAX's (IDENTITY, unpacked)
PACKED_ARROW = dict(preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)

N = 24
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # the same ops; FMA contraction may differ
VEL_ATOL = 2e-4  # times max: the packed-against-XLA bound of the JAX tests, after a converged step
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(dtype):
    rng = np.random.default_rng(3)
    fld = torch.from_numpy(rng.standard_normal((N, N, N)) + 2.0).to(dtype)
    vel = tuple(torch.from_numpy(0.9 * rng.standard_normal(tuple(N + (b == a) for b in range(3)))).to(dtype)
                for a in range(3))
    return fld, vel


def _close(got, ref, dtype):
    ref = ref.double()
    assert float((got.cpu().double() - ref).abs().max()) <= RTOL[dtype] * float(ref.abs().max())


@pytest.mark.cuda
@DTYPES
def test_trilinear_card_against_cpu(dtype):
    _require_cuda()
    fld, _ = _inputs(dtype)
    rng = np.random.default_rng(5)
    pos = [torch.from_numpy(rng.uniform(-2.5, N + 1.5, size=(N, N, N))).to(dtype) for _ in range(3)]
    _close(sim._trilinear(fld.cuda(), *(p.cuda() for p in pos)), sim._trilinear(fld, *pos), dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("substeps", [1, 3])
def test_advect_field_card_against_cpu(dtype, substeps):
    _require_cuda()
    fld, vel = _inputs(dtype)
    for f, offsets in ((fld, (0.0, 0.0, 0.0)), (vel[1], face_offsets(1))):
        ref = sim.advect_field(f, vel, 1.3, offsets, substeps=substeps)
        got = sim.advect_field(f.cuda(), tuple(v.cuda() for v in vel), 1.3, offsets, substeps=substeps)
        _close(got, ref, dtype)


@pytest.mark.cuda
@DTYPES
def test_advect_field_gather_card_against_cpu(dtype):
    _require_cuda()
    fld, vel = _inputs(dtype)
    for f, offsets in ((fld, (0.0, 0.0, 0.0)), (vel[2], face_offsets(2))):
        ref = sim.advect_field_gather(f, vel, 1.3, offsets)
        got = sim.advect_field_gather(f.cuda(), tuple(v.cuda() for v in vel), 1.3, offsets)
        _close(got, ref, dtype)


@pytest.mark.cuda
def test_simulate_frame_card_against_cpu():
    _require_cuda()
    params = SolverParams(dtype=torch.float32, do_tile=True, tile_size=8, tile_padding=2, tolerance=1e-5,
                          max_iterations=12000, device_warm_start=True, bicgstab_fallback=False, **PACKED_ARROW)
    out = {}
    for where in ("cuda", "cpu"):
        grid, scene = honey_coil(n=32, dtype=torch.float32, device=where)
        substeps = sim.cfl_substeps(scene.velocity, float(scene.dt) / grid.dx)
        frame, stats = sim.simulate_frame(grid, scene, params, substeps=substeps)
        assert stats["converged"], (where, stats)
        out[where] = [t.cpu().double() for t in frame.velocity + (frame.surface_sdf,)]
    # the velocities against the max over their three components (one may be
    # near zero), the SDF against its own
    for got, ref in ((out["cuda"][:3], out["cpu"][:3]), (out["cuda"][3:], out["cpu"][3:])):
        scale = max(float(r.abs().max()) for r in ref)
        assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) <= VEL_ATOL * scale
