"""BiCGStab and the cropped solve on a card against the CPU port (marker
``cuda``; each test skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_solvers.py -m cuda --noconftest -q

* ``step`` with ``solver_type`` BICGSTAB on honey_coil 32^3, untiled cube
  regions, tile 16, fp64, tol 1e-5: both converge, velocities within
  VEL_ATOL of max |v|.  fp64, because in f32 this BiCGStab (JAX's, copied
  literally) at tol 1e-5 meets its test rre = min(|err|^2, |err| / |x|)
  < tol only by letting x grow without bound.
* ``domain.solve_cropped`` on a liquid sphere in a 32^3 box (cropped to
  16^3), f32, tiled, tile 8, tol 1e-5: both converge on the same box,
  velocities within VEL_ATOL of max |v|, the input velocity outside the
  box on both.
"""
import numpy as np
import pytest
import torch

from polystokes_tpu_torch import PreconditionerType, Scene, SolverParams, domain, step
from polystokes_tpu_torch.config import SolverType
from polystokes_tpu_torch.grid import Grid
from polystokes_tpu_torch.scenes.builders import honey_coil

# the packed CELL_ARROW path, stated since the defaults became JAX's (IDENTITY, unpacked)
PACKED_ARROW = dict(preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)

VEL_ATOL = 2e-4  # times max |v|: the packed-against-XLA bound of the JAX tests, after a converged solve
N = 32


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _agree(got, ref):
    got, ref = [t.cpu().double() for t in got], [t.cpu().double() for t in ref]
    scale = max(float(r.abs().max()) for r in ref)
    assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) <= VEL_ATOL * scale


@pytest.mark.cuda
def test_bicgstab_step_card_against_cpu():
    _require_cuda()
    params = SolverParams(dtype=torch.float64, do_tile=False, tile_size=16, tile_padding=2, max_regions=64,
                          tolerance=1e-5, max_iterations=5000, solver_type=SolverType.BICGSTAB, **PACKED_ARROW)
    out = {}
    for where in ("cuda", "cpu"):
        grid, scene = honey_coil(n=N, dtype=torch.float64, device=where)
        vel, _, stats = step(grid, scene, params)
        assert stats["converged"] and stats["boundary_active"] == 0, (where, stats)
        assert stats["operator_applies"] == 4 + 3 * stats["iterations"], (where, stats)
        out[where] = vel
    _agree(out["cuda"], out["cpu"])


def _sphere(device):
    rng = np.random.default_rng(3)
    idx = np.indices((N, N, N)) / N
    surf = np.sqrt(sum((idx[a] - c) ** 2 for a, c in enumerate((0.72, 0.22, 0.72)))) - 0.1
    faces = [tuple(N + (a == b) for b in range(3)) for a in range(3)]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return Scene(surface_sdf=t(surf), collision_sdf=t(np.ones((N, N, N))),
                 velocity=tuple(t(rng.standard_normal(s)) for s in faces),
                 collision_velocity=tuple(t(np.zeros(s)) for s in faces), viscosity=t(np.full((N, N, N), 8.0)),
                 dt=t(1 / 24))


@pytest.mark.cuda
def test_solve_cropped_card_against_cpu():
    _require_cuda()
    params = SolverParams(dtype=torch.float32, do_tile=True, tile_size=8, tile_padding=2, tolerance=1e-5,
                          max_iterations=12000, **PACKED_ARROW)
    grid = Grid(res=(N, N, N), dx=1.0 / N)
    out = {}
    for where in ("cuda", "cpu"):
        scene = _sphere(where)
        vel, valid, stats = domain.solve_cropped(grid, scene, params, segment_iters=500)
        assert stats["converged"] and stats["crop"]["res"] == (16, 16, 16), (where, stats)
        lo, hi = stats["crop"]["lo"], stats["crop"]["hi"]
        for a in range(3):
            outside = torch.ones(vel[a].shape, dtype=torch.bool, device=where)
            outside[tuple(slice(lo[i], hi[i] + (i == a)) for i in range(3))] = False
            assert torch.equal(vel[a][outside], scene.velocity[a][outside]) and not valid[a][outside].any()
        out[where] = vel
    _agree(out["cuda"], out["cpu"])
