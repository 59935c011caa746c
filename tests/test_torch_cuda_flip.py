"""The FLIP loop on a card against the CPU port (marker ``cuda``; each test
skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_flip.py -m cuda --noconftest -q

* ``p2g``, ``g2p_flip``, ``advect_particles``, ``surface_from_particles``
  and ``reseed`` at 16^3 on jelly_jam's particles with random velocities,
  f32 and fp64, against the same calls on the CPU;
* the fixed-order P2G sum bit-equal on a repeat on the card;
* one ``flip_frame`` with reseeding (16^3, f32, CELL_ARROW, tol 1e-5) on
  the card against the CPU: velocities within VEL_ATOL of max |v|, and
  two frames on the card bit-equal.
"""
import numpy as np
import pytest
import torch

from polystokes_tpu_torch import PreconditionerType, SolverParams, flip
from polystokes_tpu_torch.scenes.builders import jelly_jam

N = 16
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # the same ops; sums and FMA contraction may differ
VEL_ATOL = 2e-4  # times max |v|: the packed-against-XLA bound of the JAX tests, after a converged step
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(dtype):
    grid, scene = jelly_jam(n=N, dtype=dtype, device="cpu")
    st = flip.seed_particles(grid, scene.surface_sdf, 20000, dtype=dtype)
    rng = np.random.default_rng(2)
    st = flip.FlipState(pos=st.pos, vel=torch.from_numpy(rng.standard_normal((20000, 3))).to(dtype), alive=st.alive)
    vel = tuple(torch.from_numpy(rng.standard_normal(grid.face_shape(a))).to(dtype) for a in range(3))
    return grid, scene, st, vel


def _cuda(x):
    if isinstance(x, flip.FlipState):
        return flip.FlipState(pos=x.pos.cuda(), vel=x.vel.cuda(), alive=x.alive.cuda())
    return tuple(t.cuda() for t in x) if isinstance(x, tuple) else x.cuda()


def _close(got, ref, dtype):
    ref = ref.double()
    assert float((got.cpu().double() - ref).abs().max()) <= RTOL[dtype] * float(ref.abs().max())


@pytest.mark.cuda
@DTYPES
def test_transfers_card_against_cpu(dtype):
    _require_cuda()
    grid, _, st, vel = _inputs(dtype)
    for got, ref in zip(flip.p2g(_cuda(st), grid, dtype)[0] + flip.p2g(_cuda(st), grid, dtype)[1],
                        flip.p2g(st, grid, dtype)[0] + flip.p2g(st, grid, dtype)[1]):
        _close(got, ref, dtype)
    _close(flip.g2p_flip(_cuda(st), _cuda(vel), _cuda(vel), 0.95).vel, flip.g2p_flip(st, vel, vel, 0.95).vel, dtype)
    _close(flip.advect_particles(_cuda(st), _cuda(vel), 0.5, grid.res).pos, flip.advect_particles(st, vel, 0.5, grid.res).pos,
           dtype)
    surf = flip.surface_from_particles(st, grid, dtype=dtype)
    _close(flip.surface_from_particles(_cuda(st), grid, dtype=dtype), surf, dtype)
    got = flip.reseed(_cuda(st), grid, surf.cuda(), _cuda(vel), 2)
    ref = flip.reseed(st, grid, surf, vel, 2)
    assert torch.equal(got.alive.cpu(), ref.alive)
    _close(got.pos, ref.pos, dtype)


@pytest.mark.cuda
def test_p2g_repeat_bit_equal_on_the_card():
    _require_cuda()
    grid, _, st, _ = _inputs(torch.float32)
    a = flip.p2g(_cuda(st), grid, torch.float32)
    b = flip.p2g(_cuda(st), grid, torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


@pytest.mark.cuda
def test_flip_frame_card_against_cpu():
    _require_cuda()
    params = SolverParams(dtype=torch.float32, preconditioner=PreconditionerType.CELL_ARROW, tolerance=1e-5,
                          max_iterations=20000)
    out = {}
    for where in ("cpu", "cuda", "cuda"):
        grid, scene = jelly_jam(n=N, dtype=torch.float32, device=where)
        st = flip.seed_particles(grid, scene.surface_sdf, 20000)
        sc, st, stats = flip.flip_frame(grid, scene, st, params, do_reseed=True, frame_idx=0)
        assert stats["converged"]
        out.setdefault(where, []).append((sc, st))
    (c1, s1), (c2, s2) = out["cuda"]
    assert all(torch.equal(a, b) for a, b in zip(c1.velocity + (s1.pos, s1.alive), c2.velocity + (s2.pos, s2.alive)))
    ref = out["cpu"][0][0].velocity
    vmax = max(float(v.abs().max()) for v in ref)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(c1.velocity, ref)) <= VEL_ATOL * vmax
