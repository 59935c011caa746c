"""The port's segmented PCG (``krylov.PCGLoop``) against
``polystokes_tpu.krylov.pcg_segment``, and its gated pass.

* Krylov level: a dense SPD system of order 64 from
  ``np.random.default_rng``, fp64, Jacobi-preconditioned; both packages
  chain segments of 7 iterations.  At every segment boundary k and done are
  equal and x agrees within 1e-12 relative; also with ``max_iters`` inside
  a segment, and for a zero right-hand side (done at k = 0).
* Gating: passes past convergence or past the segment's bound leave the
  carry bit-unchanged, and the port's gated loop is bit-equal, with the
  same k, to an ungated loop (the body before gating, copied here as the
  oracle) on honey_coil 16^3 fp64, Path A and Path F.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import krylov as jkrylov

from polystokes_tpu_torch import krylov
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.scenes.builders import honey_coil

torch.set_num_threads(1)

N = 64
SEGMENT = 7
TOL = 1e-8
X_RTOL = 1e-12  # fp64 sums of 64 terms in another order than JAX's


def _system(seed=0):
    """(A, b): SPD with eigenvalues spread over [1, 10], so that CG
    converges in 27 iterations, well inside N, where round-off has not yet
    decided the count: the rre of the last two iterations lie at 0.65 and
    4.4 tol^2, and x agrees with JAX's to 5e-16 relative."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = (q * np.geomspace(1.0, 10.0, N)) @ q.T
    return 0.5 * (a + a.T), rng.standard_normal(N)


def _jax_segments(a, b, max_iters):
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    inv_d = 1.0 / jnp.diag(aj)
    carry = jkrylov.pcg_init(lambda x: aj @ x, bj, jnp.zeros_like(bj), lambda r: inv_d * r)
    out = []
    while True:
        carry = jkrylov.pcg_segment(lambda x: aj @ x, carry, lambda r: inv_d * r, tol=TOL, max_iters=max_iters,
                                    segment_iters=SEGMENT)
        out.append((int(carry.k), bool(carry.done), np.asarray(carry.x)))
        if out[-1][1] or out[-1][0] >= max_iters:
            return out


def _port_loop(a, b, max_iters):
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    inv_d = 1.0 / torch.diagonal(at)
    carry = krylov.pcg_init(lambda x: at @ x, bt, torch.zeros_like(bt), lambda r: inv_d * r)
    loop = krylov.PCGLoop(lambda x: at @ x, lambda r: inv_d * r, tol=TOL, max_iters=max_iters)
    return carry, loop


def _port_segments(a, b, max_iters):
    """``krylov.pcg_segment`` chained as JAX's: a new loop each segment."""
    at = torch.as_tensor(a)
    inv_d = 1.0 / torch.diagonal(at)
    carry, _ = _port_loop(a, b, max_iters)
    out = []
    while True:
        carry = krylov.pcg_segment(lambda x: at @ x, carry, lambda r: inv_d * r, tol=TOL, max_iters=max_iters,
                                   segment_iters=SEGMENT)
        out.append((int(carry.k), bool(carry.done), carry.x.numpy()))
        if out[-1][1] or out[-1][0] >= max_iters:
            return out


@pytest.mark.parametrize("max_iters", [5000, 17], ids=["converges", "max_iters-in-segment"])
def test_segments_match_jax(max_iters):
    a, b = _system()
    want, got = _jax_segments(a, b, max_iters), _port_segments(a, b, max_iters)
    assert [(k, d) for k, d, _ in got] == [(k, d) for k, d, _ in want]
    assert len(want) >= 3
    for (_, _, xg), (_, _, xw) in zip(got, want):
        np.testing.assert_allclose(xg, xw, rtol=0, atol=X_RTOL * np.abs(xw).max())
    if max_iters == 17:
        assert want[-1][:2] == (17, False)


def test_zero_rhs_is_done_at_k0():
    a, _ = _system()
    zero = np.zeros(N)
    want, got = _jax_segments(a, zero, 5000), _port_segments(a, zero, 5000)
    assert [(k, d) for k, d, _ in got] == [(k, d) for k, d, _ in want] == [(0, True)]
    carry, loop = _port_loop(a, zero, 5000)
    assert not loop.segment(carry, SEGMENT).x.any() and loop.passes == 0


def _equal(c1, c2):
    return all(torch.equal(t1, t2) and t1.dtype == t2.dtype for t1, t2 in zip(c1, c2))


def test_passes_after_convergence_are_bit_neutral():
    a, b = _system()
    carry, loop = _port_loop(a, b, 5000)
    done = loop.segment(carry)
    assert bool(done.done)
    assert _equal(loop.run(done, 9, k_end=5000), done)


def test_passes_at_the_bound_are_bit_neutral():
    a, b = _system()
    carry, loop = _port_loop(a, b, 5000)
    first = loop.segment(carry, SEGMENT)
    assert int(first.k) == SEGMENT and not bool(first.done)
    assert _equal(loop.run(first, 5, k_end=SEGMENT), first)


def test_carry_dtypes_and_device():
    a, b = _system()
    carry, _ = _port_loop(a, b, 5000)
    assert (carry.k.dtype, carry.rre.dtype, carry.done.dtype) == (torch.int32, torch.float64, torch.bool)
    assert all(t.dim() == 0 for t in carry[3:])


def _ungated_pcg(apply_A, b, x0, precond, tol, max_iters, apply_dot=None, fused_update=None):
    """The loop body before gating: one host read of done a pass."""
    x, r, p, rsold, k, rre, done = krylov.pcg_init(apply_A, b, x0, precond)
    k, done = int(k), bool(done)
    while not done and k < max_iters:
        if apply_dot is not None:
            Ap, pAp = apply_dot(p)
        else:
            Ap = apply_A(p)
            pAp = krylov._dot(p, Ap)
        alpha = rsold / torch.where(pAp != 0, pAp, 1.0)
        if fused_update is not None:
            x, r, z, rr, xmag, rs = fused_update(x, r, p, Ap, alpha)
        else:
            x = x + alpha * p
            r = r - alpha * Ap
            rr, xmag = krylov._dot(r, r), krylov._dot(x, x)
            z = precond(r)
            rs = krylov._dot(r, z)
        rre = krylov._rre(rr, xmag)
        p = (rs / rsold) * p + z
        rsold = rs
        k += 1
        done = bool(rre < tol * tol)
    return x, k


@pytest.mark.parametrize("fuse_update", [False, True], ids=["A", "F"])
def test_gated_loop_bit_equal_to_ungated(fuse_update):
    grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
    params = SolverParams(do_tile=False, dtype=torch.float64, tile_size=8, tile_padding=2, max_regions=64, tolerance=1e-3,
                          max_iterations=2000, fuse_update=fuse_update, bicgstab_fallback=False,
                          preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)
    cls, asm = tsolver._setup(grid, scene, params)
    apply_K, apply_dot, fused, precond, b_K, x0_K = tsolver._build_krylov_system(grid, cls, asm, scene, params)
    assert apply_dot is not None and (fused is not None) == fuse_update
    res = krylov.pcg(apply_K, b_K, x0_K, precond, tol=1e-3, max_iters=2000, apply_dot=apply_dot, fused_update=fused)
    x_plain, k_plain = _ungated_pcg(apply_K, b_K, x0_K, precond, 1e-3, 2000, apply_dot, fused)
    assert res.converged and res.applies == 1 + k_plain
    assert res.passes > k_plain  # the last poll block ran gated passes
    assert torch.equal(res.x, x_plain)


@pytest.mark.parametrize("kind", ["none", "diag"])
def test_update_writes_into_out(kind):
    """The update wrappers write x' and r' into ``out`` (the loop's spare
    pair) with the values they return without it."""
    from polystokes_tpu_torch.packed_apply import cg_update_packed

    rng = np.random.default_rng(3)
    x, r, p, ap, f = (torch.as_tensor(rng.standard_normal((7, 4, 4, 4))) for _ in range(5))
    f = f if kind == "diag" else None
    alpha = torch.tensor(0.3, dtype=torch.float64)
    want = cg_update_packed(x, r, p, ap, alpha, f, kind)
    out = (torch.empty_like(x), torch.empty_like(x))
    got = cg_update_packed(x, r, p, ap, alpha, f, kind, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="out"):
        cg_update_packed(x, r, p, ap, alpha, f, kind, out=(x, out[1]))
