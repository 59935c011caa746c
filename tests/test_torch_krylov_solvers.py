"""The port's BiCGStab, MINRES and flexible PCG against
``polystokes_tpu.krylov``, and ``step`` with each solver against JAX's.

* Krylov level: a dense SPD system of order 64 made from
  ``np.random.default_rng``, fp64 (flex_pcg Jacobi-preconditioned).  At a
  fixed iteration count (tol 0, so no solve stops early) x agrees with
  JAX's within X_RTOL; run to convergence, the iterations, the error and
  converged agree.  A loop that polls ``done`` after every pass (no gated
  pass) gives the same x, bit for bit, as the default poll every
  POLL_PASSES passes, whose passes past convergence are gated.
* Step level: honey_coil 16^3, fp64, untiled cube regions, tile 8,
  CELL_ARROW, ``use_pallas=True`` (the JAX side through its Pallas kernels
  in interpret mode), one JAX step per case: BICGSTAB to convergence at
  TOL_STEP, iterations within ITER_RTOL, velocities within VEL_ATOL
  and each error under tol;
  MINRES and, on the uniform step (kernel 7), a forced fallback (PCG
  stopped unconverged at FIXED iterations, then BiCGStab from the same x0
  for as many) at a fixed iteration count, held to STEP_RTOL.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import krylov as jkrylov
from polystokes_tpu import step as jstep
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.config import SolverType as JSolverType
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert, krylov
from polystokes_tpu_torch import step as tstep

torch.set_num_threads(1)

N = 64
FIXED = 12
TOL = 1e-8
X_RTOL = 1e-10  # fp64: sums of 64 terms in another order than JAX's (5.7e-16 measured at 12 iterations)
# MINRES's recurrences lose orthogonality: x parts from JAX's by 7.8e-15 at
# 12 iterations, 2.5e-10 at 30 and 5.2e-5 at its convergence (50), and its
# converged rre by 0.5 %
MINRES_X_RTOL = 1e-4
MINRES_ERROR_RTOL = 0.02
VEL_ATOL = 2e-4  # times max |v_jax|: the packed-against-XLA bound of tests/test_pallas_apply.py
# BiCGStab's tol: at 1e-3 two converged solves on trajectories parted by
# round-off differed by up to 1.6e-3 of max |v| (JAX's own sum order varies
# from run to run), so the converged case solves tighter
TOL_STEP = 1e-6
# BiCGStab's iteration count at TOL_STEP is a trajectory: 344 against JAX's
# 373 measured (velocities then 2.9e-5 of max |v| apart)
ITER_RTOL = 0.15
STEP_RTOL = 1e-10  # times max |v_jax|, fp64 at a fixed iteration count


def _system(seed=0):
    """(A, b): SPD, eigenvalues spread over [1, 10]; the solvers converge
    well inside N."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = (q * np.geomspace(1.0, 10.0, N)) @ q.T
    return 0.5 * (a + a.T), rng.standard_normal(N)


def _solve_jax(name, a, b, tol, max_iters):
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    kw = dict(tol=tol, max_iters=max_iters)
    if name == "flex_pcg":
        inv_d = 1.0 / jnp.diag(aj)
        kw["precond"] = lambda r: inv_d * r
    res = getattr(jkrylov, name)(lambda x: aj @ x, bj, jnp.zeros_like(bj), **kw)
    return np.asarray(res.x), int(res.iterations), float(res.error), bool(res.converged)


def _solve_port(name, a, b, tol, max_iters):
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    kw = dict(tol=tol, max_iters=max_iters)
    if name == "flex_pcg":
        inv_d = 1.0 / torch.diagonal(at)
        kw["precond"] = lambda r: inv_d * r
    return getattr(krylov, name)(lambda x: at @ x, bt, torch.zeros_like(bt), **kw)


def test_solvers_match_jax_on_a_dense_system(monkeypatch):
    a, b = _system()
    for name in ("bicgstab", "minres", "flex_pcg"):
        xj, kj, _, dj = _solve_jax(name, a, b, 0.0, FIXED)
        got = _solve_port(name, a, b, 0.0, FIXED)
        assert (got.iterations, got.converged) == (kj, dj) == (FIXED, False), name
        np.testing.assert_allclose(got.x.numpy(), xj, rtol=0, atol=X_RTOL * np.abs(xj).max(), err_msg=name)

        xj, kj, ej, dj = _solve_jax(name, a, b, TOL, 5000)
        got = _solve_port(name, a, b, TOL, 5000)
        assert dj and got.converged and got.iterations == kj < N, name
        x_rtol, e_rtol = (MINRES_X_RTOL, MINRES_ERROR_RTOL) if name == "minres" else (X_RTOL, X_RTOL)
        assert abs(got.error - ej) <= e_rtol * ej, name
        np.testing.assert_allclose(got.x.numpy(), xj, rtol=0, atol=x_rtol * np.abs(xj).max(), err_msg=name)
        assert got.passes >= got.iterations + 1 and got.passes % krylov.POLL_PASSES == 0, name

        with monkeypatch.context() as m:
            m.setattr(krylov, "POLL_PASSES", 1)
            each = _solve_port(name, a, b, TOL, 5000)
        assert each.passes <= got.passes, name
        assert torch.equal(each.x, got.x) and (each.iterations, each.error) == (got.iterations, got.error), name


_CASES = {
    # (JAX SolverParams over the base, converged expected)
    "bicgstab": (dict(solver_type=JSolverType.BICGSTAB, bicgstab_fallback=False, max_iterations=2000, tolerance=TOL_STEP),
                 True),
    "minres": (dict(solver_type=JSolverType.MINRES, bicgstab_fallback=False, max_iterations=FIXED), False),
    "fallback": (dict(bicgstab_fallback=True, max_iterations=FIXED, do_reduced_regions=False), False),
}


@pytest.fixture(scope="module")
def steps():
    """One JAX step and one port step per case, run on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
            jp = JParams(dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64,
                         preconditioner=JPC.CELL_ARROW, **{"tolerance": 1e-3, "use_pallas": True, **_CASES[case][0]})
            vj, _, sj = jstep(grid, scene, jp)
            vt, _, st = tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"),
                              convert.params_from_jax(jp))
            cache[case] = ([np.asarray(v) for v in vj], sj, [v.numpy() for v in vt], st)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(_CASES))
def test_step_matches_jax(steps, case):
    vj, sj, vt, st = steps(case)
    converged = _CASES[case][1]
    assert bool(sj["converged"]) == st["converged"] == converged
    assert int(sj["boundary_active"]) == st["boundary_active"] == 0
    for key in ("n_regions", "n_pressures", "n_active_velocities", "n_stresses"):
        assert st[key] == int(sj[key]), key
    scale = max(float(np.max(np.abs(v))) for v in vj)
    ej = float(sj["error"])
    if converged:
        # BiCGStab's trajectory parts from JAX's by round-off growth (velocities
        # 1e-14 apart at 12 iterations, 2e-6 at 30, 1.7e-3 at 60 of max |v|),
        # and its error is rre itself, a squared residual: each side is held
        # to tol
        assert abs(st["iterations"] - int(sj["iterations"])) <= ITER_RTOL * int(sj["iterations"])
        assert 0.0 < st["error"] < TOL_STEP and 0.0 < ej < TOL_STEP
        atol = VEL_ATOL * scale
    else:
        assert st["iterations"] == int(sj["iterations"]) == FIXED
        assert abs(st["error"] - ej) <= STEP_RTOL * abs(ej)
        atol = STEP_RTOL * scale
    for a in range(3):
        np.testing.assert_allclose(vt[a], vj[a], rtol=0, atol=atol)
    # applies: BiCGStab 1 + 3 k, MINRES 2 + k; the fallback adds PCG's 1 + k
    want = {"bicgstab": 1 + 3 * st["iterations"] + 3, "minres": 2 + FIXED, "fallback": (1 + FIXED) + (1 + 3 * FIXED)}
    assert st["operator_applies"] == want[case]
