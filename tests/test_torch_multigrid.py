"""The port's MULTIGRID preconditioner (``polystokes_tpu_torch.multigrid``)
against the JAX package's on the CPU in fp64, with the JAX side run once
in a module-scoped fixture (the JAX tests' ``make_case``: a 14 x 12 x 18
liquid box on a solid floor, the uniform step; the JAX tests' cheap
settings: 2 levels, Chebyshev degree 2, 2 coarse sweeps):

* the transfers: each 1-D restriction and prolongation equal to JAX's
  on odd and even sizes, and R = (1/2) P^T (adjoint) on both lattices;
* the coarsened level fields equal to JAX's; lambda_max of every level
  within LAM_RTOL relative (JAX's ``_estimate_lambda_max``, the hash
  noise seed included); one V-cycle on the same r within VCYCLE_RTOL of
  max; the V-cycle symmetric;
* with regions (the box tiled at tile 6: two), the finest smoother is the
  CELL_ARROW solve, the reduced quadratic form folded in; the form itself
  is held to JAX's with the CELL_ARROW factors in the port's other files
  (JAX takes 24 s to compile the regions' V-cycle on a CPU);
* a MULTIGRID step, converged at tol 1e-8, against JAX's converged step
  on the same system, velocities within STEP_RTOL of max |v|.  JAX's
  IDENTITY step is the reference there: the JAX MULTIGRID step alone
  takes 25-90 s to compile on a CPU, and its preconditioner is the
  V-cycle held above;
* ``SolverParams`` takes MULTIGRID, which runs unpacked, and the CLI's
  ``--precond multigrid``.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polystokes_tpu import multigrid as jmg
from polystokes_tpu import solver as jsolver
from polystokes_tpu import step as jstep
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.operators import PTau as JPTau

from polystokes_tpu_torch import PreconditionerType, SolverParams, convert, multigrid, run, solver, step
from polystokes_tpu_torch.operators import PTau
from polystokes_tpu_torch.precond import _diag_quadratic_form, make_cell_arrow, make_preconditioner

from test_operators import make_case

torch.set_num_threads(1)

CHEAP = dict(mg_levels=2, mg_smooth_degree=2, mg_coarse_iters=2)
LAM_RTOL = 1e-10
VCYCLE_RTOL = 1e-10
STEP_RTOL = 1e-6
STEP_TOL = 1e-8


def _levels_j(grid, asm, n):
    lv = [jmg.Level(res=grid.res, dt=asm.dt, clw_s=asm.clw_s, elw_s=asm.elw_s, ffw=asm.ffw, mc_inv=asm.mc_inv,
                    uinv_c=asm.uinv_c, uinv_e=asm.uinv_e)]
    for _ in range(n - 1):
        lv.append(jmg._coarsen_level(lv[-1]))
    return lv


def _levels_t(grid, asm, n):
    lv = [multigrid.Level(res=grid.res, dt=asm.dt, clw_s=asm.clw_s, elw_s=asm.elw_s, ffw=asm.ffw, mc_inv=asm.mc_inv,
                          uinv_c=asm.uinv_c, uinv_e=asm.uinv_e)]
    for _ in range(n - 1):
        lv.append(multigrid._coarsen_level(lv[-1]))
    return lv


def _level_fields(lvl):
    return [lvl.clw_s, *lvl.elw_s, *lvl.ffw, *lvl.mc_inv, lvl.uinv_c, *lvl.uinv_e]


@contextlib.contextmanager
def _recording(module):
    """Record the lambda_max of each level that ``module.make_multigrid``
    estimates (its ``_estimate_lambda_max``), finest first."""
    orig, lams = module._estimate_lambda_max, []

    def rec(*args, **kw):
        lams.append(orig(*args, **kw))
        return lams[-1]

    module._estimate_lambda_max = rec
    try:
        yield lams
    finally:
        module._estimate_lambda_max = orig


@pytest.fixture(scope="module")
def ref():
    """JAX's levels, lambda_max per level and one V-cycle after its setup,
    in one jitted call; the random r it was applied to."""
    grid, jp, scene = make_case(reduced=True, solid=True)
    jp = jp.replace(preconditioner=JPC.MULTIGRID, tolerance=STEP_TOL, max_iterations=2000, bicgstab_fallback=False,
                    do_reduced_regions=False, **CHEAP)
    rng = np.random.default_rng(3)
    shapes = [grid.center_shape] * 4 + [grid.edge_shape(e) for e in range(3)]
    r_np = [rng.standard_normal(s) for s in shapes]

    def run_jax(scene, r):
        cls, asm = jsolver._setup(grid, scene, jp)
        with _recording(jmg) as lams:
            z = jmg.make_multigrid(grid, cls, asm, jp)(r)
        return [_level_fields(lv) for lv in _levels_j(grid, asm, 2)], lams, z

    r = JPTau(p=jnp.asarray(r_np[0]), tc=tuple(jnp.asarray(x) for x in r_np[1:4]),
              te=tuple(jnp.asarray(x) for x in r_np[4:]))
    fields, lams, z = jax.jit(run_jax)(scene, r)
    return {"grid": grid, "scene": scene, "params": jp, "r": r_np, "fields": fields, "lams": lams, "z": z}


@pytest.fixture(scope="module")
def port(ref):
    grid, scene = convert.grid_from_jax(ref["grid"]), convert.scene_from_numpy(ref["scene"], "cpu")
    params = convert.params_from_jax(ref["params"])
    cls, asm = solver._setup(grid, scene, params)
    r = PTau(p=torch.from_numpy(ref["r"][0]), tc=tuple(torch.from_numpy(x) for x in ref["r"][1:4]),
             te=tuple(torch.from_numpy(x) for x in ref["r"][4:]))
    return grid, scene, params, cls, asm, r


_SIZES = [5, 6, 7, 8]


@pytest.mark.parametrize("n", _SIZES)
def test_transfers_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3, 4))
    nc = -(-n // 2)
    pairs = [
        (jmg._cell_restrict_axis(jnp.asarray(x), 0), multigrid._cell_restrict_axis(torch.from_numpy(x), 0)),
        (jmg._cell_prolong_axis(jnp.asarray(x), 0, 2 * n - 1), multigrid._cell_prolong_axis(torch.from_numpy(x), 0, 2 * n - 1)),
        (jmg._node_restrict_axis(jnp.asarray(x), 0, nc + 1), multigrid._node_restrict_axis(torch.from_numpy(x), 0, nc + 1)),
        (jmg._node_prolong_axis(jnp.asarray(x), 0, 2 * n - 1), multigrid._node_prolong_axis(torch.from_numpy(x), 0, 2 * n - 1)),
    ]
    for want, got in pairs:
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)


def test_transfers_are_adjoint():
    """R = (1/2) P^T per axis on both lattices: <R x, y>_c = (1/2) <x, P y>_f."""
    rng = np.random.default_rng(0)
    n = 10
    x = torch.from_numpy(rng.standard_normal((n, 4, 4)))
    yc = torch.from_numpy(rng.standard_normal((5, 4, 4)))
    lhs = float((multigrid._cell_restrict_axis(x, 0) * yc).sum())
    rhs = 0.5 * float((x * multigrid._cell_prolong_axis(yc, 0, n)).sum())
    assert abs(lhs - rhs) < 1e-12
    xn = torch.from_numpy(rng.standard_normal((n + 1, 4, 4)))
    ycn = torch.from_numpy(rng.standard_normal((6, 4, 4)))
    lhs = float((multigrid._node_restrict_axis(xn, 0, 6) * ycn).sum())
    rhs = 0.5 * float((xn * multigrid._node_prolong_axis(ycn, 0, n + 1)).sum())
    assert abs(lhs - rhs) < 1e-12


def test_levels_match_jax(ref, port):
    grid, _, _, _, asm, _ = port
    levels = _levels_t(grid, asm, 2)
    assert levels[1].res == (7, 6, 9)
    for want, lvl in zip(ref["fields"], levels):
        for w, g in zip(want, _level_fields(lvl)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-13 * max(float(np.abs(w).max()), 1.0))


def test_lambda_max_matches_jax(ref, port):
    grid, _, params, cls, asm, r = port
    with _recording(multigrid) as lams:
        multigrid.make_multigrid(grid, cls, asm, params)
    assert len(lams) == len(ref["lams"]) == 2
    for got, want in zip(lams, ref["lams"]):
        assert got.dim() == 0 and got.dtype == torch.float64  # a device tensor, no host read
        assert abs(float(got) - float(want)) <= LAM_RTOL * float(want)
        assert float(want) > 1.0  # the arrow blocks leave rho(M^-1 A) above 1


def test_vcycle_matches_jax(ref, port):
    grid, _, params, cls, asm, r = port
    z = multigrid.make_multigrid(grid, cls, asm, params)(r)
    want = [ref["z"].p, *ref["z"].tc, *ref["z"].te]
    scale = max(float(jnp.abs(w).max()) for w in want)
    for w, g in zip(want, z.fields()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=VCYCLE_RTOL * scale)


def test_finest_smoother_is_cell_arrow(ref, port):
    """With regions the finest level's arrow smoother carries the reduced
    quadratic form, as the CELL_ARROW preconditioner does."""
    grid, scene, params, _, _, r = port
    params = params.replace(do_reduced_regions=True)
    cls, asm = solver._setup(grid, scene, params)
    assert int(cls.n_regions) == 2
    q = [_diag_quadratic_form(grid, cls, asm, params, a) for a in range(3)]
    assert max(float(t.abs().max()) for t in q) > 0.0
    fine = _levels_t(grid, asm, 1)[0]
    got = multigrid._level_arrow(fine, q)(r)
    want = make_cell_arrow(grid, cls, asm, params)(r)
    for g, w in zip(got.fields(), want.fields()):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12 * float(w.abs().max()))


def test_vcycle_is_symmetric(port):
    grid, _, params, cls, asm, r = port
    solve = make_preconditioner(grid, cls, asm, params)
    rng = np.random.default_rng(9)
    f = [torch.from_numpy(rng.standard_normal(tuple(t.shape))) for t in r.fields()]
    s = PTau(p=f[0], tc=tuple(f[1:4]), te=tuple(f[4:]))
    lhs, rhs = float(multigrid._dot(r, solve(s))), float(multigrid._dot(s, solve(r)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_multigrid_step_matches_jax(ref):
    grid, scene = ref["grid"], ref["scene"]
    jp = ref["params"].replace(preconditioner=JPC.IDENTITY)
    vj, _, sj = jstep(grid, scene, jp)
    params = convert.params_from_jax(jp).replace(preconditioner=PreconditionerType.MULTIGRID)
    vt, _, st = step(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), params)
    assert st["converged"] and bool(sj["converged"])
    assert st["iterations"] < int(sj["iterations"])  # the V-cycle cuts IDENTITY's count
    vmax = max(float(jnp.abs(v).max()) for v in vj)
    for a in range(3):
        np.testing.assert_allclose(vt[a].numpy(), np.asarray(vj[a]), rtol=0, atol=STEP_RTOL * vmax)


def test_multigrid_params_and_layout():
    p = SolverParams(preconditioner=PreconditionerType.MULTIGRID, use_pallas=True)
    from polystokes_tpu_torch.grid import Grid

    assert not solver._use_packed(Grid(res=(32, 32, 32), dx=1 / 32), p)  # MULTIGRID runs unpacked, as in JAX


def test_cli_precond_multigrid(capsys):
    run.main(["--scene", "viscous_beam", "--n", "8", "--tile-size", "4", "--no-tile", "--fp64", "--precond",
              "multigrid", "--tolerance", "1e-5", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 1 and "converged=True" in lines[0]
