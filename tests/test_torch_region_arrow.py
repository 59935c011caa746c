"""REGION_ARROW on the packed path, and the three kernels this adds
(``transpose_u_packed``, ``forward_s_packed``, ``combine_packed``),
against the JAX package in fp64 on the CPU.

The kernel twins run against the Pallas kernels in interpret mode on the
cases of ``test_torch_packed_apply`` (honey_coil and the solid-cut floor
of ``_solid_case`` at 16^3, tile 8 and 16).  The Woodbury capacitance
inverse ``region_schur_inv`` and the packed REGION_ARROW solve run
against JAX's on honey_coil, the solid-cut floor and the liquid box of
``test_pallas_apply._make(True)`` taken untiled, and on honey_coil
assembled in the affine basis (11 probes, K = 4 kernels).  One JAX step, at a fixed budget of 20 iterations,
holds the port's REGION_ARROW step to JAX's; the converged step is held
to the port's own CELL_ARROW step, which solves the same system.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import sdf as jsdf
from polystokes_tpu import solver as jsolver
from polystokes_tpu import step as jstep
from polystokes_tpu.classify import classify as jclassify
from polystokes_tpu.classify import effective_max_regions as jR
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.deflation import packed_masks as jpacked_masks
from polystokes_tpu.scenes import builders as jbuilders
from polystokes_tpu.weights import compute_weights as jweights

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch import step as tstep
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.precond import _arrow_solve_from, cell_arrow_factors, region_schur_inv
from polystokes_tpu_torch.scenes.builders import honey_coil

from test_operators import make_case
from test_torch_packed_apply import _get, _rel, affine_setup

torch.set_num_threads(1)

KERNEL_RTOL = 1e-12  # fp64; the twins and the Pallas kernels sum in the same order
SINV_RTOL = 1e-10  # fp64; 26 probes and a Cholesky inverse of a 26 x 26 matrix per region
SOLVE_RTOL = 1e-10
SYM_RTOL = 1e-8
BUDGET = 20
BUDGET_VEL_RTOL = 1e-10
CONVERGED_VEL_RTOL = 1e-3  # two tol-1e-3 solutions of one system
RA = dict(preconditioner=JPC.REGION_ARROW)

CASES = [("honey_coil", 8), ("honey_coil", 16), ("solid", 8), ("solid", 16)]
CASE_IDS = ["honey_coil-T8", "honey_coil-T16", "solid-T8", "solid-T16"]


@pytest.fixture(params=CASES, ids=CASE_IDS)
def case(request):
    return _get(request.param)


def _inputs(case):
    """(x, coeffs, s, u) as torch tensors; s random on every face."""
    s = np.random.default_rng(11).standard_normal((3,) + case["grid"].res)
    return (torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]), torch.from_numpy(s),
            torch.from_numpy(case["u"]))


# ---------------------------------------------------------------------------
# (a) the twins against the Pallas kernels; (b) combine after forward_s
# ---------------------------------------------------------------------------

def test_transpose_u_twin_matches_pallas(case):
    ref = jpa.transpose_u_packed(case["coeffs_padded"], jnp.asarray(case["u"]), case["grid"].res)
    got = tpa.transpose_u_packed(torch.from_numpy(case["coeffs"]), torch.from_numpy(case["u"]))
    assert _rel(got, ref) <= KERNEL_RTOL


def test_forward_s_twin_matches_pallas(case):
    ref = jpa.forward_s_packed(jnp.asarray(case["x"]), case["coeffs_padded"], case["grid"].res)
    got = tpa.forward_s_packed(torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]))
    assert _rel(got, ref) <= KERNEL_RTOL


def test_combine_twin_matches_pallas(case):
    x, c, s, u = _inputs(case)
    ref = jpa.combine_packed(jnp.asarray(case["x"]), case["coeffs_padded"], jnp.asarray(s.numpy()),
                             jnp.asarray(case["u"]), case["grid"].res)
    assert _rel(tpa.combine_packed(x, c, s, u), ref) <= KERNEL_RTOL


def test_combine_of_forward_s_is_the_reduced_apply(case):
    """combine(x, forward_s(x), u) == apply_reduced(x, u): the mass terms
    once, the signs of s and u as in the fused kernel."""
    x, c, _, u = _inputs(case)
    assert _rel(tpa.combine_packed(x, c, tpa.forward_s_packed(x, c), u), tpa.apply_reduced_packed(x, c, u)) <= 1e-14


def test_transpose_u_is_finish_of_minus_u(case):
    """transpose_u(u) == finish(0, -u): the same transpose, the opposite sign."""
    _, c, _, u = _inputs(case)
    zero = torch.zeros((7,) + tuple(u.shape[1:]), dtype=u.dtype)
    assert torch.equal(tpa.transpose_u_packed(c, u), tpa.finish_packed(c, zero, -u))


def test_new_wrappers_count_no_launches_on_the_cpu(case):
    before = dict(tpa.LAUNCHES)
    x, c, s, u = _inputs(case)
    tpa.transpose_u_packed(c, u)
    tpa.forward_s_packed(x, c)
    tpa.combine_packed(x, c, s, u)
    assert tpa.LAUNCHES == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "channels"])
def test_new_wrappers_reject_bad_inputs(bad):
    c = torch.zeros((tpa.N_COEFF, 8, 8, 8), dtype=torch.float64)
    u = torch.zeros((3, 8, 8, 8), dtype=torch.float64)
    if bad == "shape":
        u = torch.zeros((3, 8, 8, 4), dtype=torch.float64)
    elif bad == "dtype":
        u = u.to(torch.float32)
    else:
        c = c[:7].contiguous()  # a stack without the dt McInv and uInv channels
    with pytest.raises((ValueError, TypeError)):
        tpa.transpose_u_packed(c, u)


# ---------------------------------------------------------------------------
# (c) the capacitance inverse; (d) the packed REGION_ARROW solve
# ---------------------------------------------------------------------------

def _build_box():
    """The liquid box of test_pallas_apply._make(True) (make_case at 16^3,
    tile 8, liquid in [0.12, 0.88]^3), untiled, fp64."""
    grid, params, scene = make_case(res=(16, 16, 16), tile=8, reduced=True, solid=False)
    params = params.replace(dtype=jnp.float64, do_tile=False, tile_padding=2, max_regions=64, use_pallas=True,
                            fuse_pap=False, preconditioner=JPC.CELL_ARROW, bicgstab_fallback=False)
    inner = jsdf.box((0.12, 0.12, 0.12), (0.88, 0.88, 0.88))
    scene = dataclasses.replace(scene, surface_sdf=jsdf.sample_at_centers(inner, grid.res, grid.dx, params.dtype))
    R = jR(grid, params)
    lw, fw = jweights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
    cls = jclassify(grid, lw, fw, params)
    asm, _ = jsolver.assemble(grid, scene, cls, lw, fw, params, R)
    tgrid, tparams = convert.grid_from_jax(grid), convert.params_from_jax(params)
    tcls, tasm = tsolver._setup(tgrid, convert.scene_from_numpy(scene, "cpu"), tparams)
    mask = np.asarray(jpacked_masks(grid, cls, jnp.float64))
    rng = np.random.default_rng(7)
    return dict(grid=grid, params=params, cls=cls, asm=asm, R=R, tgrid=tgrid, tparams=tparams, tcls=tcls, tasm=tasm,
                x=rng.standard_normal((7,) + grid.res) * mask, y=rng.standard_normal((7,) + grid.res) * mask)


_BOX = {}


def _region_case(key):
    if key == "box":
        if not _BOX:
            _BOX.update(_build_box())
        return _BOX
    if key == "affine":  # honey_coil T8 assembled in the affine basis: D = 11, K = 4
        aff = affine_setup(("honey_coil", 8))
        return {**_get(("honey_coil", 8)), "params": aff["jparams"], "asm": aff["jasm"], "tparams": aff["tparams"],
                "tasm": aff["tasm"]}
    return _get(key)


REGION_CASES = [("honey_coil", 8), ("solid", 8), "box", "affine"]
REGION_IDS = ["honey_coil-T8", "solid-T8", "box-T8", "honey_coil-T8-AFFINE"]
_REGION = {}


def _region_setup(key):
    """JAX's and the port's REGION_ARROW factors (``sinv`` among them,
    from each package's ``region_schur_inv``) and packed solves on one case."""
    if key not in _REGION:
        c = _region_case(key)
        jp = c["params"].replace(**RA)
        jfac = jsolver.precond_factors_packed(c["grid"], c["cls"], c["asm"], jp)
        tp = c["tparams"].replace(preconditioner=PreconditionerType.REGION_ARROW)
        tfac = tsolver.precond_factors_packed(c["tgrid"], c["tcls"], c["tasm"], tp)
        _REGION[key] = dict(
            case=c, tparams=tp, jfac=jfac, tfac=tfac,
            jsolve=jsolver.make_preconditioner_packed(c["grid"], c["cls"], c["asm"], jp, jfac),
            tsolve=tsolver.make_preconditioner_packed(c["tgrid"], c["tcls"], c["tasm"], tp, tfac),
        )
    return _REGION[key]


@pytest.mark.parametrize("key", REGION_CASES, ids=REGION_IDS)
def test_region_schur_inv_matches_jax(key):
    r = _region_setup(key)
    assert int(r["case"]["tcls"].n_regions) >= 1
    assert _rel(r["tfac"]["sinv"], r["jfac"]["sinv"]) <= SINV_RTOL


def test_region_schur_inv_is_the_precond_factor():
    """precond_factors_packed's sinv is region_schur_inv over the arrow
    block without the reduced quadratic form."""
    r = _region_setup(("honey_coil", 8))
    c, tp = r["case"], r["tparams"]
    fac = cell_arrow_factors(c["tgrid"], c["tcls"], c["tasm"], tp, include_reduced_q=False)
    sinv = region_schur_inv(c["tgrid"], c["tcls"], c["tasm"], tp, c["R"], _arrow_solve_from(*fac))
    assert torch.equal(sinv, r["tfac"]["sinv"])


@pytest.mark.parametrize("key", REGION_CASES, ids=REGION_IDS)
def test_region_arrow_solve_matches_jax_and_is_symmetric(key):
    r = _region_setup(key)
    c, tsolve = r["case"], r["tsolve"]
    x, y = torch.from_numpy(c["x"]), torch.from_numpy(c["y"])
    mx = tsolve(x)
    assert _rel(mx, r["jsolve"](jnp.asarray(c["x"]))) <= SOLVE_RTOL
    y_mx, my_x = float(torch.sum(y * mx)), float(torch.sum(tsolve(y) * x))
    assert abs(y_mx - my_x) <= SYM_RTOL * abs(y_mx)


@pytest.mark.parametrize("key", REGION_CASES, ids=REGION_IDS)
def test_region_correction_is_not_zero(key):
    """The Woodbury correction changes the arrow solve, so the comparisons
    above see the correction leg's kernels at work."""
    r = _region_setup(key)
    c, tp, factors = r["case"], r["tparams"], r["tfac"]
    x = torch.from_numpy(c["x"])
    arrow = tsolver.make_preconditioner_packed(c["tgrid"], c["tcls"], c["tasm"], tp,
                                               {k: v for k, v in factors.items() if k != "sinv"})(x)
    assert float((r["tsolve"](x) - arrow).abs().max()) > 1e-9 * float(arrow.abs().max())


# ---------------------------------------------------------------------------
# (e)-(g) the step
# ---------------------------------------------------------------------------

def _honey_params(**kw):
    return JParams(dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64,
                   tolerance=1e-3, bicgstab_fallback=False, use_pallas=True, keep_non_converged=True, fuse_pap=True,
                   **kw)


_BUDGET = {}


def _budget_run():
    """JAX's and the port's REGION_ARROW step, 20 iterations, honey_coil 16^3."""
    if not _BUDGET:
        grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
        params = _honey_params(max_iterations=BUDGET, **RA)
        vj, _, sj = jstep(grid, scene, params)
        vt, _, st = tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"),
                          convert.params_from_jax(params))
        _BUDGET.update(vj=[np.asarray(v) for v in vj], sj=sj, vt=[v.numpy() for v in vt], st=st)
    return _BUDGET


def test_fixed_budget_matches_jax():
    r = _budget_run()
    assert int(r["sj"]["iterations"]) == r["st"]["iterations"] == BUDGET
    assert not bool(r["sj"]["converged"]) and not r["st"]["converged"]
    scale = max(float(np.max(np.abs(v))) for v in r["vj"])
    assert max(float(np.max(np.abs(a - b))) for a, b in zip(r["vt"], r["vj"])) <= BUDGET_VEL_RTOL * scale


def test_fixed_budget_counts_applies():
    """One apply in pcg_init plus one fused apply per loop pass."""
    assert _budget_run()["st"]["operator_applies"] == BUDGET + 1


_PORT = {}


def _port_step(preconditioner, reduced=True):
    key = (preconditioner, reduced)
    if key not in _PORT:
        grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
        params = SolverParams(do_tile=False, dtype=torch.float64, tile_size=8, max_regions=64, tolerance=1e-3, max_iterations=2000,
                              preconditioner=preconditioner, do_reduced_regions=reduced,
                              bicgstab_fallback=False, use_pallas=True)
        _PORT[key] = tstep(grid, scene, params)
    return _PORT[key]


def test_converged_region_arrow_meets_tolerance():
    _, _, st = _port_step(PreconditionerType.REGION_ARROW)
    assert st["converged"] and st["boundary_active"] == 0 and st["n_regions"] >= 1
    assert st["error"] < 1e-3


def test_converged_region_arrow_agrees_with_cell_arrow():
    v_ra, _, st_ra = _port_step(PreconditionerType.REGION_ARROW)
    v_ca, _, st_ca = _port_step(PreconditionerType.CELL_ARROW)
    print(f"iterations: REGION_ARROW {st_ra['iterations']}, CELL_ARROW {st_ca['iterations']}")
    scale = max(float(v.abs().max()) for v in v_ca)
    assert max(float((a - b).abs().max()) for a, b in zip(v_ra, v_ca)) <= CONVERGED_VEL_RTOL * scale


def test_uniform_region_arrow_is_cell_arrow():
    """Without regions REGION_ARROW is the plain arrow solve, as in JAX."""
    v_ra, _, st_ra = _port_step(PreconditionerType.REGION_ARROW, reduced=False)
    v_ca, _, st_ca = _port_step(PreconditionerType.CELL_ARROW, reduced=False)
    assert st_ra["iterations"] == st_ca["iterations"]
    assert all(torch.equal(a, b) for a, b in zip(v_ra, v_ca))


# ---------------------------------------------------------------------------
# (h) the options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MULTIGRID"])
def test_other_preconditioners_still_raise(name):
    """MULTIGRID is ported, and so is deflation on top of it (item 15):
    both construct, as in JAX."""
    assert SolverParams(preconditioner=PreconditionerType[name]).preconditioner == PreconditionerType[name]
    p = SolverParams(preconditioner=PreconditionerType[name], deflation=True)
    assert p.preconditioner == PreconditionerType[name] and p.deflation


def test_params_from_jax_carries_region_arrow():
    assert convert.params_from_jax(_honey_params(**RA)).preconditioner == PreconditionerType.REGION_ARROW
