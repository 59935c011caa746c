"""The fused CG update of ``fuse_update`` (``cg_update_packed``,
``finish_update_packed``, ``exp_finish_update_packed``) and the packed
DIAGONAL factors it takes, against the JAX package in fp64 on the CPU.

The twins run against the Pallas kernels in interpret mode, for every
preconditioner kind, on the cases of ``test_torch_packed_apply``
(honey_coil and the solid-cut floor of ``_solid_case`` at 16^3, tile 8 and
16).  Both sides take the same numpy inputs, and the factor stacks that
JAX builds for CELL_ARROW and DIAGONAL on that case.  The port's own
factor stacks are held to JAX's apart.  ``exp_finish_update`` also runs
at ``basis=AFFINE`` (K = 4) at tile 8, kinds none and arrow.  The steps
are in ``test_torch_fused_update_step.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import precond as jprecond
from polystokes_tpu import solver as jsolver
from polystokes_tpu.config import BasisOrder as JB
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.deflation import packed_masks as jpacked_masks

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import precond as tprecond
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import BasisOrder as TB
from polystokes_tpu_torch.config import PreconditionerType

from test_torch_packed_apply import BASIS_CASES, BASIS_IDS, _get, _rel, basis_v

torch.set_num_threads(1)

KERNEL_RTOL = 1e-12  # fp64; the twins and the Pallas kernels differ only in the order of the sums
FACTOR_RTOL = 1e-10  # fp64; the factors inherit BInv, Cholesky (port) against LU (JAX), test_torch_setup
KINDS = ["none", "diag", "arrow"]
ALPHA = 0.37

CASES = [("honey_coil", 8), ("honey_coil", 16), ("solid", 8), ("solid", 16)]
CASE_IDS = ["honey_coil-T8", "honey_coil-T16", "solid-T8", "solid-T16"]


@pytest.fixture(params=CASES, ids=CASE_IDS)
def case(request):
    return _get(request.param)


_INPUTS = {}


def _inputs(case):
    """numpy inputs of the update kernels on one case: r, p and a stored Ap
    on the DOFs, a random out_grid, and JAX's factor stack of each kind."""
    key = id(case)
    if key not in _INPUTS:
        rng = np.random.default_rng(13)
        mask = np.asarray(jpacked_masks(case["grid"], case["cls"], jnp.float64))
        shape = (7,) + case["grid"].res
        fac = {"none": None}
        params = case["params"]
        jfac = jsolver.precond_factors_packed(case["grid"], case["cls"], case["asm"],
                                              params.replace(preconditioner=JPC.CELL_ARROW))
        fac["arrow"] = np.array(jpa.pack_arrow_factors(jfac))
        jfac = jsolver.precond_factors_packed(case["grid"], case["cls"], case["asm"],
                                              params.replace(preconditioner=JPC.DIAGONAL))
        fac["diag"] = np.array(jfac["inv_packed"])
        _INPUTS[key] = dict(r=rng.standard_normal(shape) * mask, p=case["y"], ap=rng.standard_normal(shape) * mask,
                            og=rng.standard_normal(shape) * mask, fac=fac)
    return _INPUTS[key]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _check(got, ref):
    """x', r', z within KERNEL_RTOL of max; the three sums relative."""
    assert len(got) == len(ref) == 6
    for name, g, r in zip(("x", "r", "z"), got[:3], ref[:3]):
        assert _rel(g, r) <= KERNEL_RTOL, name
    for name, g, r in zip(("rr", "xx", "rz"), got[3:], ref[3:]):
        assert g.shape == ()
        assert abs(float(g) - float(r)) <= KERNEL_RTOL * abs(float(r)), name


# ---------------------------------------------------------------------------
# (a) each twin against its Pallas kernel, for every kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_cg_update_twin_matches_pallas(case, kind):
    i = _inputs(case)
    f = i["fac"][kind]
    ref = jpa.cg_update_packed(_j(case["x"]), _j(i["r"]), _j(i["p"]), _j(i["ap"]), jnp.asarray(ALPHA), factors=_j(f),
                               kind=kind)
    got = tpa.cg_update_packed(_t(case["x"]), _t(i["r"]), _t(i["p"]), _t(i["ap"]), torch.tensor(ALPHA, dtype=torch.float64),
                               factors=_t(f), kind=kind)
    _check(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_finish_update_twin_matches_pallas(case, kind):
    i = _inputs(case)
    f = i["fac"][kind]
    ref = jpa.finish_update_packed(_j(case["x"]), _j(i["r"]), _j(i["p"]), jnp.asarray(ALPHA), case["coeffs_padded"],
                                   _j(i["og"]), _j(case["u"]), factors=_j(f), kind=kind)
    got = tpa.finish_update_packed(_t(case["x"]), _t(i["r"]), _t(i["p"]), torch.tensor(ALPHA, dtype=torch.float64),
                                   _t(case["coeffs"]), _t(i["og"]), _t(case["u"]), factors=_t(f), kind=kind)
    _check(got, ref)


# every kind in the quadratic basis; the affine basis (tile 8) with kinds
# none and arrow
EXP_CASES = [(key, basis, kind) for (key, basis), bid in zip(BASIS_CASES, BASIS_IDS) for kind in KINDS
             if basis == "QUADRATIC" or kind != "diag"]
EXP_IDS = [f"{bid}-{kind}" for (key, basis), bid in zip(BASIS_CASES, BASIS_IDS) for kind in KINDS
           if basis == "QUADRATIC" or kind != "diag"]


@pytest.mark.parametrize("key, basis, kind", EXP_CASES, ids=EXP_IDS)
def test_exp_finish_update_twin_matches_pallas(key, basis, kind):
    case = _get(key)
    T = case["params"].tile_size
    assert jpa.exp_finish_supported(case["grid"].res, T)  # JAX takes kernel 11 here too
    i = _inputs(case)
    f = i["fac"][kind]
    v = basis_v(case, basis)
    ref = jpa.exp_finish_update_packed(_j(case["x"]), _j(i["r"]), _j(i["p"]), jnp.asarray(ALPHA), case["coeffs_padded"],
                                       _j(i["og"]), _j(v), case["grid"].res, T, JB[basis], factors=_j(f), kind=kind)
    got = tpa.exp_finish_update_packed(_t(case["x"]), _t(i["r"]), _t(i["p"]), torch.tensor(ALPHA, dtype=torch.float64),
                                       _t(case["coeffs"]), _t(i["og"]), _t(v), T, factors=_t(f), kind=kind,
                                       basis=TB[basis])
    _check(got, ref)


@pytest.mark.parametrize("kind", ["none", "arrow"])
def test_exp_finish_update_is_finish_update_of_the_expand(case, kind):
    """The in-place expand equals finish_update fed expand_packed's u; on
    the T8 cases the transpose's neighbours cross cube faces."""
    i = _inputs(case)
    T = case["params"].tile_size
    args = (_t(case["x"]), _t(i["r"]), _t(i["p"]), torch.tensor(ALPHA, dtype=torch.float64), _t(case["coeffs"]),
            _t(i["og"]))
    got = tpa.exp_finish_update_packed(*args, _t(case["v"]), T, factors=_t(i["fac"][kind]), kind=kind)
    up = tpa.expand_packed(_t(case["v"]), _t(case["red"]), T)
    ref = tpa.finish_update_packed(*args, up, factors=_t(i["fac"][kind]), kind=kind)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-14


def test_update_is_the_unfused_loop_body(case):
    """cg_update == the axpys, the port's packed arrow solve and the dots."""
    i = _inputs(case)
    x, r, p, ap = (_t(a) for a in (case["x"], i["r"], i["p"], i["ap"]))
    tparams = case["tparams"].replace(preconditioner=PreconditionerType.CELL_ARROW)
    factors = tsolver.precond_factors_packed(case["tgrid"], case["tcls"], case["tasm"], tparams)
    precond = tsolver.make_preconditioner_packed(case["tgrid"], case["tcls"], case["tasm"], tparams, factors)
    alpha = torch.tensor(ALPHA, dtype=torch.float64)
    got = tpa.cg_update_packed(x, r, p, ap, alpha, factors=tpa.pack_arrow_factors(factors), kind="arrow")
    x1, r1 = x + alpha * p, r - alpha * ap
    z1 = precond(r1)
    assert torch.equal(got[0], x1) and torch.equal(got[1], r1) and torch.equal(got[2], z1)
    for g, ref in zip(got[3:], (torch.sum(r1 * r1), torch.sum(x1 * x1), torch.sum(r1 * z1))):
        assert torch.equal(g, ref)


# ---------------------------------------------------------------------------
# (b) the factor stacks the kernels take, against JAX's
# ---------------------------------------------------------------------------

def _jparams(case, pc):
    return case["params"].replace(preconditioner=pc)


def _tparams(case, pc):
    return case["tparams"].replace(preconditioner=pc)


def test_pack_arrow_factors_matches_jax(case):
    jfac = jsolver.precond_factors_packed(case["grid"], case["cls"], case["asm"], _jparams(case, JPC.CELL_ARROW))
    tfac = tsolver.precond_factors_packed(case["tgrid"], case["tcls"], case["tasm"],
                                          _tparams(case, PreconditionerType.CELL_ARROW))
    got = tpa.pack_arrow_factors(tfac)
    assert got.shape == (tpa.N_ARROW,) + case["grid"].res and got.is_contiguous()
    assert _rel(got, jpa.pack_arrow_factors(jfac)) <= FACTOR_RTOL


def test_schur_diagonal_and_inv_packed_match_jax(case):
    jd = jprecond.schur_diagonal(case["grid"], case["cls"], case["asm"], _jparams(case, JPC.DIAGONAL))
    td = tprecond.schur_diagonal(case["tgrid"], case["tcls"], case["tasm"], _tparams(case, PreconditionerType.DIAGONAL))
    for a, b in zip([td.p, *td.tc, *td.te], [jd.p, *jd.tc, *jd.te]):
        assert _rel(a, b) <= FACTOR_RTOL
    jfac = jsolver.precond_factors_packed(case["grid"], case["cls"], case["asm"], _jparams(case, JPC.DIAGONAL))
    tfac = tsolver.precond_factors_packed(case["tgrid"], case["tcls"], case["tasm"],
                                          _tparams(case, PreconditionerType.DIAGONAL))
    assert _rel(tfac["inv_packed"], jfac["inv_packed"]) <= FACTOR_RTOL


def test_identity_has_no_factors_and_no_preconditioner(case):
    p = _tparams(case, PreconditionerType.IDENTITY)
    args = (case["tgrid"], case["tcls"], case["tasm"], p)
    assert tsolver.precond_factors_packed(*args) is None
    assert tsolver.make_preconditioner_packed(*args) is None


# ---------------------------------------------------------------------------
# (c) the path selection mirrors JAX's make_fused_update / _defer_finish
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pc", ["CELL_ARROW", "DIAGONAL", "IDENTITY", "REGION_ARROW"])
@pytest.mark.parametrize("fuse_update", [True, False])
@pytest.mark.parametrize("reduced", [True, False])
def test_path_selection_mirrors_jax(pc, fuse_update, reduced):
    case = _get(("honey_coil", 8))
    jp = case["params"].replace(preconditioner=JPC[pc], fuse_update=fuse_update, do_reduced_regions=reduced)
    tp = case["tparams"].replace(preconditioner=PreconditionerType[pc], fuse_update=fuse_update,
                                 do_reduced_regions=reduced)
    jfac = None if pc in ("IDENTITY", "REGION_ARROW") else jsolver.precond_factors_packed(
        case["grid"], case["cls"], case["asm"], jp)
    tfac = None if pc in ("IDENTITY", "REGION_ARROW") else tsolver.precond_factors_packed(
        case["tgrid"], case["tcls"], case["tasm"], tp)
    jfu = jsolver.make_fused_update(case["grid"], jp, jfac, cls=case["cls"], asm=case["asm"])
    tfu = tsolver.make_fused_update(tp, tfac, case["tcls"], case["tasm"])
    assert (tfu is None) == (jfu is None)
    assert (tfu is not None) == (fuse_update and pc != "REGION_ARROW")
    assert tsolver._defer_finish(tp, tfu) == jsolver._defer_finish(case["grid"], jp, jfu)
    assert tsolver._fuse_expand_ok(tp) == jsolver._fuse_expand_ok(case["grid"], jp)


@pytest.mark.parametrize("fuse_expand", [True, False])
def test_deferred_apply_returns_the_pair_its_update_takes(fuse_expand):
    """defer_finish: (out_grid, v) under fuse_expand, else (out_grid, u);
    the update finishes either into the A x of the undeferred apply."""
    case = _get(("solid", 8))
    tp = case["tparams"].replace(fuse_update=True, fuse_expand=fuse_expand, fuse_pap=True)
    args = (case["tgrid"], case["tcls"], case["tasm"], tp, case["R"])
    x = torch.from_numpy(case["x"])
    (og, tail), pap = tsolver.make_apply_packed_pap(*args, defer_finish=True)(x)
    ax, pap_ref = tsolver.make_apply_packed_pap(*args)(x)
    assert torch.equal(pap, pap_ref)
    assert tuple(tail.shape) == (tuple(case["v"].shape) if fuse_expand else (3,) + case["grid"].res)
    tfac = tsolver.precond_factors_packed(case["tgrid"], case["tcls"], case["tasm"], tp)
    fused = tsolver.make_fused_update(tp, tfac, case["tcls"], case["tasm"])
    zero = torch.zeros_like(x)
    # x' = 0 + 1 * 0, r' = 0 - 1 * Ap: r' is -A x
    _, r1, *_ = fused(zero, zero, zero, (og, tail), torch.tensor(1.0, dtype=torch.float64))
    assert _rel(-r1, ax) <= 1e-14


# ---------------------------------------------------------------------------
# (d) the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_update_wrappers_count_no_launches_on_the_cpu(case):
    i = _inputs(case)
    before = dict(tpa.LAUNCHES)
    T = case["params"].tile_size
    x, r, p = _t(case["x"]), _t(i["r"]), _t(i["p"])
    f = _t(i["fac"]["arrow"])
    tpa.cg_update_packed(x, r, p, _t(i["ap"]), ALPHA, factors=f, kind="arrow")
    tpa.finish_update_packed(x, r, p, ALPHA, _t(case["coeffs"]), _t(i["og"]), _t(case["u"]), factors=f, kind="arrow")
    tpa.exp_finish_update_packed(x, r, p, ALPHA, _t(case["coeffs"]), _t(i["og"]), _t(case["v"]), T, factors=f,
                                 kind="arrow")
    assert tpa.LAUNCHES == before


def _bad_inputs(bad):
    z7 = torch.zeros((7, 8, 8, 8), dtype=torch.float64)
    x, r, p, ap = z7, z7.clone(), z7.clone(), z7.clone()
    kind, f = "diag", z7.clone()
    if bad == "shape":
        ap = torch.zeros((7, 8, 8, 4), dtype=torch.float64)
    elif bad == "dtype":
        r = r.to(torch.float32)
    elif bad == "channels":
        kind, f = "arrow", z7.clone()  # a diagonal stack given as arrow factors
    elif bad == "kind":
        kind = "multigrid"
    else:  # factors for kind none
        kind = "none"
    return x, r, p, ap, f, kind


@pytest.mark.parametrize("bad", ["shape", "dtype", "channels", "kind", "none_with_factors"])
def test_update_wrappers_reject_bad_inputs(bad):
    x, r, p, ap, f, kind = _bad_inputs(bad)
    with pytest.raises((ValueError, TypeError)):
        tpa.cg_update_packed(x, r, p, ap, ALPHA, factors=f, kind=kind)


@pytest.mark.parametrize("bad", ["coeff_channels", "v_shape"])
def test_exp_finish_update_rejects_bad_inputs(bad):
    z7 = torch.zeros((7, 16, 16, 16), dtype=torch.float64)
    c = torch.zeros((tpa.N_COEFF, 16, 16, 16), dtype=torch.float64)
    v = torch.zeros((2, 2, 30, 2), dtype=torch.float64)  # 3K rows, K = 10 in the default quadratic basis
    if bad == "coeff_channels":
        c = c[: tpa.N_COEFF_UNIFORM].contiguous()  # no reduced-face masks to expand on
    else:
        v = torch.zeros((2, 2, 30, 1), dtype=torch.float64)
    with pytest.raises(ValueError):
        tpa.exp_finish_update_packed(z7, z7, z7, ALPHA, c, z7, v, 8)
