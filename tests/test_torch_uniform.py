"""The uniform baseline (``do_reduced_regions=False``, Path B) of the port
against the JAX package, in fp64 on the CPU: labels, the 14-channel
coefficient stack, the CELL_ARROW factors, the twins of
``apply_uniform_packed`` and ``apply_uniform_pap_packed`` against the Pallas
kernels (interpret mode), the fused apply, and the step.

Cases: honey_coil 16^3 and the solid-cut floor of
``test_packed_solid_untiled._solid_case`` (the uniform apply does not
depend on the tile size).  The step levels are those of
``test_torch_fused_step``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import solver as jsolver
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
from polystokes_tpu_torch.classify import effective_max_regions

from test_packed_solid_untiled import _solid_case
from test_torch_fused_step import BUDGET, BUDGET_VEL_RTOL, CONVERGED_VEL_RTOL, max_vel_rel, run_both
from test_torch_packed_apply import _rel

torch.set_num_threads(1)

SLICE = dict(use_pallas=True, preconditioner=JPC.CELL_ARROW, bicgstab_fallback=False, do_reduced_regions=False)
KERNEL_RTOL = 1e-11  # fp64; only the order of the sums differs
PACK_RTOL = 1e-12
PRECOND_RTOL = 1e-10
SYM_RTOL = 1e-12


def _build(name):
    if name == "honey_coil":
        grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
        params = JParams(dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, **SLICE)
    else:
        grid, params, scene = _solid_case(do_tile=False, reduced=False)[:3]
        params = params.replace(**SLICE)
    R = jR(grid, params)
    lw, fw = jweights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
    cls = jclassify(grid, lw, fw, params)
    asm, _ = jsolver.assemble(grid, scene, cls, lw, fw, params, R)

    tgrid, tparams = convert.grid_from_jax(grid), convert.params_from_jax(params)
    tcls, tasm = tsolver._setup(tgrid, convert.scene_from_numpy(scene, "cpu"), tparams)
    rng = np.random.default_rng(11)
    mask = np.asarray(jpacked_masks(grid, cls, jnp.float64))
    return dict(grid=grid, params=params, cls=cls, asm=asm, R=R, tgrid=tgrid, tparams=tparams, tcls=tcls, tasm=tasm,
                x=rng.standard_normal((7,) + grid.res) * mask, y=rng.standard_normal((7,) + grid.res) * mask)


_CASES = {}


@pytest.fixture(params=["honey_coil", "solid"])
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = _build(request.param)
    return _CASES[request.param]


@pytest.mark.parametrize("field", ["cell_labels", "face_labels", "edge_labels", "cell_region", "face_region",
                                   "edge_region", "region_valid", "n_regions", "region_of_cube", "region_overflow"])
def test_uniform_classification_equal(case, field):
    a_j, a_t = getattr(case["cls"], field), getattr(case["tcls"], field)
    pairs = zip(a_t, a_j) if isinstance(a_j, (tuple, list)) else [(a_t, a_j)]
    for x_t, x_j in pairs:
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j), err_msg=field)


def test_uniform_regions_are_empty(case):
    assert effective_max_regions(case["tgrid"], case["tparams"]) == 1
    assert int(case["tcls"].n_regions) == 0
    assert case["tcls"].region_of_cube.tolist() == [-1]


def test_uniform_pack_coeffs(case):
    got = tpa.pack_coeffs(case["tasm"])
    assert got.shape[0] == tpa.N_COEFF_UNIFORM
    assert _rel(got, jpa.pack_coeffs(case["asm"], None, pad=False)) <= PACK_RTOL


def test_uniform_precond_factors(case):
    ref = jsolver.precond_factors_packed(case["grid"], case["cls"], case["asm"], case["params"])
    got = tsolver.precond_factors_packed(case["tgrid"], case["tcls"], case["tasm"], case["tparams"])
    for key in ("k", "inv_d", "kd", "inv_schur", "te_inv_s"):
        r, g = ref[key], got[key]
        pairs = zip(g, r) if isinstance(r, (tuple, list)) else [(g, r)]
        for x_t, x_j in pairs:
            assert _rel(x_t, x_j) <= PRECOND_RTOL, key


def test_apply_uniform_twin_matches_pallas(case):
    ref = jpa.apply_uniform_packed(jnp.asarray(case["x"]), jpa.pack_coeffs(case["asm"], None), case["grid"].res)
    got = tpa.apply_uniform_packed(torch.from_numpy(case["x"]), tpa.pack_coeffs(case["tasm"]))
    assert _rel(got, ref) <= KERNEL_RTOL


def test_apply_uniform_pap_twin_matches_pallas(case):
    """A x and the summed <x, A x> partials."""
    out_j, pap_j = jpa.apply_uniform_pap_packed(jnp.asarray(case["x"]), jpa.pack_coeffs(case["asm"], None),
                                                case["grid"].res)
    out_t, pap_t = tpa.apply_uniform_pap_packed(torch.from_numpy(case["x"]), tpa.pack_coeffs(case["tasm"]))
    assert _rel(out_t, out_j) <= KERNEL_RTOL
    assert abs(float(pap_t.sum()) - float(jnp.sum(pap_j))) <= KERNEL_RTOL * abs(float(jnp.sum(pap_j)))


def test_uniform_wrappers_take_both_stacks(case):
    """The 17-channel stack gives the same uniform apply (channels 14-16 unread)."""
    x, c14 = torch.from_numpy(case["x"]), tpa.pack_coeffs(case["tasm"])
    c17 = torch.cat([c14, torch.ones_like(c14[:3])], dim=0)
    assert torch.equal(tpa.apply_uniform_packed(x, c17), tpa.apply_uniform_packed(x, c14))
    with pytest.raises(ValueError):
        tpa.apply_uniform_packed(x, c14[:13].contiguous())


def test_make_apply_packed_pap_matches_jax(case):
    """(A x, <x, A x>) against JAX's, and against the unfused apply."""
    ap_j, pap_j = jsolver.make_apply_packed_pap(case["grid"], case["cls"], case["asm"], case["params"], case["R"])(
        jnp.asarray(case["x"]))
    args = (case["tgrid"], case["tcls"], case["tasm"], case["tparams"], case["R"])
    x = torch.from_numpy(case["x"])
    ap_t, pap_t = tsolver.make_apply_packed_pap(*args)(x)
    assert _rel(ap_t, ap_j) <= KERNEL_RTOL
    assert abs(float(pap_t) - float(pap_j)) <= KERNEL_RTOL * abs(float(pap_j))
    unfused = tsolver.make_apply_packed(*args)(x)
    assert torch.equal(ap_t, unfused)
    assert abs(float(pap_t) - float(torch.sum(x * unfused))) <= KERNEL_RTOL * abs(float(pap_t))


def test_uniform_apply_symmetric(case):
    apply_t = tsolver.make_apply_packed(case["tgrid"], case["tcls"], case["tasm"], case["tparams"], case["R"])
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    y_ax, ay_x = float(torch.sum(y * apply_t(x))), float(torch.sum(apply_t(y) * x))
    assert abs(y_ax - ay_x) <= SYM_RTOL * abs(y_ax)


_RUNS = {}


def _run(fuse_pap: bool, budget: bool):
    key = (fuse_pap, budget)
    if key not in _RUNS:
        _RUNS[key] = run_both(BUDGET if budget else 2000, fuse_pap=fuse_pap, do_reduced_regions=False)
    return _RUNS[key]


@pytest.mark.parametrize("fuse_pap", [True, False], ids=["fused", "unfused"])
def test_uniform_step_fixed_budget_matches_jax(fuse_pap):
    vj, sj, vt, st = _run(fuse_pap, True)
    assert int(sj["iterations"]) == st["iterations"] == BUDGET
    assert st["n_regions"] == int(sj["n_regions"]) == 0
    assert max_vel_rel(vj, vt) <= BUDGET_VEL_RTOL


def test_uniform_step_converged_agrees():
    vj, sj, vt, st = _run(True, False)
    print(f"uniform iterations: jax {int(sj['iterations'])}, port {st['iterations']}")
    assert bool(sj["converged"]) and st["converged"] and st["boundary_active"] == 0
    assert float(sj["error"]) < 1e-3 and st["error"] < 1e-3
    assert max_vel_rel(vj, vt) <= CONVERGED_VEL_RTOL
