"""The PyTorch port's setup chain against the JAX package, in fp64 on the
CPU: scenes, cut-cell weights, classification, assembly, the packed
coefficient stack and the CELL_ARROW factors.

Cases: honey_coil 16^3 (tile 8, untiled cube regions, max_regions 64)
and the tilted solid floor of ``test_packed_solid_untiled._solid_case``
with ``do_tile=False``, which cuts faces of every family.  Both packages
start from the same arrays (``convert.scene_from_numpy``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import solver as jsolver
from polystokes_tpu.classify import classify as jclassify
from polystokes_tpu.classify import effective_max_regions as jR
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.pallas_apply import pack_coeffs as jpack_coeffs
from polystokes_tpu.scenes import builders as jbuilders
from polystokes_tpu.weights import compute_weights as jweights

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import sdf as tsdf
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import classify as tclassify
from polystokes_tpu_torch.packed_apply import pack_coeffs as tpack_coeffs
from polystokes_tpu_torch.scenes import builders as tbuilders
from polystokes_tpu_torch.weights import compute_weights as tweights

from test_packed_solid_untiled import _solid_case

torch.set_num_threads(1)

SLICE = dict(use_pallas=True, fuse_pap=False, preconditioner=JPC.CELL_ARROW, bicgstab_fallback=False)
WEIGHT_RTOL = 1e-12  # same arithmetic in the same order; fp64 round-off only
ASM_RTOL = 1e-10  # batched Cholesky (port) against LU (JAX) in the region solves
PACK_RTOL = 1e-12
PRECOND_RTOL = 1e-10


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(port, ref):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    diff = float(np.max(np.abs(port - ref))) if ref.size else 0.0
    return diff / scale if scale > 0 else diff


def _honey_case():
    from polystokes_tpu.config import SolverParams

    grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
    params = SolverParams(dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64)
    return grid, params, scene


def _build(case):
    if case == "honey_coil":
        grid, params, scene = _honey_case()
    else:
        grid, params, scene = _solid_case(do_tile=False)[:3]
    params = params.replace(**SLICE)
    R = jR(grid, params)
    lw, fw = jweights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
    cls = jclassify(grid, lw, fw, params)
    asm, _ = jsolver.assemble(grid, scene, cls, lw, fw, params, R)
    jax_side = dict(grid=grid, params=params, scene=scene, lw=lw, fw=fw, cls=cls, asm=asm)

    tgrid = convert.grid_from_jax(grid)
    tparams = convert.params_from_jax(params)
    tscene = convert.scene_from_numpy(scene, "cpu")
    tlw, tfw = tweights(tgrid, tscene.surface_sdf, tscene.collision_sdf, tparams.dtype)
    tcls = tclassify(tgrid, tlw, tfw, tparams)
    tasm, _ = tsolver.assemble(tgrid, tscene, tcls, tlw, tfw, tparams, R)
    port = dict(grid=tgrid, params=tparams, scene=tscene, lw=tlw, fw=tfw, cls=tcls, asm=tasm)
    return jax_side, port


_CASES = {}


@pytest.fixture(params=["honey_coil", "solid"])
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = _build(request.param)
    return _CASES[request.param]


@pytest.mark.parametrize("name", ["viscous_beam", "honey_coil", "armadillo_melt", "jelly_jam", "jelly_jam_si", "conveyor_belt"])
def test_scene_arrays_equal(name):
    g_j, s_j = jbuilders.SCENES[name](n=16, dtype=jnp.float64)
    g_t, s_t = tbuilders.SCENES[name](n=16, dtype=torch.float64, device="cpu")
    assert g_t == convert.grid_from_jax(g_j)
    for f in dataclasses.fields(s_t):
        a_t, a_j = getattr(s_t, f.name), getattr(s_j, f.name)
        if a_j is None:
            assert a_t is None, f.name
            continue
        if isinstance(a_j, tuple):
            for x_t, x_j in zip(a_t, a_j):
                np.testing.assert_array_equal(_np(x_t), np.asarray(x_j), err_msg=f.name)
        else:
            np.testing.assert_array_equal(_np(a_t), np.asarray(a_j), err_msg=f.name)


def test_solid_case_sdfs_equal():
    """The solid case's tilted floor and inner box sampled by both packages."""
    from polystokes_tpu import sdf as jsdf

    res, dx = (16, 16, 16), 1.0 / 16
    for jf, tf in (
        (jsdf.box((0.10, 0.10, 0.10), (0.90, 0.90, 0.90)), tsdf.box((0.10, 0.10, 0.10), (0.90, 0.90, 0.90))),
        (jsdf.plane((0.15, 0.1, 1.0), 0.23), tsdf.plane((0.15, 0.1, 1.0), 0.23)),
    ):
        np.testing.assert_array_equal(
            _np(tsdf.sample_at_centers(tf, res, dx, torch.float64, "cpu")),
            np.asarray(jsdf.sample_at_centers(jf, res, dx, jnp.float64)),
        )


def test_compute_weights(case):
    jx, pt = case
    for key in jx["lw"]:
        assert _rel(pt["lw"][key], jx["lw"][key]) <= WEIGHT_RTOL, key
        assert _rel(pt["fw"][key], jx["fw"][key]) <= WEIGHT_RTOL, key


@pytest.mark.parametrize("field", ["cell_labels", "face_labels", "edge_labels", "cell_region", "face_region",
                                   "edge_region", "region_valid", "n_regions", "region_of_cube", "region_overflow"])
def test_classification_fields_equal(case, field):
    jx, pt = case
    a_j, a_t = getattr(jx["cls"], field), getattr(pt["cls"], field)
    pairs = zip(a_t, a_j) if isinstance(a_j, (tuple, list)) else [(a_t, a_j)]
    for x_t, x_j in pairs:
        np.testing.assert_array_equal(_np(x_t), np.asarray(x_j), err_msg=field)
    if field == "n_regions":
        assert int(a_t) >= 1, "the case must exercise the reduced path"


@pytest.mark.parametrize("field", ["clw_s", "elw_s", "ffw", "mc_inv", "uinv_c", "uinv_e", "com", "binv",
                                   "b_v", "b_w", "rhs_solid"])
def test_assembled_fields(case, field):
    jx, pt = case
    a_j, a_t = getattr(jx["asm"], field), getattr(pt["asm"], field)
    if field == "rhs_solid":
        a_j = [a_j.p, *a_j.tc, *a_j.te]
        a_t = [a_t.p, *a_t.tc, *a_t.te]
    pairs = zip(a_t, a_j) if isinstance(a_j, (tuple, list)) else [(a_t, a_j)]
    for x_t, x_j in pairs:
        assert _rel(x_t, x_j) <= ASM_RTOL, field


def test_solid_case_has_cut_faces(case):
    """Each case has active faces with 0 < ffw < 1 (the second-ffw hazard)."""
    _, pt = case
    from polystokes_tpu_torch.classify import is_active

    cut = sum(int((is_active(pt["cls"].face_labels[a]) & (pt["asm"].ffw[a] > 0) & (pt["asm"].ffw[a] < 1)).sum())
              for a in range(3))
    assert cut > 0


def test_pack_coeffs(case):
    jx, pt = case
    ref = jpack_coeffs(jx["asm"], jx["cls"], pad=False)
    assert _rel(tpack_coeffs(pt["asm"], pt["cls"]), ref) <= PACK_RTOL


def test_precond_factors_packed(case):
    jx, pt = case
    ref = jsolver.precond_factors_packed(jx["grid"], jx["cls"], jx["asm"], jx["params"])
    got = tsolver.precond_factors_packed(pt["grid"], pt["cls"], pt["asm"], pt["params"])
    for key in ("k", "inv_d", "kd", "inv_schur", "te_inv_s"):
        r, g = ref[key], got[key]
        pairs = zip(g, r) if isinstance(r, (tuple, list)) else [(g, r)]
        for x_t, x_j in pairs:
            assert _rel(x_t, x_j) <= PRECOND_RTOL, key


@pytest.mark.parametrize("basis", ["QUADRATIC", "AFFINE"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_basis_matches_jax(basis, axis):
    """Conversion rows, monomials, the monomial matrix and the shift matrix
    on random offsets."""
    from polystokes_tpu import basis as jb
    from polystokes_tpu.config import BasisOrder as JB

    from polystokes_tpu_torch import basis as tb
    from polystokes_tpu_torch.config import BasisOrder as TB

    jbo, tbo = JB[basis], TB[basis]
    off = np.random.default_rng(axis).standard_normal((5, 4, 3)) * 4.0
    np.testing.assert_array_equal(tb.monomial_matrix(axis, tbo), jb.monomial_matrix(axis, jbo))
    np.testing.assert_allclose(
        _np(tb.conversion_coefficients(torch.from_numpy(off), axis, tbo)),
        np.asarray(jb.conversion_coefficients(jnp.asarray(off), axis, jbo)), rtol=1e-15, atol=0,
    )
    xyz = [off[..., i] for i in range(3)]
    for m_t, m_j in zip(tb.monomials_xyz(*map(torch.from_numpy, xyz), tbo), jb.monomials_xyz(*map(jnp.asarray, xyz), jbo)):
        np.testing.assert_allclose(_np(m_t), np.asarray(m_j), rtol=1e-15, atol=0)
    np.testing.assert_allclose(
        _np(tb.monomial_shift_matrix(*map(torch.from_numpy, xyz), tbo)),
        np.asarray(jb.monomial_shift_matrix(*map(jnp.asarray, xyz), jbo)), rtol=1e-15, atol=0,
    )
    assert tb.n_monomials(tbo) == jb.n_monomials(jbo)
