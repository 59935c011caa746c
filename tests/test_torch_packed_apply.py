"""The port's three packed-apply kernels of the unfused reduced apply
against the JAX Pallas kernels.

On the CPU each wrapper of ``polystokes_tpu_torch.packed_apply`` runs its
plain PyTorch twin; the JAX side runs the Pallas kernels as the JAX tests
do on the CPU (interpret mode, picked by ``_auto_interpret``), on the
halo-padded inputs they take.  Both get the same numpy inputs, in fp64, at
16^3 with tile 8 and 16, on honey_coil and on the solid-cut floor of
``test_packed_solid_untiled._solid_case``.  The CUDA kernels against their
twins are in ``test_torch_cuda.py``.
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
from polystokes_tpu_torch.classify import is_active

from test_packed_solid_untiled import _solid_case

torch.set_num_threads(1)

SLICE = dict(use_pallas=True, fuse_pap=False, preconditioner=JPC.CELL_ARROW, bicgstab_fallback=False)
KERNEL_RTOL = 1e-11  # fp64; only the order of the sums differs
SYM_RTOL = 1e-12
K = 10


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(port, ref):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    return float(np.max(np.abs(port - ref))) / float(np.max(np.abs(ref)))


def _build(name, T):
    if name == "honey_coil":
        grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
        params = JParams(dtype=jnp.float64, do_tile=False, tile_size=T, tile_padding=2, max_regions=64)
        R = jR(grid, params)
        lw, fw = jweights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
        cls = jclassify(grid, lw, fw, params)
        asm, _ = jsolver.assemble(grid, scene, cls, lw, fw, params, R)
    else:
        # the slice flags below change neither classification nor assembly
        grid, params, scene, cls, asm, R = _solid_case(tile=T, do_tile=False)
    params = params.replace(tile_size=T, **SLICE)

    tgrid, tparams = convert.grid_from_jax(grid), convert.params_from_jax(params)
    tscene = convert.scene_from_numpy(scene, "cpu")
    tcls, tasm = tsolver._setup(tgrid, tscene, tparams)

    rng = np.random.default_rng(7)
    mask = np.asarray(jpacked_masks(grid, cls, jnp.float64))
    red = np.array(jsolver._region_algebra_packed(grid, cls, asm, params, R)[1])
    cs = tuple(n // T for n in grid.res)
    return dict(
        grid=grid, params=params, cls=cls, asm=asm, R=R, tgrid=tgrid, tparams=tparams, tcls=tcls, tasm=tasm,
        coeffs=np.array(jpa.pack_coeffs(asm, cls, pad=False)),
        coeffs_padded=jpa.pack_coeffs(asm, cls, pad=True),
        x=rng.standard_normal((7,) + grid.res) * mask,
        y=rng.standard_normal((7,) + grid.res) * mask,
        v=rng.standard_normal((cs[0], cs[1], 3 * K, cs[2])),
        u=rng.standard_normal((3,) + grid.res) * red,
        red=red,
    )


_CASES = {}


def _get(key):
    if key not in _CASES:
        _CASES[key] = _build(*key)
    return _CASES[key]


@pytest.fixture(params=[("honey_coil", 8), ("honey_coil", 16), ("solid", 8), ("solid", 16)],
                ids=["honey_coil-T8", "honey_coil-T16", "solid-T8", "solid-T16"])
def case(request):
    return _get(request.param)


def test_case_is_meaningful(case):
    """Solid-cut active faces (0 < ffw < 1) and reduced faces both exist."""
    asm, cls = case["tasm"], case["tcls"]
    cut = sum(int((is_active(cls.face_labels[a]) & (asm.ffw[a] > 0) & (asm.ffw[a] < 1)).sum()) for a in range(3))
    assert cut > 0
    assert float(case["red"].sum()) > 0


def test_moments_twin_matches_pallas(case):
    T = case["params"].tile_size
    ref = jpa.moments_packed(jpa._pad_halo(jnp.asarray(case["x"])), case["coeffs_padded"], case["grid"].res, T,
                             case["params"].basis)
    got = tpa.moments_packed(torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]), T)
    assert _rel(got, ref) <= KERNEL_RTOL


def test_expand_twin_matches_pallas(case):
    T = case["params"].tile_size
    ref = jpa.expand_packed(jnp.asarray(case["v"]), jnp.asarray(case["red"]), case["grid"].res, T, case["params"].basis)
    got = tpa.expand_packed(torch.from_numpy(case["v"]), torch.from_numpy(case["red"]), T)
    assert _rel(got, ref) <= KERNEL_RTOL


def test_apply_reduced_twin_matches_pallas(case):
    ref = jpa.apply_reduced_packed(jpa._pad_halo(jnp.asarray(case["x"])), case["coeffs_padded"], jnp.asarray(case["u"]),
                                   case["grid"].res)
    got = tpa.apply_reduced_packed(torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]),
                                   torch.from_numpy(case["u"]))
    assert _rel(got, ref) <= KERNEL_RTOL


@pytest.mark.parametrize("key", [("honey_coil", 8), ("solid", 8)], ids=["honey_coil-T8", "solid-T8"])
def test_make_apply_packed_matches_jax(key):
    """The whole port apply against JAX's, each from its own setup."""
    case = _get(key)
    ref = jsolver.make_apply_packed(case["grid"], case["cls"], case["asm"], case["params"], case["R"])(jnp.asarray(case["x"]))
    apply_t = tsolver.make_apply_packed(case["tgrid"], case["tcls"], case["tasm"], case["tparams"], case["R"])
    assert _rel(apply_t(torch.from_numpy(case["x"])), ref) <= KERNEL_RTOL


def test_apply_symmetric(case):
    """<y, A x> == <A y, x>: catches a dropped second ffw factor."""
    apply_t = tsolver.make_apply_packed(case["tgrid"], case["tcls"], case["tasm"], case["tparams"], case["R"])
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    y_ax, ay_x = float(torch.sum(y * apply_t(x))), float(torch.sum(apply_t(y) * x))
    assert abs(y_ax - ay_x) <= SYM_RTOL * abs(y_ax)


def test_cpu_wrappers_count_no_launches(case):
    """On CPU tensors the wrappers run the twins: no kernel launch is counted."""
    before = dict(tpa.LAUNCHES)
    T = case["params"].tile_size
    x, c, u = torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]), torch.from_numpy(case["u"])
    tpa.moments_packed(x, c, T)
    tpa.expand_packed(torch.from_numpy(case["v"]), torch.from_numpy(case["red"]), T)
    tpa.apply_reduced_packed(x, c, u)
    tpa.finish_packed(c, tpa.grid_mom_pap_packed(x, c, T)[0], u)
    tpa.apply_uniform_packed(x, c)
    tpa.apply_uniform_pap_packed(x, c)
    assert tpa.LAUNCHES == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros((7, 8, 8, 8), dtype=torch.float64)
    c = torch.zeros((tpa.N_COEFF, 8, 8, 8), dtype=torch.float64)
    u = torch.zeros((3, 8, 8, 8), dtype=torch.float64)
    if bad == "shape":
        u = torch.zeros((3, 8, 8, 4), dtype=torch.float64)
    elif bad == "dtype":
        u = u.to(torch.float32)
    else:
        u = torch.zeros((3, 8, 8, 16), dtype=torch.float64)[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        tpa.apply_reduced_packed(x, c, u)
