"""The fused reduced apply of ``fuse_pap=True`` (the bench default) against
the JAX package, in fp64 on the CPU.

The twins of ``grid_mom_pap_packed`` and ``finish_packed`` against the
Pallas kernels (interpret mode), ``make_apply_packed_pap`` against the JAX
one, its <x, A x> against the unfused apply, and the deterministic region
sum of ``reduced.RegionSum``.  The cases (honey_coil and the solid-cut
floor at 16^3, tile 8 and 16) are those of ``test_torch_packed_apply``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import solver as jsolver

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.reduced import RegionSum

from test_torch_packed_apply import _get, _rel

torch.set_num_threads(1)

KERNEL_RTOL = 1e-11  # fp64; only the order of the sums differs
PAP_RTOL = 1e-11


@pytest.fixture(params=[("honey_coil", 8), ("honey_coil", 16), ("solid", 8), ("solid", 16)],
                ids=["honey_coil-T8", "honey_coil-T16", "solid-T8", "solid-T16"])
def case(request):
    return _get(request.param)


def _jax_grid_mom_pap(case):
    return jpa.grid_mom_pap_packed(jpa._pad_halo(jnp.asarray(case["x"])), case["coeffs_padded"], case["grid"].res,
                                   case["params"].tile_size, case["params"].basis)


def test_grid_mom_pap_twin_matches_pallas(case):
    """out_grid, the moments and the summed <x, out_grid> partials."""
    out_j, mom_j, pap_j = _jax_grid_mom_pap(case)
    out_t, mom_t, pap_t = tpa.grid_mom_pap_packed(torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]),
                                                  case["params"].tile_size)
    assert _rel(out_t, out_j) <= KERNEL_RTOL
    assert _rel(mom_t, mom_j) <= KERNEL_RTOL
    assert abs(float(pap_t.sum()) - float(jnp.sum(pap_j))) <= KERNEL_RTOL * abs(float(jnp.sum(pap_j)))


def test_grid_mom_pap_moments_equal_moments_kernel(case):
    """The fused kernel's moments are the moments kernel's."""
    x, c, T = torch.from_numpy(case["x"]), torch.from_numpy(case["coeffs"]), case["params"].tile_size
    assert _rel(tpa.grid_mom_pap_packed(x, c, T)[1], tpa.moments_packed(x, c, T)) <= KERNEL_RTOL


def test_finish_twin_matches_pallas(case):
    """The same out_grid (here random) and u through both."""
    ref = jpa.finish_packed(case["coeffs_padded"], jnp.asarray(case["y"]), jnp.asarray(case["u"]), case["grid"].res)
    got = tpa.finish_packed(torch.from_numpy(case["coeffs"]), torch.from_numpy(case["y"]), torch.from_numpy(case["u"]))
    assert _rel(got, ref) <= KERNEL_RTOL


def test_grid_branch_plus_finish_is_the_reduced_apply(case):
    """finish(grid_mom_pap(x).out_grid, u) == apply_reduced(x, u)."""
    x, c, u = (torch.from_numpy(case[k]) for k in ("x", "coeffs", "u"))
    out_grid = tpa.grid_mom_pap_packed(x, c, case["params"].tile_size)[0]
    assert _rel(tpa.finish_packed(c, out_grid, u), tpa.apply_reduced_packed(x, c, u)) <= KERNEL_RTOL


@pytest.mark.parametrize("key", [("honey_coil", 8), ("solid", 8)], ids=["honey_coil-T8", "solid-T8"])
def test_make_apply_packed_pap_matches_jax(key):
    """(A x, <x, A x>) of the port against JAX's, each from its own setup;
    and the port's fused <x, A x> against the unfused apply's."""
    case = _get(key)
    ap_j, pap_j = jsolver.make_apply_packed_pap(case["grid"], case["cls"], case["asm"], case["params"], case["R"])(
        jnp.asarray(case["x"]))
    args = (case["tgrid"], case["tcls"], case["tasm"], case["tparams"], case["R"])
    x = torch.from_numpy(case["x"])
    ap_t, pap_t = tsolver.make_apply_packed_pap(*args)(x)
    assert _rel(ap_t, ap_j) <= KERNEL_RTOL
    assert abs(float(pap_t) - float(pap_j)) <= PAP_RTOL * abs(float(pap_j))
    unfused = float(torch.sum(x * tsolver.make_apply_packed(*args)(x)))
    assert abs(float(pap_t) - unfused) <= PAP_RTOL * abs(unfused)


@pytest.mark.parametrize("bad", ["shape", "dtype", "channels"])
def test_fused_wrappers_reject_bad_inputs(bad):
    x = torch.zeros((7, 8, 8, 8), dtype=torch.float64)
    c = torch.zeros((tpa.N_COEFF, 8, 8, 8), dtype=torch.float64)
    if bad == "shape":
        x = torch.zeros((7, 8, 8, 4), dtype=torch.float64)
    elif bad == "dtype":
        x = x.to(torch.float32)
    else:
        c = c[: tpa.N_COEFF_UNIFORM].contiguous()  # the uniform stack lacks the reduced-face masks
    with pytest.raises((ValueError, TypeError)):
        tpa.grid_mom_pap_packed(x, c, 8)


def test_cube_scatter_matches_index_add():
    """The fixed-order region sum against the index_add it replaces (fp64)."""
    rng = np.random.default_rng(3)
    R, nc = 64, 512
    roc = torch.from_numpy(rng.integers(-1, R, nc).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((nc, 5, 7)) * 10.0 ** rng.integers(-3, 4, (nc, 1, 1)))
    seg = torch.where(roc >= 0, roc, R).long()
    ref = torch.zeros((R + 1, 5, 7), dtype=torch.float64).index_add(0, seg, vals)[:R]
    got = RegionSum(roc, R)(vals)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
