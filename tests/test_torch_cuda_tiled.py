"""Tiled mode on a card (marker ``cuda``; each test skips without CUDA).
This file imports no JAX:

    python -m pytest tests/test_torch_cuda_tiled.py -m cuda --noconftest -q

* The tile-dependent kernels (moments, expand, grid_mom_pap and
  exp_finish_update, Pallas kernels 1, 2, 4 and 11) at tile 8 on the tiled
  honey_coil 32^3 setup, in f32 and f64, against their plain twins.
* ``reduced.RegionSum`` on the card: bit-equal across calls on a tiled and
  an untiled cube map, and within round-off of the CPU's sum.
* The tiled 32^3 step (tile 8, Path A and Path F) converged and bit-equal
  across two runs.
"""
import numpy as np
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch import step
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import SolverParams
from polystokes_tpu_torch.reduced import RegionSum
from polystokes_tpu_torch.scenes.builders import honey_coil

T = 8
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # the twin sums in another order
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _params(dtype, **kw):
    return SolverParams(dtype=dtype, do_tile=True, tile_size=T, tile_padding=2, tolerance=1e-5, max_iterations=5000,
                        **kw)


def _case(dtype):
    """The tiled setup's stack, region algebra output v, masks, CELL_ARROW
    factors and three masked random vectors."""
    grid, scene = honey_coil(n=32, dtype=dtype, device="cuda")
    params = _params(dtype)
    cls, asm = tsolver._setup(grid, scene, params)
    assert int(cls.n_regions) >= 1
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    mask = tpa.packed_masks(cls, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    x, r, p = ((torch.randn((7,) + grid.res, generator=g, device="cuda", dtype=dtype) * mask).contiguous()
               for _ in range(3))
    v = algebra(tpa.moments_packed_plain(x, coeffs, T))
    factors = tpa.pack_arrow_factors(tsolver.precond_factors_packed(grid, cls, asm, params))
    return dict(coeffs=coeffs, red=red, x=x, r=r, p=p, v=v, factors=factors)


def _close(got, ref, dtype):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        assert scale > 0 and err <= RTOL[dtype] * scale, (i, err, scale)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("name", ["moments", "expand", "grid_mom_pap", "exp_finish_update"])
def test_tile_8_kernel_matches_twin(name, dtype):
    _require_cuda()
    c = _case(dtype)
    x, coeffs = c["x"], c["coeffs"]
    alpha = torch.tensor(0.37, dtype=dtype, device="cuda")
    og = tpa.grid_mom_pap_packed_plain(x, coeffs, T)[0]
    calls = {
        "moments": (lambda: tpa.moments_packed(x, coeffs, T), lambda: tpa.moments_packed_plain(x, coeffs, T)),
        "expand": (lambda: tpa.expand_packed(c["v"], c["red"], T), lambda: tpa.expand_packed_plain(c["v"], c["red"], T)),
        "grid_mom_pap": (lambda: tpa.grid_mom_pap_packed(x, coeffs, T),
                         lambda: tpa.grid_mom_pap_packed_plain(x, coeffs, T)),
        "exp_finish_update": (
            lambda: tpa.exp_finish_update_packed(x, c["r"], c["p"], alpha, coeffs, og, c["v"], T, c["factors"], "arrow"),
            lambda: tpa.exp_finish_update_packed_plain(x, c["r"], c["p"], alpha, coeffs, og, c["v"], T, c["factors"],
                                                       "arrow")),
    }
    kernel, twin = calls[name]
    before = tpa.LAUNCHES[name]
    got = kernel()
    torch.cuda.synchronize()
    assert tpa.LAUNCHES[name] == before + 1
    got, ref = (got if isinstance(got, tuple) else (got,)), twin()
    ref = ref if isinstance(ref, tuple) else (ref,)
    if name == "grid_mom_pap":  # partials at any granularity: compare their sum
        got, ref = got[:2] + (got[2].double().sum(),), ref[:2] + (ref[2].double().sum(),)
    _close(tuple(got), tuple(ref), dtype)


def _cube_map(kind, rng):
    if kind == "tiled":
        nc, R = 32768, 65536
        roc = rng.permutation(R)[:nc]
        roc[rng.random(nc) < 0.5] = -1
    else:
        nc, R = 512, 64
        roc = rng.integers(-1, R // 2, nc)
    return torch.from_numpy(roc.astype(np.int32)), R


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiled", "untiled"])
def test_region_sum_bit_equal_on_card(kind):
    _require_cuda()
    rng = np.random.default_rng(4)
    roc, R = _cube_map(kind, rng)
    vals = torch.from_numpy(rng.standard_normal((roc.shape[0], 26))).to(torch.float32)
    rsum = RegionSum(roc.cuda(), R)
    first, second = rsum(vals.cuda()), rsum(vals.cuda())
    assert torch.equal(first, second)
    assert torch.equal(RegionSum(roc.cuda(), R)(vals.cuda()), first)
    ref = RegionSum(roc, R)(vals.double())
    assert float((first.double().cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_update", [False, True], ids=["A", "F"])
def test_tiled_step_bit_equal_on_card(fuse_update):
    _require_cuda()
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    params = _params(torch.float32, fuse_update=fuse_update)
    v1, _, s1 = step(grid, scene, params)
    v2, _, s2 = step(grid, scene, params)
    assert s1["converged"] and s1["boundary_active"] == 0 and s1["n_regions"] >= 1
    assert s1["iterations"] == s2["iterations"]
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))
