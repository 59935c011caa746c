"""Tiled mode on a card (marker ``cuda``; each test skips without CUDA).
This file imports no JAX:

    python -m pytest tests/test_torch_cuda_tiled.py -m cuda --noconftest -q

* The tile-dependent kernels (moments, expand, grid_mom_pap and
  exp_finish_update, Pallas kernels 1, 2, 4 and 11) at tile 8 on the tiled
  honey_coil 32^3 setup, in f32 and f64, against their plain twins; and
  their affine forms (K = 4) on the same setup assembled in the affine
  basis, exp_finish_update with kinds arrow and none.
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
from polystokes_tpu_torch.config import BasisOrder, PreconditionerType, SolverParams
from polystokes_tpu_torch.reduced import RegionSum
from polystokes_tpu_torch.scenes.builders import honey_coil

# the packed CELL_ARROW path, stated since the defaults became JAX's (IDENTITY, unpacked)
PACKED_ARROW = dict(preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)

T = 8
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # the twin sums in another order
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _params(dtype, **kw):
    return SolverParams(dtype=dtype, do_tile=True, tile_size=T, tile_padding=2, tolerance=1e-5, max_iterations=5000,
                        bicgstab_fallback=False, **{**PACKED_ARROW, **kw})


def _case(dtype, basis=BasisOrder.QUADRATIC):
    """The tiled setup's stack, region algebra output v, masks, CELL_ARROW
    factors and three masked random vectors, in the given basis."""
    grid, scene = honey_coil(n=32, dtype=dtype, device="cuda")
    params = _params(dtype, basis=basis)
    cls, asm = tsolver._setup(grid, scene, params)
    assert int(cls.n_regions) >= 1
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    mask = tpa.packed_masks(cls, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    x, r, p = ((torch.randn((7,) + grid.res, generator=g, device="cuda", dtype=dtype) * mask).contiguous()
               for _ in range(3))
    v = algebra(tpa.moments_packed_plain(x, coeffs, T, basis))
    factors = tpa.pack_arrow_factors(tsolver.precond_factors_packed(grid, cls, asm, params))
    return dict(coeffs=coeffs, red=red, x=x, r=r, p=p, v=v, factors=factors)


def _close(got, ref, dtype):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        assert scale > 0 and err <= RTOL[dtype] * scale, (i, err, scale)


def _kernel_and_twin(name, c, dtype, basis=BasisOrder.QUADRATIC, kind="arrow"):
    """(kernel call, twin call) of a tile-dependent kernel on the case."""
    x, coeffs, v = c["x"], c["coeffs"], c["v"]
    alpha = torch.tensor(0.37, dtype=dtype, device="cuda")
    og = tpa.grid_mom_pap_packed_plain(x, coeffs, T)[0]
    f = c["factors"] if kind == "arrow" else None
    calls = {
        "moments": (lambda: tpa.moments_packed(x, coeffs, T, basis), lambda: tpa.moments_packed_plain(x, coeffs, T, basis)),
        "expand": (lambda: tpa.expand_packed(v, c["red"], T, basis),
                   lambda: tpa.expand_packed_plain(v, c["red"], T, basis)),
        "grid_mom_pap": (lambda: tpa.grid_mom_pap_packed(x, coeffs, T, basis),
                         lambda: tpa.grid_mom_pap_packed_plain(x, coeffs, T, basis)),
        "exp_finish_update": (
            lambda: tpa.exp_finish_update_packed(x, c["r"], c["p"], alpha, coeffs, og, v, T, f, kind, basis=basis),
            lambda: tpa.exp_finish_update_packed_plain(x, c["r"], c["p"], alpha, coeffs, og, v, T, f, kind, basis)),
    }
    return calls[name]


def _launch_and_compare(name, kernel, twin, dtype):
    """One launch of the kernel, counted once, against its twin."""
    before = tpa.LAUNCHES[name]
    got = kernel()
    torch.cuda.synchronize()
    assert tpa.LAUNCHES[name] == before + 1
    got, ref = (got if isinstance(got, tuple) else (got,)), twin()
    ref = ref if isinstance(ref, tuple) else (ref,)
    if name == "grid_mom_pap":  # partials at any granularity: compare their sum
        got, ref = got[:2] + (got[2].double().sum(),), ref[:2] + (ref[2].double().sum(),)
    _close(tuple(got), tuple(ref), dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("name", ["moments", "expand", "grid_mom_pap", "exp_finish_update"])
def test_tile_8_kernel_matches_twin(name, dtype):
    _require_cuda()
    _launch_and_compare(name, *_kernel_and_twin(name, _case(dtype), dtype), dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("name, kind", [("moments", None), ("expand", None), ("grid_mom_pap", None),
                                        ("exp_finish_update", "arrow"), ("exp_finish_update", "none")])
def test_tile_8_affine_kernel_matches_twin(name, kind, dtype):
    """The K = 4 forms on the tiled setup assembled in the affine basis:
    12 moments and coefficients a cube."""
    _require_cuda()
    basis = BasisOrder.AFFINE
    c = _case(dtype, basis)
    assert c["v"].shape[2] == 12
    _launch_and_compare(name, *_kernel_and_twin(name, c, dtype, basis, kind or "arrow"), dtype)


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
