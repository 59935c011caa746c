"""The port's CUDA kernels on a card (marker ``cuda``; each test skips
without CUDA).  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import SolverParams
from polystokes_tpu_torch.scenes.builders import honey_coil

T = 16
# f32: sums of up to 4096 terms in another order than the twin; fp64 likewise
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _setup(dtype):
    grid, scene = honey_coil(n=32, dtype=dtype, device="cuda")
    params = SolverParams(dtype=dtype, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000)
    cls, asm = tsolver._setup(grid, scene, params)
    return grid, scene, params, cls, asm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_twins(dtype):
    """Each kernel against its plain twin on the card, honey_coil 32^3, tile 16."""
    _require_cuda()
    grid, _, params, cls, asm = _setup(dtype)
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype)
    x = (x * tpa.packed_masks(cls, dtype)).contiguous()
    mom = tpa.moments_packed_plain(x, coeffs, T)
    v = algebra(mom)
    u = tpa.expand_packed_plain(v, red, T)
    before = dict(tpa.LAUNCHES)
    for name, got, ref in (
        ("moments", tpa.moments_packed(x, coeffs, T), mom),
        ("expand", tpa.expand_packed(v, red, T), u),
        ("apply_reduced", tpa.apply_reduced_packed(x, coeffs, u), tpa.apply_reduced_packed_plain(x, coeffs, u)),
    ):
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= RTOL[dtype] * float(ref.abs().max()), name
        assert tpa.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
def test_cuda_step_matches_cpu():
    """The step on the card (kernels) against the CPU (twins), fp64 32^3."""
    _require_cuda()
    params = SolverParams(dtype=torch.float64, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000)
    out = {}
    for dev in ("cuda", "cpu"):
        grid, scene = honey_coil(n=32, dtype=torch.float64, device=dev)
        vel, _, stats = tsolver.step(grid, scene, params)
        assert stats["converged"] and stats["boundary_active"] == 0
        out[dev] = [v.cpu() for v in vel]
    scale = max(float(v.abs().max()) for v in out["cpu"])
    for a in range(3):
        assert float((out["cuda"][a] - out["cpu"][a]).abs().max()) <= 2e-4 * scale


@pytest.mark.cuda
def test_cuda_wrappers_reject_cpu_mix():
    """A CUDA tensor never reaches a twin: mixing devices raises."""
    _require_cuda()
    x = torch.zeros((7, 16, 16, 16), device="cuda")
    c = torch.zeros((tpa.N_COEFF, 16, 16, 16))
    with pytest.raises(ValueError):
        tpa.moments_packed(x, c, T)
