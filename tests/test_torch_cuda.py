"""The port's CUDA kernels on a card (marker ``cuda``; each test skips
without CUDA).  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import sdf
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import effective_max_regions, is_active
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.grid import Grid
from polystokes_tpu_torch.scenes.builders import _base, honey_coil

T = 16
# f32: sums of up to 4096 terms in another order than the twin; fp64 likewise
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _setup(dtype, **kw):
    grid, scene = honey_coil(n=32, dtype=dtype, device="cuda")
    params = SolverParams(do_tile=False, dtype=dtype, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000, **kw)
    cls, asm = tsolver._setup(grid, scene, params)
    return grid, scene, params, cls, asm


def _check_cases(cases, dtype):
    """Each (name, kernel thunk, twin outputs): outputs within RTOL of the
    twin's max, one launch of the kernel each."""
    for name, kernel, refs in cases:
        before = tpa.LAUNCHES[name]
        got = kernel()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        for g, r in zip(got, refs):
            assert g.shape == r.shape, name
            assert float((g - r).abs().max()) <= RTOL[dtype] * float(r.abs().max()), name
        assert tpa.LAUNCHES[name] == before + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_twins(dtype):
    """Each reduced-path kernel against its plain twin on the card, honey_coil 32^3, tile 16."""
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
    out_grid, _, partials = tpa.grid_mom_pap_packed_plain(x, coeffs, T)
    _check_cases((
        ("moments", lambda: tpa.moments_packed(x, coeffs, T), mom),
        ("expand", lambda: tpa.expand_packed(v, red, T), u),
        ("apply_reduced", lambda: tpa.apply_reduced_packed(x, coeffs, u), tpa.apply_reduced_packed_plain(x, coeffs, u)),
        ("grid_mom_pap", lambda: tpa.grid_mom_pap_packed(x, coeffs, T), (out_grid, mom, partials)),
        ("finish", lambda: tpa.finish_packed(coeffs, out_grid, u), tpa.finish_packed_plain(coeffs, out_grid, u)),
    ), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_uniform_kernels_match_twins(dtype):
    """The uniform kernels against their twins on the 14-channel stack."""
    _require_cuda()
    grid, _, params, cls, asm = _setup(dtype, do_reduced_regions=False)
    coeffs = tpa.pack_coeffs(asm)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype)
    x = (x * tpa.packed_masks(cls, dtype)).contiguous()
    _check_cases((
        ("apply_uniform", lambda: tpa.apply_uniform_packed(x, coeffs), tpa.apply_uniform_packed_plain(x, coeffs)),
        ("apply_uniform_pap", lambda: tpa.apply_uniform_pap_packed(x, coeffs), tpa.apply_uniform_pap_packed_plain(x, coeffs)),
    ), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("reduced, fuse_pap", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["reduced-fused", "reduced-unfused", "uniform-fused", "uniform-unfused"])
def test_cuda_step_matches_cpu(reduced, fuse_pap):
    """The step on the card (kernels) against the CPU (twins), fp64 32^3."""
    _require_cuda()
    params = SolverParams(do_tile=False, dtype=torch.float64, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000,
                          do_reduced_regions=reduced, fuse_pap=fuse_pap)
    out = {}
    for dev in ("cuda", "cpu"):
        grid, scene = honey_coil(n=32, dtype=torch.float64, device=dev)
        vel, _, stats = tsolver.step(grid, scene, params)
        assert stats["converged"] and stats["boundary_active"] == 0
        assert (stats["n_regions"] >= 1) == reduced
        out[dev] = [v.cpu() for v in vel]
    scale = max(float(v.abs().max()) for v in out["cpu"])
    for a in range(3):
        assert float((out["cuda"][a] - out["cpu"][a]).abs().max()) <= 2e-4 * scale


def _solid_setup(dtype, tile=T):
    """The solid-cut floor of the JAX tests' _solid_case at 32^3 on the
    card: a liquid box on a tilted floor that cuts faces of every family."""
    grid = Grid(res=(32, 32, 32), dx=1.0 / 32)
    scene = _base(grid, sdf.box((0.1, 0.1, 0.1), (0.9, 0.9, 0.9)), sdf.plane((0.15, 0.1, 1.0), 0.23), dtype, "cuda",
                  dt=1 / 48, viscosity=50.0)
    params = SolverParams(do_tile=False, dtype=dtype, tile_size=tile, max_regions=64)
    cls, asm = tsolver._setup(grid, scene, params)
    cut = sum(int((is_active(cls.face_labels[a]) & (asm.ffw[a] > 0) & (asm.ffw[a] < 1)).sum()) for a in range(3))
    assert cut > 0 and int(cls.n_regions) >= 1
    return grid, params, cls, asm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_transpose_kernels_match_twins(dtype):
    """transpose_u, forward_s and combine against their twins on the card,
    on the solid-cut floor at 32^3, tile 16."""
    _require_cuda()
    grid, params, cls, asm = _solid_setup(dtype)
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype)
    x = (x * tpa.packed_masks(cls, dtype)).contiguous()
    u = tpa.expand_packed_plain(algebra(tpa.moments_packed_plain(x, coeffs, T)), red, T)
    s = tpa.forward_s_packed_plain(x, coeffs)
    _check_cases((
        ("transpose_u", lambda: tpa.transpose_u_packed(coeffs, u), tpa.transpose_u_packed_plain(coeffs, u)),
        ("forward_s", lambda: tpa.forward_s_packed(x, coeffs), s),
        ("combine", lambda: tpa.combine_packed(x, coeffs, s, u), tpa.combine_packed_plain(x, coeffs, s, u)),
    ), dtype)


@pytest.mark.cuda
def test_cuda_region_arrow_step_matches_cpu():
    """The REGION_ARROW step (fuse_pap on) on the card against the CPU, fp64 32^3."""
    _require_cuda()
    params = SolverParams(do_tile=False, dtype=torch.float64, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000,
                          preconditioner=PreconditionerType.REGION_ARROW)
    out = {}
    for dev in ("cuda", "cpu"):
        grid, scene = honey_coil(n=32, dtype=torch.float64, device=dev)
        tpa.reset_launches()
        vel, _, stats = tsolver.step(grid, scene, params)
        assert stats["converged"] and stats["boundary_active"] == 0 and stats["n_regions"] >= 1
        if dev == "cuda":  # one solve in pcg_init and one a loop pass, gated passes included
            assert tpa.LAUNCHES["transpose_u"] == 1 + stats["loop_passes"]
        out[dev] = [v.cpu() for v in vel]
    scale = max(float(v.abs().max()) for v in out["cpu"])
    for a in range(3):
        assert float((out["cuda"][a] - out["cpu"][a]).abs().max()) <= 2e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_update_kernels_match_twins(dtype):
    """cg_update, finish_update and exp_finish_update against their twins on
    the card for every preconditioner kind, on the solid-cut floor at 32^3,
    tile 16, with the real CELL_ARROW and DIAGONAL factors."""
    _require_cuda()
    grid, params, cls, asm = _solid_setup(dtype)
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    gen = torch.Generator(device="cuda").manual_seed(3)
    mask = tpa.packed_masks(cls, dtype)
    x, r, p, ap, og = ((torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype) * mask).contiguous()
                       for _ in range(5))
    v = algebra(tpa.moments_packed_plain(p, coeffs, T))
    u = tpa.expand_packed_plain(v, red, T)
    alpha = torch.tensor(0.37, dtype=dtype, device="cuda")
    factors = {"none": None,
               "diag": tsolver.precond_factors_packed(grid, cls, asm, params.replace(
                   preconditioner=PreconditionerType.DIAGONAL))["inv_packed"],
               "arrow": tpa.pack_arrow_factors(tsolver.precond_factors_packed(grid, cls, asm, params))}
    cases = []
    for kind, f in factors.items():
        cases += [
            ("cg_update", lambda f=f, kind=kind: tpa.cg_update_packed(x, r, p, ap, alpha, f, kind),
             tpa.cg_update_packed_plain(x, r, p, ap, alpha, f, kind)),
            ("finish_update", lambda f=f, kind=kind: tpa.finish_update_packed(x, r, p, alpha, coeffs, og, u, f, kind),
             tpa.finish_update_packed_plain(x, r, p, alpha, coeffs, og, u, f, kind)),
            ("exp_finish_update",
             lambda f=f, kind=kind: tpa.exp_finish_update_packed(x, r, p, alpha, coeffs, og, v, T, f, kind),
             tpa.exp_finish_update_packed_plain(x, r, p, alpha, coeffs, og, v, T, f, kind)),
        ]
    _check_cases(cases, dtype)


@pytest.mark.cuda
def test_cuda_fused_update_step_matches_cpu():
    """Path F (fuse_update with fuse_expand, CELL_ARROW) on the card against
    the CPU, fp64 32^3; every iteration's update is the expanding kernel."""
    _require_cuda()
    params = SolverParams(do_tile=False, dtype=torch.float64, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000,
                          fuse_update=True)
    out = {}
    for dev in ("cuda", "cpu"):
        grid, scene = honey_coil(n=32, dtype=torch.float64, device=dev)
        tpa.reset_launches()
        vel, _, stats = tsolver.step(grid, scene, params)
        assert stats["converged"] and stats["boundary_active"] == 0 and stats["n_regions"] >= 1
        if dev == "cuda":  # one a loop pass, gated passes included
            passes = stats["loop_passes"]
            assert tpa.LAUNCHES["exp_finish_update"] == tpa.LAUNCHES["grid_mom_pap"] == passes
            assert tpa.LAUNCHES["expand"] == 1 and tpa.LAUNCHES["finish"] == 0
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
