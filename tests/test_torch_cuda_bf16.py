"""The bf16-storage forms of the port's CUDA kernels on a card (marker
``cuda``; each test skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_bf16.py -m cuda --noconftest -q

honey_coil 32^3, tile 16 and tile 8 (untiled cube regions), the stack and
masks in bfloat16: every kernel that reads the stack (kernels 1-8, 10-13)
against its twin on the same bf16 inputs in f32 and f64, one launch of
its bf16 form each (counted as ``<name>_bf16``); the bf16 packed apply
symmetric; the bf16 step converged and bit-equal across two runs, on the
card against the CPU.
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.basis import n_monomials
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import BasisOrder, PreconditionerType, SolverParams
from polystokes_tpu_torch.scenes.builders import honey_coil

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # sums in another order than the twin's
VEL_ATOL = 2e-4  # times max |v|: the card against the CPU
BF = torch.bfloat16


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _setup(dtype, T, basis=BasisOrder.QUADRATIC):
    grid, scene = honey_coil(n=32, dtype=dtype, device="cuda")
    params = SolverParams(do_tile=False, dtype=dtype, tile_size=T, max_regions=64, tolerance=1e-5, max_iterations=5000,
                          bicgstab_fallback=False, preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True,
                          coeff_bf16=True, basis=basis)
    cls, asm = tsolver._setup(grid, scene, params)
    return grid, scene, params, cls, asm


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 8])
@pytest.mark.parametrize("basis", [BasisOrder.QUADRATIC, BasisOrder.AFFINE], ids=["K10", "K4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_bf16_kernels_match_twins(dtype, basis, T):
    _require_cuda()
    grid, _, params, cls, asm = _setup(dtype, T, basis)
    c = tpa.pack_coeffs(asm, cls, storage_dtype=BF)
    cu = tpa.pack_coeffs(asm, storage_dtype=BF)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    assert c.dtype == cu.dtype == red.dtype == BF
    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = tpa.packed_masks(cls, dtype)

    def rnd():
        return (torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype) * mask).contiguous()

    x, r, p, og = rnd(), rnd(), rnd(), rnd()
    f = tpa.pack_arrow_factors(tsolver.precond_factors_packed(grid, cls, asm, params))
    alpha = torch.tensor(0.37, device="cuda", dtype=dtype)
    v = algebra(tpa.moments_packed_plain(x, c, T, basis))
    assert v.shape[2] == 3 * n_monomials(basis)
    u = tpa.expand_packed_plain(v, red, T, basis)
    s = tpa.forward_s_packed_plain(x, c)
    cases = [
        ("moments", lambda: tpa.moments_packed(x, c, T, basis), lambda: tpa.moments_packed_plain(x, c, T, basis)),
        ("expand", lambda: tpa.expand_packed(v, red, T, basis), lambda: tpa.expand_packed_plain(v, red, T, basis)),
        ("grid_mom_pap", lambda: tpa.grid_mom_pap_packed(x, c, T, basis),
         lambda: tpa.grid_mom_pap_packed_plain(x, c, T, basis)),
        ("exp_finish_update", lambda: tpa.exp_finish_update_packed(x, r, p, alpha, c, og, v, T, f, "arrow", basis=basis),
         lambda: tpa.exp_finish_update_packed_plain(x, r, p, alpha, c, og, v, T, f, "arrow", basis)),
    ]
    if basis == BasisOrder.QUADRATIC:
        cases += [
            ("apply_reduced", lambda: tpa.apply_reduced_packed(x, c, u), lambda: tpa.apply_reduced_packed_plain(x, c, u)),
            ("finish", lambda: tpa.finish_packed(c, og, u), lambda: tpa.finish_packed_plain(c, og, u)),
            ("apply_uniform_pap", lambda: tpa.apply_uniform_pap_packed(x, cu),
             lambda: tpa.apply_uniform_pap_packed_plain(x, cu)),
            ("apply_uniform", lambda: tpa.apply_uniform_packed(x, cu), lambda: tpa.apply_uniform_packed_plain(x, cu)),
            ("transpose_u", lambda: tpa.transpose_u_packed(c, u), lambda: tpa.transpose_u_packed_plain(c, u)),
            ("finish_update", lambda: tpa.finish_update_packed(x, r, p, alpha, c, og, u, f, "arrow"),
             lambda: tpa.finish_update_packed_plain(x, r, p, alpha, c, og, u, f, "arrow")),
            ("forward_s", lambda: tpa.forward_s_packed(x, c), lambda: tpa.forward_s_packed_plain(x, c)),
            ("combine", lambda: tpa.combine_packed(x, c, s, u), lambda: tpa.combine_packed_plain(x, c, s, u)),
        ]
    for name, kernel, twin in cases:
        before = dict(tpa.LAUNCHES)
        got, ref = kernel(), twin()
        torch.cuda.synchronize()
        # one launch of the bf16 form, none of the compute-dtype form
        assert tpa.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1 and tpa.LAUNCHES[name] == before[name], name
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for i, (g, rr) in enumerate(zip(got, ref)):
            assert g.dtype == dtype and g.shape == rr.shape, name
            if name in ("grid_mom_pap", "apply_uniform_pap") and i == len(got) - 1:
                g, rr = g.double().sum(), rr.double().sum()  # partials of other granularity
            assert float((g - rr).abs().max()) <= RTOL[dtype] * float(rr.abs().max()), (name, i)


@pytest.mark.cuda
def test_bf16_apply_symmetric_and_close():
    _require_cuda()
    grid, _, params, cls, asm = _setup(torch.float32, 16)
    R = effective_max_regions(grid, params)
    a16 = tsolver.make_apply_packed(grid, cls, asm, params, R)
    a32 = tsolver.make_apply_packed(grid, cls, asm, params.replace(coeff_bf16=False), R)
    gen = torch.Generator(device="cuda").manual_seed(6)
    mask = tpa.packed_masks(cls, torch.float32)
    x, y = ((torch.randn((7,) + grid.res, generator=gen, device="cuda") * mask).contiguous() for _ in range(2))
    ax16, ax32 = a16(x), a32(x)
    assert float((ax16 - ax32).abs().max()) < 0.03 * float(ax32.abs().max())
    lhs, rhs = float((y.double() * ax16.double()).sum()), float((x.double() * a16(y).double()).sum())
    assert abs(lhs - rhs) < 1e-4 * max(abs(lhs), 1.0)


@pytest.mark.cuda
def test_bf16_step_repeats_and_matches_the_cpu():
    _require_cuda()
    grid, scene, params, _, _ = _setup(torch.float32, 16)
    runs = [tsolver.step(grid, scene, params) for _ in range(2)]
    for _, _, st in runs:
        assert st["converged"] and st["boundary_active"] == 0
    assert runs[0][2]["iterations"] == runs[1][2]["iterations"]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    g_cpu, s_cpu = honey_coil(n=32, dtype=torch.float32, device="cpu")
    v_cpu, _, st_cpu = tsolver.step(g_cpu, s_cpu, params)
    assert st_cpu["converged"]
    vmax = max(float(a.abs().max()) for a in v_cpu)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(runs[0][0], v_cpu)) <= VEL_ATOL * vmax
