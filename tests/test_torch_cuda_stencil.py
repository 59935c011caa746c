"""The redesigned grid_mom_pap (plane window) and expand (division-free,
16-byte runs) kernels against their plain twins on a card (marker
``cuda``; each test skips without CUDA), at every tile the JAX package
and the suite use and beyond, on random coefficient stacks, a non-cubic
grid and the solid-cut floor.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_stencil.py -m cuda --noconftest -q
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.basis import n_monomials
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import BasisOrder

# f32: sums of up to T^3 terms in another order than the twin; fp64 likewise
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
TILES = pytest.mark.parametrize("res, T", [((32, 32, 32), 4), ((32, 32, 32), 8), ((32, 32, 32), 16),
                                           ((32, 32, 32), 32), ((32, 48, 64), 16), ((24, 24, 24), 6)],
                                ids=["T4", "T8", "T16", "T32", "32x48x64-T16", "T6"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _random_case(res, T, dtype, seed, basis=BasisOrder.QUADRATIC):
    """A random coefficient stack with 0/1 reduced-face masks, a solve
    vector and per-cube polynomial coefficients of the basis, made on the
    CPU from a seed and moved to the card."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((tpa.N_COEFF,) + res, generator=g, dtype=dtype)
    c[tpa.C_RED:] = (torch.rand((3,) + res, generator=g, dtype=dtype) < 0.6).to(dtype)
    x = torch.randn((7,) + res, generator=g, dtype=dtype)
    cs = tuple(n // T for n in res)
    v = torch.randn((cs[0], cs[1], 3 * n_monomials(basis), cs[2]), generator=g, dtype=dtype)
    return (t.contiguous().cuda() for t in (x, c, v))


def _close(label, got, ref, dtype):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (label, i)
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        assert scale > 0 and err <= RTOL[dtype] * scale, (label, i, err, scale)


@pytest.mark.cuda
@TILES
@DTYPES
def test_grid_mom_pap_matches_twin(res, T, dtype):
    """out, mom and partials against the twin, one launch, at the planned
    column: one block per cube up to T16 (f64 opts in to more than 48 KB of
    shared memory there), several at T32."""
    _require_cuda()
    x, c, _ = _random_case(res, T, dtype, seed=T)
    before = tpa.LAUNCHES["grid_mom_pap"]
    got = tpa.grid_mom_pap_packed(x, c, T)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["grid_mom_pap"] == before + 1
    _close("grid_mom_pap", got, tpa.grid_mom_pap_packed_plain(x, c, T), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("by, bz", [(16, 16), (8, 16), (4, 16), (16, 8), (8, 8), (1, 16), (2, 1)])
@DTYPES
def test_grid_mom_pap_columns_match_twin(by, bz, dtype):
    """Columns the planner does not pick at T16, a one-row column and a
    two-thread one (more ring work than threads), on the non-cubic grid;
    each fits on an SM."""
    _require_cuda()
    x, c, _ = _random_case((32, 48, 64), 16, dtype, seed=by * 100 + bz)
    assert tpa.grid_mom_pap_occupancy(dtype, by, bz)[1] >= 1
    _close(f"grid_mom_pap {by}x{bz}", tpa._grid_mom_pap_cuda(x, c, 16, by, bz),
           tpa.grid_mom_pap_packed_plain(x, c, 16), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T, by, bz", [(32, 16, 32), (16, 3, 16), (16, 16, 6)])
def test_grid_mom_pap_refuses_bad_columns(T, by, bz):
    """A column above the kernel's 256 threads, or one that does not divide
    the cube, is refused at launch and raises."""
    _require_cuda()
    x, c, _ = _random_case((32, 32, 32), T, torch.float32, seed=3)
    with pytest.raises(RuntimeError):
        tpa._grid_mom_pap_cuda(x, c, T, by, bz)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 32])
@DTYPES
def test_grid_mom_pap_repeats_bit_equal(T, dtype):
    """Two launches on one input give bit-equal out, mom and partials, with
    one block per cube (T16) and with several (T32)."""
    _require_cuda()
    x, c, _ = _random_case((32, 32, 64), T, dtype, seed=7)
    first, second = tpa.grid_mom_pap_packed(x, c, T), tpa.grid_mom_pap_packed(x, c, T)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@TILES
@DTYPES
def test_expand_matches_twin(res, T, dtype):
    """The expand kernel against its twin on the path its plan picks (16-byte
    runs but for T6 in f32), and on the one-slot path."""
    _require_cuda()
    _, c, v = _random_case(res, T, dtype, seed=T + 1)
    red = c[tpa.C_RED:].contiguous()
    ref = tpa.expand_packed_plain(v, red, T)
    before = tpa.LAUNCHES["expand"]
    _close("expand", tpa.expand_packed(v, red, T), ref, dtype)
    assert tpa.LAUNCHES["expand"] == before + 1
    u = torch.empty_like(ref)
    tpa._launch("expand", (v, red, u), (*res, T, *tpa.expand_plan(res, T, ref.element_size(), aligned=False)), dtype,
                BasisOrder.QUADRATIC)
    _close("expand one-slot", u, ref, dtype)


@pytest.mark.cuda
@TILES
@DTYPES
def test_affine_kernels_match_twins(res, T, dtype):
    """The K = 4 forms (the affine basis) of grid_mom_pap and expand
    against their twins at the planned column and plan, and expand on the
    one-slot path."""
    _require_cuda()
    basis = BasisOrder.AFFINE
    x, c, v = _random_case(res, T, dtype, seed=50 + T, basis=basis)
    before = (tpa.LAUNCHES["grid_mom_pap"], tpa.LAUNCHES["expand"])
    got = tpa.grid_mom_pap_packed(x, c, T, basis)
    torch.cuda.synchronize()
    assert got[1].shape[2] == 12
    ref = tpa.grid_mom_pap_packed_plain(x, c, T, basis)
    _close("grid_mom_pap affine", got[:2] + (got[2].double().sum(),), ref[:2] + (ref[2].double().sum(),), dtype)
    red = c[tpa.C_RED:].contiguous()
    ref = tpa.expand_packed_plain(v, red, T, basis)
    _close("expand affine", tpa.expand_packed(v, red, T, basis), ref, dtype)
    assert (tpa.LAUNCHES["grid_mom_pap"], tpa.LAUNCHES["expand"]) == (before[0] + 1, before[1] + 1)
    u = torch.empty_like(ref)
    tpa._launch("expand", (v, red, u), (*res, T, *tpa.expand_plan(res, T, ref.element_size(), aligned=False)), dtype,
                basis)
    _close("expand affine one-slot", u, ref, dtype)


@pytest.mark.cuda
@DTYPES
def test_expand_misaligned_masks_take_one_slot_path(dtype):
    """Masks that start off a 16-byte boundary (a contiguous view at an
    offset of one element) go to the one-slot path and still match."""
    _require_cuda()
    res, T = (32, 32, 32), 16
    _, c, v = _random_case(res, T, dtype, seed=11)
    store = torch.empty(3 * c[0].numel() + 1, dtype=dtype, device="cuda")
    red = store[1:].view((3,) + res)
    red.copy_(c[tpa.C_RED:])
    assert red.is_contiguous() and red.data_ptr() % 16 != 0
    _close("expand misaligned", tpa.expand_packed(v, red, T), tpa.expand_packed_plain(v, red, T), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 16])
@DTYPES
def test_redesigned_kernels_on_solid_floor(T, dtype):
    """Both kernels against their twins on the solid-cut floor at 32^3, with
    the real coefficients, reduced-face masks and region algebra."""
    _require_cuda()
    from test_torch_cuda import _solid_setup

    grid, params, cls, asm = _solid_setup(dtype, tile=T)
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype)
    x = (x * tpa.packed_masks(cls, dtype)).contiguous()
    ref = tpa.grid_mom_pap_packed_plain(x, coeffs, T)
    _close("grid_mom_pap solid", tpa.grid_mom_pap_packed(x, coeffs, T), ref, dtype)
    v = algebra(ref[1])
    _close("expand solid", tpa.expand_packed(v, red, T), tpa.expand_packed_plain(v, red, T), dtype)
