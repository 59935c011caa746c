"""The redesigned moments (WINDOW_MOM) and reduced apply (WINDOW_REDUCED)
kernels, two modes of the plane window of csrc/fused_apply.cu, against
their plain twins on a card (marker ``cuda``; each test skips without
CUDA): random 17-channel stacks at the tiles and resolutions the solver
uses and at ones the planned column does not divide, other columns and
runs, the solid-cut floor, two launches bit-equal, geometries the kernels
cannot take, and the two cross-checks that the shared march makes free:
the moments bit-equal to grid_mom_pap's at one column, and the reduced
apply with u = 0 against the uniform apply.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_reduced.py -m cuda --noconftest -q
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import BasisOrder

# f32: sums of up to T^3 terms (the moments) in another order than the
# twin, and the stencil's own round-off; fp64 likewise
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _random_case(res, dtype, seed):
    """A random 17-channel coefficient stack with 0/1 reduced-face masks, a
    solve vector and expanded face values u, made on the CPU from a seed and
    moved to the card."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((tpa.N_COEFF,) + res, generator=g, dtype=dtype)
    c[tpa.C_RED:] = (torch.rand((3,) + res, generator=g, dtype=dtype) < 0.6).to(dtype)
    x = torch.randn((7,) + res, generator=g, dtype=dtype)
    u = torch.randn((3,) + res, generator=g, dtype=dtype)
    return (t.contiguous().cuda() for t in (x, c, u))


def _close(label, got, ref, dtype):
    assert got.shape == ref.shape, label
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert scale > 0 and err <= RTOL[dtype] * scale, (label, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("res, T", [((32, 32, 32), 4), ((32, 32, 32), 8), ((32, 32, 32), 16), ((32, 32, 32), 32),
                                    ((32, 48, 64), 16), ((24, 24, 24), 6)],
                         ids=["T4", "T8", "T16", "T32", "32x48x64-T16", "T6"])
@DTYPES
def test_moments_matches_twin(res, T, dtype):
    """One launch at the planned column: one block per cube up to T16,
    several at T32, whose moments the wrapper sums."""
    _require_cuda()
    x, c, _ = _random_case(res, dtype, seed=T)
    before = tpa.LAUNCHES["moments"]
    got = tpa.moments_packed(x, c, T)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["moments"] == before + 1
    _close("moments", got, tpa.moments_packed_plain(x, c, T), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(32, 32, 32), (32, 48, 64), (17, 23, 29), (5, 7, 9)],
                         ids=["32", "32x48x64", "17x23x29", "5x7x9"])
@DTYPES
def test_apply_reduced_matches_twin(res, dtype):
    """One launch at the planned geometry, at resolutions it divides and at
    ones it does not."""
    _require_cuda()
    x, c, u = _random_case(res, dtype, seed=sum(res))
    before = tpa.LAUNCHES["apply_reduced"]
    got = tpa.apply_reduced_packed(x, c, u)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["apply_reduced"] == before + 1
    _close("apply_reduced", got, tpa.apply_reduced_packed_plain(x, c, u), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("by, bz", [(16, 16), (8, 16), (16, 8), (8, 8), (4, 16), (1, 16), (2, 1)])
@DTYPES
def test_moments_columns_match_twin(by, bz, dtype):
    """Columns the planner does not pick at T16, a one-row column and a
    two-thread one (more ring work than threads), on the non-cubic grid;
    each fits on an SM."""
    _require_cuda()
    x, c, _ = _random_case((32, 48, 64), dtype, seed=by * 100 + bz)
    assert tpa.window_occupancy("moments", dtype, by, bz)[1] >= 1
    _close(f"moments {by}x{bz}", tpa._moments_cuda(x, c, 16, by, bz), tpa.moments_packed_plain(x, c, 16), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("by, bz, run", [(16, 16, 16), (8, 32, 16), (16, 16, 32), (8, 32, 32), (7, 5, 4),
                                         (1, 16, 1), (2, 1, 3)])
@DTYPES
def test_apply_reduced_geometries_match_twin(by, bz, run, dtype):
    """Geometries the planner may or may not pick, on a grid none of them
    divides in every axis: a one-row column, a two-thread one and one-plane
    runs."""
    _require_cuda()
    x, c, u = _random_case((17, 23, 29), dtype, seed=by * 100 + bz + run)
    assert tpa.window_occupancy("apply_reduced", dtype, by, bz)[1] >= 1
    _close(f"apply_reduced {by}x{bz}x{run}", tpa._apply_reduced_cuda(x, c, u, by, bz, run),
           tpa.apply_reduced_packed_plain(x, c, u), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T, by, bz", [(32, 16, 32), (16, 3, 16), (16, 16, 6)])
def test_moments_refuses_bad_columns(T, by, bz):
    """A column above the kernel's 256 threads, or one that does not divide
    the cube, is refused at launch and raises."""
    _require_cuda()
    x, c, _ = _random_case((32, 32, 32), torch.float32, seed=3)
    with pytest.raises(RuntimeError):
        tpa._moments_cuda(x, c, T, by, bz)


@pytest.mark.cuda
@pytest.mark.parametrize("by, bz, run", [(16, 32, 16), (32, 16, 8), (257, 1, 4), (4, 64, 0)])
def test_apply_reduced_refuses_bad_geometries(by, bz, run):
    """A column above the kernel's 256 threads, or an empty run, is refused
    at launch and raises."""
    _require_cuda()
    x, c, u = _random_case((32, 32, 32), torch.float32, seed=3)
    with pytest.raises(RuntimeError):
        tpa._apply_reduced_cuda(x, c, u, by, bz, run)


@pytest.mark.cuda
@DTYPES
def test_reduced_kernels_repeat_bit_equal(dtype):
    """Two launches on one input give bit-equal moments (one block per cube
    at T16, several at T32) and reduced A x."""
    _require_cuda()
    x, c, u = _random_case((32, 32, 64), dtype, seed=7)
    for T in (16, 32):
        assert torch.equal(tpa.moments_packed(x, c, T), tpa.moments_packed(x, c, T))
    assert torch.equal(tpa.apply_reduced_packed(x, c, u), tpa.apply_reduced_packed(x, c, u))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 16])
@DTYPES
def test_reduced_kernels_on_solid_floor(T, dtype):
    """Both kernels against their twins on the solid-cut floor at 32^3, with
    the real coefficients, reduced-face masks and region algebra: the
    transpose's own ffw factor at the cut faces, u from the expanded
    moments."""
    _require_cuda()
    from test_torch_cuda import _solid_setup

    grid, params, cls, asm = _solid_setup(dtype, tile=T)
    coeffs = tpa.pack_coeffs(asm, cls)
    algebra, red = tsolver._region_algebra_packed(grid, cls, asm, params, effective_max_regions(grid, params))
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype)
    x = (x * tpa.packed_masks(cls, dtype)).contiguous()
    mom = tpa.moments_packed_plain(x, coeffs, T)
    _close("moments solid", tpa.moments_packed(x, coeffs, T), mom, dtype)
    u = tpa.expand_packed_plain(algebra(mom), red, T)
    _close("apply_reduced solid", tpa.apply_reduced_packed(x, coeffs, u), tpa.apply_reduced_packed_plain(x, coeffs, u),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T, by, bz", [(8, 8, 8), (16, 16, 16), (16, 8, 16), (16, 4, 4), (32, 8, 32)])
@DTYPES
def test_moments_bit_equal_to_grid_mom_pap(T, by, bz, dtype):
    """At one column the moments kernel and grid_mom_pap share the s
    arithmetic, the per-thread sums, block_sums' order and the wrapper's
    sum over parts: their moments are bit-equal."""
    _require_cuda()
    x, c, _ = _random_case((32, 32, 64), dtype, seed=T + by + bz)
    assert torch.equal(tpa._moments_cuda(x, c, T, by, bz), tpa._grid_mom_pap_cuda(x, c, T, by, bz)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("res, T", [((32, 32, 32), 8), ((32, 32, 32), 16), ((32, 32, 32), 32), ((24, 24, 24), 6)],
                         ids=["T8", "T16", "T32", "T6"])
@DTYPES
def test_affine_moments_match_twin_and_grid_mom_pap(res, T, dtype):
    """The K = 4 form (the affine basis: 12 moments a cube) against its
    twin at the planned column, bit-equal to grid_mom_pap's K = 4 moments,
    and equal to the first four monomials of each axis of the K = 10 form."""
    _require_cuda()
    x, c, _ = _random_case(res, dtype, seed=40 + T)
    before = tpa.LAUNCHES["moments"]
    got = tpa.moments_packed(x, c, T, BasisOrder.AFFINE)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["moments"] == before + 1 and got.shape[2] == 12
    _close("moments affine", got, tpa.moments_packed_plain(x, c, T, BasisOrder.AFFINE), dtype)
    assert torch.equal(got, tpa.grid_mom_pap_packed(x, c, T, BasisOrder.AFFINE)[1])
    quad = tpa.moments_packed(x, c, T)
    assert torch.equal(got, torch.cat([quad[:, :, 10 * a: 10 * a + 4] for a in range(3)], dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(32, 32, 32), (17, 23, 29)], ids=["32", "17x23x29"])
@pytest.mark.parametrize("geometry", [None, (7, 5, 4)], ids=["plan", "7x5x4"])
@DTYPES
def test_apply_reduced_without_u_is_apply_uniform(res, geometry, dtype):
    """With u = 0 the reduced apply is the uniform one: at one geometry the
    two modes stage the same g, h and w (w_from_s_u with u = 0 contracts to
    grid_w_from_s's rounded product), so their A x is bit-equal."""
    _require_cuda()
    x, c, u = _random_case(res, dtype, seed=sum(res) + 1)
    geo = geometry or tpa.uniform_plan(res)
    got = tpa._apply_reduced_cuda(x, c, torch.zeros_like(u), *geo)
    assert torch.equal(got, tpa._apply_uniform_cuda(x, c, *geo, pap=False))
