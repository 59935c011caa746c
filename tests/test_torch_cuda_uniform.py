"""The uniform apply kernels (apply_uniform, apply_uniform_pap: the plane
window of csrc/fused_apply.cu) against their plain twins on a card (marker
``cuda``; each test skips without CUDA): random 14- and 17-channel stacks
at resolutions the planned column divides and at ones it does not, other
geometries, the solid-cut floor, two launches bit-equal, and geometries
the kernel cannot take.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_uniform.py -m cuda --noconftest -q
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa

# f32: sums of up to by * bz * L terms in another order than the twin; fp64 likewise
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
KERNELS = pytest.mark.parametrize("pap", [False, True], ids=["apply_uniform", "apply_uniform_pap"])


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _random_case(res, channels, dtype, seed):
    """A random coefficient stack and solve vector, made on the CPU from a
    seed and moved to the card."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((channels,) + res, generator=g, dtype=dtype)
    x = torch.randn((7,) + res, generator=g, dtype=dtype)
    return x.contiguous().cuda(), c.contiguous().cuda()


def _twin(x, c, pap):
    return tpa.apply_uniform_pap_packed_plain(x, c) if pap else tpa.apply_uniform_packed_plain(x, c)


def _close(label, got, ref, dtype):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (label, i)
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        assert scale > 0 and err <= RTOL[dtype] * scale, (label, i, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(32, 32, 32), (32, 48, 64), (17, 23, 29), (5, 7, 9)],
                         ids=["32", "32x48x64", "17x23x29", "5x7x9"])
@pytest.mark.parametrize("channels", [tpa.N_COEFF_UNIFORM, tpa.N_COEFF], ids=["14ch", "17ch"])
@KERNELS
@DTYPES
def test_uniform_kernel_matches_twin(res, channels, pap, dtype):
    """One launch at the planned geometry: A x, and the partials in the
    plan's layout, against the twin."""
    _require_cuda()
    x, c = _random_case(res, channels, dtype, seed=sum(res) + channels)
    name = "apply_uniform_pap" if pap else "apply_uniform"
    before = tpa.LAUNCHES[name]
    got = tpa.apply_uniform_pap_packed(x, c) if pap else tpa.apply_uniform_packed(x, c)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES[name] == before + 1
    _close(name, got, _twin(x, c, pap), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("by, bz, run", [(16, 16, 16), (8, 32, 16), (16, 16, 32), (8, 32, 32), (7, 5, 4),
                                         (1, 16, 1), (2, 1, 3)])
@DTYPES
def test_uniform_geometries_match_twin(by, bz, run, dtype):
    """Geometries the planner may or may not pick, on a grid none of them
    divides in every axis: a one-row column, a two-thread one (more ring work
    than threads) and one-plane runs; the summed partials against <x, A x>."""
    _require_cuda()
    x, c = _random_case((17, 23, 29), tpa.N_COEFF_UNIFORM, dtype, seed=by * 100 + bz + run)
    ref = tpa.apply_uniform_packed_plain(x, c)
    assert tpa.window_occupancy("apply_uniform_pap", dtype, by, bz)[1] >= 1
    _close(f"apply_uniform {by}x{bz}x{run}", tpa._apply_uniform_cuda(x, c, by, bz, run, pap=False), ref, dtype)
    out, partials = tpa._apply_uniform_cuda(x, c, by, bz, run, pap=True)
    blocks = -(-17 // run) * -(-23 // by) * -(-29 // bz)
    assert partials.shape == (blocks,)
    _close(f"apply_uniform_pap {by}x{bz}x{run}", (out, partials.double().sum()), (ref, (x * ref).double().sum()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("by, bz, run", [(16, 32, 16), (32, 16, 8), (257, 1, 4)])
@KERNELS
def test_uniform_refuses_bad_geometries(by, bz, run, pap):
    """A column above the kernel's 256 threads is refused at launch and
    raises."""
    _require_cuda()
    x, c = _random_case((32, 32, 32), tpa.N_COEFF_UNIFORM, torch.float32, seed=3)
    with pytest.raises(RuntimeError):
        tpa._apply_uniform_cuda(x, c, by, bz, run, pap=pap)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(32, 32, 64), (17, 23, 29)], ids=["32x32x64", "17x23x29"])
@DTYPES
def test_uniform_kernels_repeat_bit_equal(res, dtype):
    """Two launches on one input give bit-equal A x and partials."""
    _require_cuda()
    x, c = _random_case(res, tpa.N_COEFF_UNIFORM, dtype, seed=7)
    first, second = tpa.apply_uniform_pap_packed(x, c), tpa.apply_uniform_pap_packed(x, c)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(tpa.apply_uniform_packed(x, c), tpa.apply_uniform_packed(x, c))


@pytest.mark.cuda
@KERNELS
@DTYPES
def test_uniform_kernels_on_solid_floor(pap, dtype):
    """Both kernels against their twins on the solid-cut floor at 32^3, with
    its real coefficients (the transpose's own ffw factor at the cut faces),
    as the 14-channel stack and as the 17-channel one."""
    _require_cuda()
    from test_torch_cuda import _solid_setup

    grid, _, cls, asm = _solid_setup(dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((7,) + grid.res, generator=gen, device="cuda", dtype=dtype)
    x = (x * tpa.packed_masks(cls, dtype)).contiguous()
    for coeffs in (tpa.pack_coeffs(asm), tpa.pack_coeffs(asm, cls)):
        got = tpa.apply_uniform_pap_packed(x, coeffs) if pap else tpa.apply_uniform_packed(x, coeffs)
        _close(f"uniform solid {coeffs.shape[0]}ch", got, _twin(x, coeffs, pap), dtype)
