"""The launch planners of the plane-window and expand kernels
(packed_apply.grid_mom_plan, which the moments kernel shares with
grid_mom_pap; uniform_plan, which the reduced apply shares with the uniform
apply; expand_plan) on the CPU: every geometry they pick is one the kernels
take (csrc/fused_apply.cu plane_window, csrc/packed_apply.cu expand), the
per-block moments of a planned column have the layout the wrappers sum,
and the uniform twin's partials have the layout of the uniform kernel's
blocks."""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa


@pytest.mark.parametrize("T", list(range(1, 41)) + [48, 64, 96, 128, 256, 512])
def test_grid_mom_plan_is_valid(T):
    """The column divides the cube and fits the kernel's block; a cube is
    one block wherever its plane fits one."""
    by, bz = tpa.grid_mom_plan(T)
    assert T % by == 0 and T % bz == 0
    assert by * bz <= tpa.KERNEL_THREADS
    assert ((by, bz) == (T, T)) == (T * T <= tpa.KERNEL_THREADS)


@pytest.mark.parametrize("T", range(1, 41))
def test_moment_kernels_parts_of_the_planned_column(T):
    """The moments and grid_mom_pap kernels write one slice of moments per
    block of a cube: none to sum where the planned column is the whole
    plane, else (T / by) * (T / bz) slices that tile the plane."""
    by, bz = tpa.grid_mom_plan(T)
    lead = tpa._cube_parts(T, by, bz)
    if T * T <= tpa.KERNEL_THREADS:
        assert lead == ()
    else:
        assert lead == ((T // by) * (T // bz),) and lead[0] > 1 and lead[0] * by * bz == T * T


@pytest.mark.parametrize("T, want", [(4, (4, 4)), (6, (6, 6)), (8, (8, 8)), (16, (16, 16)), (20, (10, 20)),
                                     (24, (8, 24)), (32, (8, 32)), (64, (4, 64)), (512, (1, 256))])
def test_grid_mom_plan_prefers_whole_planes(T, want):
    """One block per cube up to T16, the widest z run first."""
    assert tpa.grid_mom_plan(T) == want


@pytest.mark.parametrize("res, T, itemsize, aligned, vec", [
    ((128, 128, 128), 16, 4, True, 4), ((128, 128, 128), 16, 8, True, 2),
    ((32, 48, 64), 16, 4, True, 4), ((24, 24, 24), 6, 4, True, 1), ((24, 24, 24), 6, 8, True, 2),
    ((30, 30, 30), 5, 4, True, 1), ((128, 128, 128), 16, 4, False, 1), ((32, 32, 2), 2, 4, True, 1),
])
def test_expand_plan(res, T, itemsize, aligned, vec):
    """16-byte runs where nz, the tile and the alignment allow, else one slot;
    the block fits and covers its rows."""
    got_vec, bx, by = tpa.expand_plan(res, T, itemsize, aligned)
    assert got_vec == vec
    assert res[2] % vec == 0 and T % vec == 0
    assert 1 <= bx <= res[2] // vec and 1 <= by <= res[1] and bx * by <= tpa.KERNEL_THREADS


def test_wrappers_take_the_twin_on_cpu():
    """On CPU tensors the wrappers of the reduced apply's kernels return the
    twins' results and launch nothing."""
    g = torch.Generator().manual_seed(0)
    res, T = (8, 8, 16), 8
    x = torch.randn((7,) + res, generator=g, dtype=torch.float64)
    c = torch.rand((tpa.N_COEFF,) + res, generator=g, dtype=torch.float64)
    v = torch.randn((1, 1, 30, 2), generator=g, dtype=torch.float64)  # 3K rows, K = 10 (the default quadratic basis)
    u = torch.randn((3,) + res, generator=g, dtype=torch.float64)
    before = dict(tpa.LAUNCHES)
    got = tpa.grid_mom_pap_packed(x, c, T)
    ref = tpa.grid_mom_pap_packed_plain(x, c, T)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(tpa.expand_packed(v, c[tpa.C_RED:], T), tpa.expand_packed_plain(v, c[tpa.C_RED:], T))
    assert torch.equal(tpa.moments_packed(x, c, T), tpa.moments_packed_plain(x, c, T))
    assert torch.equal(tpa.apply_reduced_packed(x, c, u), tpa.apply_reduced_packed_plain(x, c, u))
    assert tpa.LAUNCHES == before


UNIFORM_RES = [(128, 128, 128), (32, 32, 32), (32, 48, 64), (17, 23, 29), (5, 7, 9), (1, 1, 1), (2, 3, 5),
               (31, 37, 41), (127, 61, 13), (256, 256, 256), (16, 16, 2), (3, 256, 1)]


@pytest.mark.parametrize("res", UNIFORM_RES, ids=["x".join(map(str, r)) for r in UNIFORM_RES])
def test_uniform_plan_is_valid(res):
    """The column fits the kernel's block and the resolution, the blocks
    cover the grid with less than one column or run to spare, and the plan
    is cached."""
    by, bz, run = tpa.uniform_plan(res)
    assert by >= 1 and bz >= 1 and run >= 1 and by * bz <= tpa.KERNEL_THREADS
    assert by <= res[1] and bz <= res[2] and run <= res[0]
    for n, b in zip(res, (run, by, bz)):
        blocks = -(-n // b)
        assert blocks * b >= n > (blocks - 1) * b
    assert tpa.uniform_plan(res) is tpa.uniform_plan(res)


@pytest.mark.parametrize("res", [(16, 16, 16), (17, 23, 29), (5, 7, 9), (33, 18, 40)],
                         ids=["16", "17x23x29", "5x7x9", "33x18x40"])
def test_uniform_pap_twin_partials_layout(res):
    """One partial per block of the plan, in (run, y column, z column)
    order: each is the sum of x * A x over its block, and they add up to
    <x, A x> of the unfused twin to round-off."""
    g = torch.Generator().manual_seed(sum(res))
    x = torch.randn((7,) + res, generator=g, dtype=torch.float64)
    c = torch.rand((tpa.N_COEFF_UNIFORM,) + res, generator=g, dtype=torch.float64)
    out, partials = tpa.apply_uniform_pap_packed_plain(x, c)
    ref = tpa.apply_uniform_packed_plain(x, c)
    assert torch.equal(out, ref)
    by, bz, run = tpa.uniform_plan(res)
    nb = [-(-n // b) for n, b in zip(res, (run, by, bz))]
    assert partials.shape == (nb[0] * nb[1] * nb[2],)
    dots = (x * ref).sum(dim=0)
    tol = 1e-12 * float(dots.abs().sum())
    for b0, b1, b2 in ((0, 0, 0), (nb[0] - 1, nb[1] - 1, nb[2] - 1), (nb[0] // 2, nb[1] - 1, 0)):
        box = dots[b0 * run:(b0 + 1) * run, b1 * by:(b1 + 1) * by, b2 * bz:(b2 + 1) * bz]
        assert abs(float(partials[(b0 * nb[1] + b1) * nb[2] + b2] - box.sum())) <= tol
    assert float(partials.sum()) == pytest.approx(float(dots.sum()), rel=1e-12)


def test_uniform_wrappers_take_the_twin_on_cpu():
    """On CPU tensors the uniform wrappers return the twins' results, with
    the 14- and the 17-channel stack, and launch nothing."""
    g = torch.Generator().manual_seed(1)
    res = (9, 10, 11)
    x = torch.randn((7,) + res, generator=g, dtype=torch.float64)
    c = torch.rand((tpa.N_COEFF,) + res, generator=g, dtype=torch.float64)
    before = dict(tpa.LAUNCHES)
    for coeffs in (c, c[:tpa.N_COEFF_UNIFORM].contiguous()):
        assert torch.equal(tpa.apply_uniform_packed(x, coeffs), tpa.apply_uniform_packed_plain(x, coeffs))
        got, ref = tpa.apply_uniform_pap_packed(x, coeffs), tpa.apply_uniform_pap_packed_plain(x, coeffs)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tpa.LAUNCHES == before
