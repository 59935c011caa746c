"""The launch planners of the grid_mom_pap and expand kernels
(packed_apply.grid_mom_plan, expand_plan) on the CPU: every geometry they
pick is one the kernels take (csrc/fused_apply.cu grid_mom_pap,
csrc/packed_apply.cu expand)."""
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
    """On CPU tensors the two wrappers return the twins' results and launch
    nothing."""
    g = torch.Generator().manual_seed(0)
    res, T = (8, 8, 16), 8
    x = torch.randn((7,) + res, generator=g, dtype=torch.float64)
    c = torch.rand((tpa.N_COEFF,) + res, generator=g, dtype=torch.float64)
    v = torch.randn((1, 1, 3 * tpa.K, 2), generator=g, dtype=torch.float64)
    before = dict(tpa.LAUNCHES)
    got = tpa.grid_mom_pap_packed(x, c, T)
    ref = tpa.grid_mom_pap_packed_plain(x, c, T)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(tpa.expand_packed(v, c[tpa.C_RED:], T), tpa.expand_packed_plain(v, c[tpa.C_RED:], T))
    assert tpa.LAUNCHES == before
