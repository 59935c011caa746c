"""The halo forms of kernels 1, 3 and 7 and the x-slab apply on a card
(marker ``cuda``; each test skips without CUDA): each halo form against its
plain twin on the slabs of random stacks, in f32 and f64 with the stack in
the compute dtype and in bf16, K = 10 and K = 4; the slabs' outputs joined
bit-equal to the form without a halo on the whole array; the sharded apply
on 2 and 4 slabs of one card bit-equal to the unsharded apply on every
packed mode, and the sharded step bit-equal to the unsharded unfused step,
graphed, with the halo forms' launches; on a machine with two cards, the
sharded apply across them.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_shard.py -m cuda --noconftest -q
"""
import pytest
import torch

from polystokes_tpu_torch import SolverParams, packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import BasisOrder, PreconditionerType
from polystokes_tpu_torch.parallel import make_apply_packed_sharded, make_mesh, sharded_step
from polystokes_tpu_torch.scenes.builders import honey_coil

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # as test_torch_cuda_reduced.py
H = tpa.HALO_X


def _require_cuda(n=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA device{'s' if n > 1 else ''}")


def _random(res, dtype, storage, seed):
    """x, a 17-channel stack (0/1 reduced-face masks) stored in ``storage``
    and u, made on the CPU from a seed and moved to the card."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((tpa.N_COEFF,) + res, generator=g, dtype=dtype)
    c[tpa.C_RED:] = (torch.rand((3,) + res, generator=g, dtype=dtype) < 0.6).to(dtype)
    x = torch.randn((7,) + res, generator=g, dtype=dtype)
    u = torch.randn((3,) + res, generator=g, dtype=dtype)
    return x.cuda(), c.to(storage or dtype).cuda(), u.cuda()


def _slabs(t, n):
    """The n x-slabs of t with HALO_X planes on each side: the zero-padded
    whole array's windows."""
    padded = torch.nn.functional.pad(t, (0, 0, 0, 0, H, H))
    nxl = t.shape[1] // n
    return [padded[:, i * nxl:(i + 1) * nxl + 2 * H].contiguous() for i in range(n)]


def _close(label, got, ref, dtype):
    assert got.shape == ref.shape, label
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert scale > 0 and err <= RTOL[dtype] * scale, (label, err, scale)


def _forms(name, T, basis=BasisOrder.QUADRATIC):
    """(the halo form on a padded slab, its twin, the form without a halo on
    an unpadded array) of a kernel, each f(x, c, u)."""
    if name == "moments":
        return (lambda x, c, u: tpa.moments_packed(x, c, T, basis, halo=H),
                lambda x, c, u: tpa.moments_packed_plain(x, c, T, basis, halo=H),
                lambda x, c, u: tpa.moments_packed(x, c, T, basis))
    if name == "apply_reduced":
        return (lambda x, c, u: tpa.apply_reduced_packed(x, c, u, halo=H),
                lambda x, c, u: tpa.apply_reduced_packed_plain(x, c, u, halo=H),
                lambda x, c, u: tpa.apply_reduced_packed(x, c, u))
    return (lambda x, c, u: tpa.apply_uniform_packed(x, c, halo=H),
            lambda x, c, u: tpa.apply_uniform_packed_plain(x, c, halo=H),
            lambda x, c, u: tpa.apply_uniform_packed(x, c))


CASES = [("moments", BasisOrder.QUADRATIC), ("moments", BasisOrder.AFFINE), ("apply_reduced", None),
         ("apply_uniform", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [None, torch.bfloat16], ids=["stack-T", "stack-bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name, basis", CASES, ids=["moments", "moments-K4", "apply_reduced", "apply_uniform"])
def test_halo_form_matches_twin(name, basis, dtype, storage):
    """Each of 4 slabs of a random 32^3 case (tile 8) against the twin, one
    launch of <name>_halo[_bf16] a slab; the slabs joined are the form
    without a halo on the whole array bit for bit."""
    _require_cuda()
    T, n = 8, 4
    x, c, u = _random((32, 32, 32), dtype, storage, seed=len(name) + (basis == BasisOrder.AFFINE))
    kernel, twin, whole = _forms(name, T, basis)
    counter = f"{name}_halo" + ("_bf16" if storage else "")
    pieces = []
    for i, (xs, cs, us) in enumerate(zip(_slabs(x, n), _slabs(c, n), _slabs(u, n))):
        before = tpa.LAUNCHES[counter]
        got = kernel(xs, cs, us)
        torch.cuda.synchronize()
        assert tpa.LAUNCHES[counter] == before + 1
        _close(f"{name} slab {i}", got, twin(xs, cs, us), dtype)
        pieces.append(got)
    assert torch.equal(torch.cat(pieces, dim=0 if name == "moments" else 1), whole(x, c, u))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_zero_halo_is_the_plain_form(dtype):
    """One slab with a zero halo: each halo form bit-equal to the form
    without a halo, on the honey_coil 32^3 stack (tile 8)."""
    _require_cuda()
    p = SolverParams(dtype=dtype, tile_size=8, use_pallas=True, preconditioner=PreconditionerType.CELL_ARROW)
    grid, scene = honey_coil(n=32, dtype=dtype, device="cuda")
    cls, asm = tsolver._setup(grid, scene, p)
    c = tpa.pack_coeffs(asm, cls)
    x, _, u = _random(grid.res, dtype, None, seed=3)
    (xs,), (cs,), (us,) = _slabs(x, 1), _slabs(c, 1), _slabs(u, 1)
    for name in ("moments", "apply_reduced", "apply_uniform"):
        kernel, _, whole = _forms(name, 8)
        assert torch.equal(kernel(xs, cs, us), whole(x, c, u)), name


MODES = {"uniform": dict(do_reduced_regions=False), "untiled": dict(do_tile=False, max_regions=64),
         "tiled": dict(do_tile=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_apply_bit_equal_on_card(mode, n):
    """honey_coil 32^3, tile 8, f32: the apply on n slabs of cuda:0 is the
    unsharded apply bit for bit, with n launches of each halo form."""
    _require_cuda()
    p = SolverParams(dtype=torch.float32, tile_size=8, use_pallas=True, preconditioner=PreconditionerType.CELL_ARROW,
                     **MODES[mode])
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    cls, asm = tsolver._setup(grid, scene, p)
    R = effective_max_regions(grid, p)
    x = torch.randn((7,) + grid.res, generator=torch.Generator().manual_seed(n)).cuda()
    ref = tsolver.make_apply_packed(grid, cls, asm, p, R)(x)
    mesh = make_mesh(["cuda:0"] * n, axes=("x",))
    tpa.reset_launches()
    got = make_apply_packed_sharded(grid, cls, asm, p, R, mesh)(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    want = {"apply_uniform_halo": n} if mode == "uniform" else {"moments_halo": n, "expand": n, "apply_reduced_halo": n}
    assert {k: v for k, v in tpa.LAUNCHES.items() if v} == want


@pytest.mark.cuda
def test_sharded_step_bit_equal_on_card():
    """honey_coil 32^3 tiled (tile 8), f32, tol 1e-5 on 4 slabs of cuda:0:
    the unsharded unfused step's iterations and velocities bit for bit, the
    loop graphed, and 4 launches of kernels 1-3 an apply (none of 4-11)."""
    _require_cuda()
    p = SolverParams(dtype=torch.float32, tile_size=8, use_pallas=True, preconditioner=PreconditionerType.CELL_ARROW,
                     tolerance=1e-5, max_iterations=2000, bicgstab_fallback=False)
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    v1, _, s1 = tsolver.step(grid, scene, p.replace(fuse_pap=False))
    tpa.reset_launches()
    v2, _, s2 = sharded_step(grid, p, make_mesh(["cuda:0"] * 4, axes=("x",)))(scene)
    launches = {k: v for k, v in tpa.LAUNCHES.items() if v}
    assert s2["sharded"] and s2["converged"] and s2["capture_seconds"] > 0
    assert s1["iterations"] == s2["iterations"] and all(torch.equal(a, b) for a, b in zip(v1, v2))
    applies = 1 + s2["loop_passes"]
    assert launches == {"moments_halo": 4 * applies, "expand": 4 * applies, "apply_reduced_halo": 4 * applies}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "tiled"])
def test_sharded_apply_across_two_cards(mode):
    """Where the machine has two cards: the apply on a slab of each (peer
    copies of the halos and the slabs), bit-equal to the unsharded apply on
    cuda:0, and the step run eagerly, bit-equal to the unfused step."""
    _require_cuda(2)
    p = SolverParams(dtype=torch.float32, tile_size=8, use_pallas=True, preconditioner=PreconditionerType.CELL_ARROW,
                     tolerance=1e-5, max_iterations=2000, bicgstab_fallback=False, **MODES[mode])
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda:0")
    cls, asm = tsolver._setup(grid, scene, p)
    R = effective_max_regions(grid, p)
    mesh = make_mesh(["cuda:0", "cuda:1"], axes=("x",))
    x = torch.randn((7,) + grid.res, generator=torch.Generator().manual_seed(2)).cuda()
    assert torch.equal(make_apply_packed_sharded(grid, cls, asm, p, R, mesh)(x),
                       tsolver.make_apply_packed(grid, cls, asm, p, R)(x))
    v1, _, s1 = tsolver.step(grid, scene, p.replace(fuse_pap=False))
    v2, _, s2 = sharded_step(grid, p, mesh)(scene)
    assert s2["sharded"] and s2["capture_seconds"] == 0.0
    assert s1["iterations"] == s2["iterations"] and all(torch.equal(a, b) for a, b in zip(v1, v2))
