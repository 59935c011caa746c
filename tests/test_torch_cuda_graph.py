"""The CG loop replayed from a CUDA graph against the eager loop on a card
(marker ``cuda``; each test skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_graph.py -m cuda --noconftest -q

* honey_coil 32^3, f32, tile 16, tol 1e-5, on Paths A, F (``fuse_update``),
  B_u (the uniform step with ``fuse_update``) and R (REGION_ARROW): the
  graphed ``krylov.pcg`` bit-equal to the eager one with the same k, and
  the kernel launches equal between the two;
* ``solve_chunked`` in segments of 40 bit-equal to ``step``;
* the update kernel into given x', r' buffers bit-equal to new ones;
* a capture that fails raises, and the loop does not go on eagerly.
"""
import pytest
import torch

from polystokes_tpu_torch import krylov, solve_chunked, step
from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.scenes.builders import honey_coil

# the packed CELL_ARROW path, stated since the defaults became JAX's (IDENTITY, unpacked)
PACKED_ARROW = dict(preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)

PATHS = {
    "A": dict(),
    "F": dict(fuse_update=True),
    "B_u": dict(do_reduced_regions=False, fuse_update=True),
    "R": dict(preconditioner=PreconditionerType.REGION_ARROW),
}


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _params(**kw):
    return SolverParams(do_tile=False, dtype=torch.float32, tile_size=16, max_regions=64, tolerance=1e-5, max_iterations=5000,
                        bicgstab_fallback=False, **{**PACKED_ARROW, **kw})


def _pcg(system, graph):
    apply_K, apply_dot, fused, precond, b_K, x0_K = system
    tpa.reset_launches()
    res = krylov.pcg(apply_K, b_K, x0_K, precond, tol=1e-5, max_iters=5000, apply_dot=apply_dot, fused_update=fused,
                     graph=graph)
    torch.cuda.synchronize()
    return res, dict(tpa.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_graph_bit_equal_to_eager(path):
    _require_cuda()
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    params = _params(**PATHS[path])
    cls, asm = tsolver._setup(grid, scene, params)
    system = tsolver._build_krylov_system(grid, cls, asm, scene, params)
    eager, l_eager = _pcg(system, graph=False)
    graphed, l_graph = _pcg(system, graph=True)
    assert eager.converged and graphed.converged
    assert eager.iterations > krylov.POLL_PASSES  # the graph replayed passes
    assert (graphed.iterations, graphed.passes) == (eager.iterations, eager.passes)
    assert torch.equal(graphed.x, eager.x)
    assert l_graph == l_eager and sum(l_graph.values()) > 0


@pytest.mark.cuda
def test_chunked_bit_equal_to_step_on_card():
    _require_cuda()
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    params = _params()
    vel, _, st = step(grid, scene, params)
    vel_c, _, st_c = solve_chunked(grid, scene, params, segment_iters=40)
    assert st["converged"] and st_c["iterations"] == st["iterations"]
    assert all(torch.equal(a, b) for a, b in zip(vel, vel_c))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "diag"])
def test_update_out_bit_equal(kind):
    """The update kernel writing x' and r' into given buffers (the loop's
    spare pair) gives the bits it gives into new ones."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, r, p, ap, f = (torch.randn((7, 32, 32, 32), generator=gen, device="cuda") for _ in range(5))
    f = f if kind == "diag" else None
    alpha = torch.tensor(0.3, device="cuda")
    want = tpa.cg_update_packed(x, r, p, ap, alpha, f, kind)
    out = (torch.empty_like(x), torch.empty_like(x))
    got = tpa.cg_update_packed(x, r, p, ap, alpha, f, kind, out=out)
    torch.cuda.synchronize()
    assert got[0] is out[0] and got[1] is out[1]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_capture_failure_raises():
    """An apply that reads the device on the host cannot be captured: the
    loop raises once the first (eager) poll block is done."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn((64, 64), generator=gen, device="cuda", dtype=torch.float64))
    a = (q * torch.logspace(0, 3, 64, device="cuda", dtype=torch.float64)) @ q.T
    b = torch.randn(64, generator=gen, device="cuda", dtype=torch.float64)
    calls = []

    def apply_host_read(x):
        calls.append(float(x.sum()))  # a host read: illegal while capturing
        return a @ x

    carry = krylov.pcg_init(apply_host_read, b, torch.zeros_like(b))
    loop = krylov.PCGLoop(apply_host_read, tol=1e-12, max_iters=500)
    with pytest.raises(RuntimeError):
        loop.segment(carry)
    assert loop.passes == krylov.POLL_PASSES and loop._graphs is None
