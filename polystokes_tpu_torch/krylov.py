"""Preconditioned CG with the reference's semantics (lib/include/pcg.h:
269-340, ``pcg_external_matrix_A``), as in ``polystokes_tpu.krylov``:
convergence when rre = min(||r||^2, ||r||^2 / ||x||^2) < tol^2, and the
iteration count 0-based (the reference's ``return i``).

Vectors are packed tensors.  The carry's k, rre and done are device
tensors, as in JAX.  The loop (``PCGLoop``) runs passes of one gated body
over buffers it owns: a pass past convergence or past the segment's bound
leaves the carry unchanged, so the host reads ``done`` only at a poll,
every ``POLL_PASSES`` passes and at the segment's bound.  On the card the
body is captured as CUDA graphs and replayed; on the CPU it runs eagerly.
Both run the same ops in the same order, so the two are bit-equal.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from .packed_apply import add_launches, captured_launches

# loop passes between two host reads of ``done``: a poll costs one
# device-to-host sync, a pass past convergence one gated (wasted) pass
POLL_PASSES = 32


def _dot(a, b):
    return torch.sum(a * b)


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    error: float  # sqrt of the reference's rre
    converged: bool
    applies: int  # operator applications: init plus one per iteration
    passes: int  # loop passes launched: the iterations and the gated passes


class PCGCarry(NamedTuple):
    """The PCG state between segments, JAX's ``PCGCarry``: k int32, rre in
    the solve's dtype and done bool, 0-dim tensors on the vectors' device."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rsold: torch.Tensor
    k: torch.Tensor
    rre: torch.Tensor
    done: torch.Tensor


def _rre(rsnew, xmag):
    ratio = torch.where(xmag > 0, rsnew / torch.where(xmag > 0, xmag, 1.0), rsnew)
    return torch.minimum(rsnew, ratio)


def pcg_init(apply_A: Callable, b, x0, precond: Callable = None) -> PCGCarry:
    """The pre-loop section of pcg_external_matrix_A."""
    if precond is None:
        precond = lambda r: r  # noqa: E731
    r = b - apply_A(x0)
    z = precond(r)
    rsold = _dot(r, z)
    # a zero right-hand side is already converged: the loop would divide 0/0
    done = _dot(r, r) == 0
    rre0 = torch.where(done, torch.zeros_like(rsold), torch.full_like(rsold, float("inf")))
    k = torch.zeros((), dtype=torch.int32, device=rsold.device)
    return PCGCarry(x=x0, r=r, p=z, rsold=rsold, k=k, rre=rre0, done=done)


class PCGLoop:
    """The CG loop of one solve, carried across segments.

    ``apply_dot(p) -> (A p, <p, A p>)``, when given, replaces the apply and
    the pAp dot (the fused kernels of ``fuse_pap``).
    ``fused_update(x, r, p, Ap, alpha, out) -> (x', r', z, <r',r'>,
    <x',x'>, <r',z>)``, when given, replaces the two axpys, the
    preconditioner and the three dots with one kernel (``fuse_update``) and
    writes x' and r' into the pair ``out``; ``precond`` is then unused
    inside the loop, and Ap may be the deferred pair the apply_dot of
    ``fuse_update`` returns.

    ``graph`` (None: when the vectors are on CUDA) replays the pass from
    CUDA graphs, captured before the second poll block of the loop's life.
    The first block runs eagerly, as real passes, so every lazy first-launch
    step (the kernel library's load, shared-memory opt-ins, cuBLAS handles)
    happens before the capture.  A capture or replay that fails raises; the
    loop does not go back to eager passes.
    ``passes`` counts the passes launched, gated ones included."""

    def __init__(self, apply_A: Callable, precond: Callable = None, tol: float = 1e-3, max_iters: int = 5000,
                 apply_dot: Callable = None, fused_update: Callable = None, graph: bool = None):
        self.apply_A = apply_A
        self.precond = (lambda r: r) if precond is None else precond  # noqa: E731
        self.tol = tol
        self.max_iters = max_iters
        self.apply_dot = apply_dot
        self.fused_update = fused_update
        self.graph = graph
        self.passes = 0
        self.capture_seconds = None  # set by the capture
        self.pool_bytes = None  # device memory the capture reserved for the graphs' pools
        self._state = None  # PCGCarry of the loop's own buffers
        self._spare = None  # (x, r) buffers the next pass writes x' and r' to
        self._k_end = None
        self._graphs = None  # a captured pass for each (x, r) pair it reads, by x's address
        self._captured = None  # kernel launches of one captured pass

    def _load(self, carry: PCGCarry, k_end: int):
        """Copy the carry into the loop's buffers (made at the first call,
        where a capture finds them) and set the bound."""
        if self._state is None:
            self._state = PCGCarry(*(t.detach().clone() for t in carry))
            self._spare = (torch.empty_like(carry.x), torch.empty_like(carry.r))
            self._k_end = torch.full((), k_end, dtype=torch.int32, device=carry.k.device)
            if self.graph is None:
                self.graph = carry.x.is_cuda
            elif self.graph and not carry.x.is_cuda:
                raise ValueError("a CUDA graph replays only CUDA tensors")
        else:
            for buf, t in zip(self._state, carry):
                buf.copy_(t)
            self._k_end.fill_(k_end)

    def _swap(self):
        """The (x, r) just written becomes the carry's; the old pair the spare."""
        xo, ro = self._spare
        self._spare = (self._state.x, self._state.r)
        self._state = self._state._replace(x=xo, r=ro)

    def _pass(self):
        """One pass of JAX's loop body, gated by ``done | (k >= k_end)``.
        A gated pass scales the step by alpha = 0, keeps p with beta = 1 and
        a zero coefficient on z, and keeps the scalars, so it leaves the
        carry unchanged; an ungated pass does the ungated body's arithmetic
        exactly.  x' and r' go to the spare pair, p and the scalars are
        updated in place."""
        x, r, p, rsold, k, rre, done = self._state
        xo, ro = self._spare
        gate = done | (k >= self._k_end)
        if self.apply_dot is not None:
            Ap, pAp = self.apply_dot(p)
        else:
            Ap = self.apply_A(p)
            pAp = _dot(p, Ap)
        alpha = torch.where(gate, 0.0, rsold / torch.where(pAp != 0, pAp, 1.0))
        if self.fused_update is not None:
            _, _, z, rr, xmag, rs = self.fused_update(x, r, p, Ap, alpha, out=(xo, ro))
        else:
            torch.add(x, alpha * p, out=xo)
            torch.sub(r, alpha * Ap, out=ro)
            rr, xmag = _dot(ro, ro), _dot(xo, xo)
            z = self.precond(ro)
            rs = _dot(ro, z)
        rre_new = _rre(rr, xmag)
        # p = (rs / rsold) p + z, with the product 1 * z exact when ungated
        p.mul_(torch.where(gate, 1.0, rs / rsold)).addcmul_((~gate).to(p.dtype), z)
        rsold.copy_(torch.where(gate, rsold, rs))
        done.copy_(torch.where(gate, done, rre_new < self.tol * self.tol))
        rre.copy_(torch.where(gate, rre, rre_new))
        k.add_((~gate).to(k.dtype))
        self._swap()

    def _capture(self):
        """Capture the pass as two CUDA graphs, one reading each (x, r) pair
        (a capture runs nothing; the two swaps leave the pairs as they
        were).  Their kernel launches are taken back out of the counters
        and added once per replay."""
        device = self._state.x.device
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()  # as torch.cuda.graph does, so the pools' growth shows
        before = torch.cuda.memory_reserved(device)
        graphs = {}
        with captured_launches() as launches:
            for _ in range(2):
                key = self._state.x.data_ptr()
                graphs[key] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[key]):
                    self._pass()
        torch.cuda.synchronize(device)
        self.pool_bytes = torch.cuda.memory_reserved(device) - before
        self.capture_seconds = time.perf_counter() - t0
        self._graphs, self._captured = graphs, {name: n // 2 for name, n in launches.items()}

    def _passes(self, n: int):
        if self._graphs is not None:
            for _ in range(n):
                self._graphs[self._state.x.data_ptr()].replay()
                self._swap()
            add_launches(self._captured, n)
        else:
            for _ in range(n):
                self._pass()
        self.passes += n

    def _carry(self) -> PCGCarry:
        """A copy of the loop's buffers: the caller never holds them."""
        return PCGCarry(*(t.clone() for t in self._state))

    def run(self, carry: PCGCarry, n: int, k_end: int) -> PCGCarry:
        """n passes from carry under the bound k_end, with no poll."""
        self._load(carry, k_end)
        self._passes(n)
        return self._carry()

    def segment(self, carry: PCGCarry, segment_iters: int = None) -> PCGCarry:
        """Iterate until convergence, ``max_iters`` total iterations or, when
        given, ``segment_iters`` more (JAX's bound k_end = min(k +
        segment_iters, max_iters)).  The host reads k and done once at the
        start and done after each block of at most POLL_PASSES passes."""
        k0, done = int(carry.k), bool(carry.done)
        k_end = self.max_iters if segment_iters is None else min(k0 + segment_iters, self.max_iters)
        self._load(carry, k_end)
        left = 0 if done else k_end - k0
        while left > 0:
            if self.graph and self._graphs is None and self.passes > 0:
                self._capture()
            n = min(POLL_PASSES, left)
            self._passes(n)
            left -= n
            if left > 0 and bool(self._state.done):
                break
        return self._carry()


def pcg_segment(apply_A: Callable, carry: PCGCarry, precond: Callable = None, tol: float = 1e-3, max_iters: int = 5000,
                segment_iters: int = None, apply_dot: Callable = None, fused_update: Callable = None,
                graph: bool = None) -> PCGCarry:
    """Run at most ``segment_iters`` iterations (all of them if None),
    stopping early on convergence or at ``max_iters`` total; one
    ``PCGLoop`` segment.  Chaining segments is bit-identical to one loop."""
    loop = PCGLoop(apply_A, precond, tol=tol, max_iters=max_iters, apply_dot=apply_dot, fused_update=fused_update,
                   graph=graph)
    return loop.segment(carry, segment_iters)


def pcg_result(carry: PCGCarry, passes: int = 0) -> KrylovResult:
    """The result of a carry, read on the host once, after the loop."""
    k, error, done = int(carry.k), float(torch.sqrt(carry.rre)), bool(carry.done)
    iters = max(k - 1, 0) if done else k
    return KrylovResult(x=carry.x, iterations=iters, error=error, converged=done, applies=1 + k, passes=passes)


def pcg(apply_A: Callable, b, x0, precond: Callable = None, tol: float = 1e-3, max_iters: int = 5000,
        apply_dot: Callable = None, fused_update: Callable = None, graph: bool = None) -> KrylovResult:
    """Preconditioned CG; iterations are 0-based at convergence, max_iters
    when not converged.  ``pcg_init`` always uses ``apply_A`` and
    ``precond``; the loop uses ``apply_dot`` and ``fused_update`` when
    given."""
    carry = pcg_init(apply_A, b, x0, precond)
    loop = PCGLoop(apply_A, precond, tol=tol, max_iters=max_iters, apply_dot=apply_dot, fused_update=fused_update,
                   graph=graph)
    return pcg_result(loop.segment(carry), loop.passes)
