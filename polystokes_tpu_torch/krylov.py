"""Preconditioned CG with the reference's semantics (lib/include/pcg.h:
269-340, ``pcg_external_matrix_A``), as in ``polystokes_tpu.krylov``:
convergence when rre = min(||r||^2, ||r||^2 / ||x||^2) < tol^2, and the
iteration count 0-based (the reference's ``return i``).

Vectors are packed tensors; the loop runs on their device and the host
reads ``done`` once per iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def _dot(a, b):
    return torch.sum(a * b)


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    error: float  # sqrt of the reference's rre
    converged: bool
    applies: int  # operator applications: init plus one per loop pass


class PCGCarry(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rsold: torch.Tensor
    k: int
    rre: torch.Tensor
    done: bool


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
    done = bool(_dot(r, r) == 0)
    rre0 = torch.tensor(0.0 if done else float("inf"), dtype=rsold.dtype, device=rsold.device)
    return PCGCarry(x=x0, r=r, p=z, rsold=rsold, k=0, rre=rre0, done=done)


def pcg_segment(apply_A: Callable, carry: PCGCarry, precond: Callable = None, tol: float = 1e-3, max_iters: int = 5000,
                apply_dot: Callable = None) -> PCGCarry:
    """Iterate until convergence or ``max_iters`` total iterations.
    ``apply_dot(p) -> (A p, <p, A p>)``, when given, replaces the apply and
    the pAp dot (the fused kernels of ``fuse_pap``)."""
    if precond is None:
        precond = lambda r: r  # noqa: E731
    x, r, p, rsold, k, rre, done = carry
    while not done and k < max_iters:
        if apply_dot is not None:
            Ap, pAp = apply_dot(p)
        else:
            Ap = apply_A(p)
            pAp = _dot(p, Ap)
        alpha = rsold / torch.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rre = _rre(_dot(r, r), _dot(x, x))
        z = precond(r)
        rs = _dot(r, z)
        p = (rs / rsold) * p + z
        rsold = rs
        k += 1
        done = bool(rre < tol * tol)
    return PCGCarry(x=x, r=r, p=p, rsold=rsold, k=k, rre=rre, done=done)


def pcg_result(carry: PCGCarry) -> KrylovResult:
    iters = max(carry.k - 1, 0) if carry.done else carry.k
    return KrylovResult(x=carry.x, iterations=iters, error=float(torch.sqrt(carry.rre)),
                        converged=carry.done, applies=1 + carry.k)


def pcg(apply_A: Callable, b, x0, precond: Callable = None, tol: float = 1e-3, max_iters: int = 5000,
        apply_dot: Callable = None) -> KrylovResult:
    """Preconditioned CG; iterations are 0-based at convergence, max_iters
    when not converged.  ``pcg_init`` always uses ``apply_A``; the loop uses
    ``apply_dot`` when given."""
    carry = pcg_init(apply_A, b, x0, precond)
    return pcg_result(pcg_segment(apply_A, carry, precond, tol=tol, max_iters=max_iters, apply_dot=apply_dot))
