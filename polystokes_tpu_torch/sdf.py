"""Analytic signed-distance fields (negative inside) and their sampling at
cell centers, as in ``polystokes_tpu.sdf``.  Positions are world units
(cell units times dx); each builder returns ``f(x, y, z) -> sdf`` on
broadcastable tensors."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .grid import coord_grids


def _stack(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def _sum3(v):
    """Sum over a trailing axis of 3 in sequential order, as XLA reduces it."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _sqrt(v):
    """Correctly rounded square root.  PyTorch's vectorised CPU kernel is
    one ulp off on some float64 inputs (numpy's, XLA's and CUDA's are
    exact), which would make the sampled scenes differ from the JAX
    package's in the last bit."""
    if v.device.type == "cpu":
        return torch.as_tensor(np.sqrt(v.numpy()))
    return torch.sqrt(v)


def _vec(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def sphere(center, radius) -> Callable:
    cx, cy, cz = center

    def f(x, y, z):
        return _sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) - radius

    return f


def box(lo, hi) -> Callable:
    """Axis-aligned box SDF (exact outside and inside)."""

    def f(x, y, z):
        p = _stack(x, y, z)
        lo_t, hi_t = _vec(lo, p), _vec(hi, p)
        c = (lo_t + hi_t) / 2.0
        b = (hi_t - lo_t) / 2.0
        q = torch.abs(p - c) - b
        outside = _sqrt(_sum3(torch.clamp(q, min=0.0) ** 2))
        inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
        return outside + inside

    return f


def plane(normal, offset) -> Callable:
    """Half-space: negative where dot(n, p) < offset."""

    def f(x, y, z):
        n = _vec(normal, x)
        n = n / _sqrt(_sum3(n * n))
        return n[0] * x + n[1] * y + n[2] * z - offset

    return f


def capsule(a, b, radius) -> Callable:
    def f(x, y, z):
        p = _stack(x, y, z)
        a_t, b_t = _vec(a, p), _vec(b, p)
        pa = p - a_t
        ba = b_t - a_t
        h = torch.clamp(_sum3(pa * ba) / _sum3(ba * ba), 0.0, 1.0)
        d = pa - h[..., None] * ba
        return _sqrt(_sum3(d * d)) - radius

    return f


def torus(center, major_radius, minor_radius, axis: int = 1) -> Callable:
    """Torus around ``axis`` through ``center``: the honey-coil shape."""
    perp = [a for a in range(3) if a != axis]

    def f(x, y, z):
        p = _stack(x, y, z)
        p = p - _vec(center, p)
        q_r = _sqrt(p[..., perp[0]] ** 2 + p[..., perp[1]] ** 2) - major_radius
        return _sqrt(q_r**2 + p[..., axis] ** 2) - minor_radius

    return f


def union(*fs: Callable) -> Callable:
    def f(x, y, z):
        out = fs[0](x, y, z)
        for g in fs[1:]:
            out = torch.minimum(out, g(x, y, z))
        return out

    return f


def intersection(*fs: Callable) -> Callable:
    def f(x, y, z):
        out = fs[0](x, y, z)
        for g in fs[1:]:
            out = torch.maximum(out, g(x, y, z))
        return out

    return f


def complement(g: Callable) -> Callable:
    return lambda x, y, z: -g(x, y, z)


def constant(value: float) -> Callable:
    """The field ``value`` everywhere, in the coordinates' dtype and device."""
    return lambda x, y, z: torch.full(torch.broadcast_shapes(x.shape, y.shape, z.shape), value, dtype=x.dtype,
                                      device=x.device)


def sample_at_centers(f: Callable, res, dx: float, dtype, device) -> torch.Tensor:
    """Sample a world-space SDF callable at cell centers -> (nx,ny,nz)."""
    xs, ys, zs = coord_grids(res, (0.0, 0.0, 0.0), dtype, device)
    return f(xs * dx, ys * dx, zs * dx).to(dtype).expand(*res).contiguous()
