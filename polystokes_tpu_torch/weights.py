"""Cut-cell integration weights at the 7 MAC sampling families, as in
``polystokes_tpu.weights``: each weight is the fraction of the 2x2x2
supersample points (offsets +-0.25 cell units) at which the trilinearly
interpolated center-sampled SDF is inside.  Every supersample sits at a
constant fractional offset from the lattice, so the interpolation is a
fixed-coefficient shift stencil with edge-clamped borders."""
from __future__ import annotations

from typing import Tuple

import torch

from .grid import Grid, edge_offsets, face_offsets


def _interp_axis(a: torch.Tensor, axis: int, family_off: float, sub: float) -> torch.Tensor:
    """Interpolate along ``axis`` to positions ``i + family_off + sub``;
    output length n (family_off 0) or n + 1 (family_off -0.5)."""
    c = family_off + sub
    n = a.shape[axis]
    first = a.narrow(axis, 0, 1)
    last = a.narrow(axis, n - 1, 1)
    ap = torch.cat([first, a, last], dim=axis)  # ap[i] == a[i-1], edge mode
    out_len = n + 1 if family_off == -0.5 else n
    base = -1 if c < 0 else 0
    frac = c - base
    lo = ap.narrow(axis, 1 + base, out_len)
    hi = ap.narrow(axis, 2 + base, out_len)
    return (1.0 - frac) * lo + frac * hi


def _supersampled_inside_fraction(sdf_c: torch.Tensor, offsets: Tuple[float, float, float], inside_test, dtype) -> torch.Tensor:
    acc = None
    for sx in (-0.25, 0.25):
        ax = _interp_axis(sdf_c, 0, offsets[0], sx)
        for sy in (-0.25, 0.25):
            axy = _interp_axis(ax, 1, offsets[1], sy)
            for sz in (-0.25, 0.25):
                val = _interp_axis(axy, 2, offsets[2], sz)
                ins = inside_test(val).to(dtype)
                acc = ins if acc is None else acc + ins
    return acc * 0.125


def _family_offsets():
    offs = {"center": (0.0, 0.0, 0.0)}
    for a in range(3):
        offs[f"face{a}"] = face_offsets(a)
    for e in range(3):
        offs[f"edge{e}"] = edge_offsets(e)
    return offs


def compute_weights(grid: Grid, surface_sdf: torch.Tensor, collision_sdf: torch.Tensor, dtype=torch.float32):
    """Liquid and fluid weights at all 7 sampling families.

    Returns (liquid, fluid): dicts keyed 'center', 'face0'..'face2',
    'edge0'..'edge2'."""
    liquid, fluid = {}, {}
    s = surface_sdf.to(dtype)
    c = collision_sdf.to(dtype)
    for name, off in _family_offsets().items():
        liquid[name] = _supersampled_inside_fraction(s, off, lambda v: v < 0, dtype)
        fluid[name] = _supersampled_inside_fraction(c, off, lambda v: v >= 0, dtype)
    return liquid, fluid
