"""MAC-grid conventions (the same as ``polystokes_tpu.grid``).

Seven sampling families: cell centers, 3 face types, 3 edge types, each a
dense tensor; sparsity is expressed with masks.

* cell center ``(i,j,k)`` sits at ``(i, j, k) * dx``
* x-face index ``(i,j,k)`` sits at ``(i - 1/2, j, k) * dx``; an axis-``a``
  face array has ``n[a]+1`` entries along ``a``
* the edge family ``e`` (offset axes ``EDGE_OFFSET_AXES[e]``) at index
  ``(i,j,k)`` sits at ``index - (e_p + e_q)/2`` and carries the shear
  stress tau_pq
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Shape3 = Tuple[int, int, int]

# Edge family e = the axis the edge runs along; its two offset axes.
EDGE_OFFSET_AXES = ((1, 2), (0, 2), (0, 1))


def face_shape(res: Shape3, axis: int) -> Shape3:
    s = list(res)
    s[axis] += 1
    return tuple(s)


def edge_shape(res: Shape3, edge_axis: int) -> Shape3:
    s = list(res)
    for a in EDGE_OFFSET_AXES[edge_axis]:
        s[a] += 1
    return tuple(s)


def face_offsets(axis: int) -> Tuple[float, float, float]:
    """Position offset (cell units) of face index (0,0,0) from cell (0,0,0)."""
    off = [0.0, 0.0, 0.0]
    off[axis] = -0.5
    return tuple(off)


def edge_offsets(edge_axis: int) -> Tuple[float, float, float]:
    off = [0.0, 0.0, 0.0]
    for a in EDGE_OFFSET_AXES[edge_axis]:
        off[a] = -0.5
    return tuple(off)


def unit(axis: int, d: int) -> Shape3:
    """The shift vector d * e_axis."""
    v = [0, 0, 0]
    v[axis] = d
    return tuple(v)


def shift(a: torch.Tensor, d: Tuple[int, ...], fill=0) -> torch.Tensor:
    """b with b[i] = a[i + d] on the last ``len(d)`` axes, out of range
    filled with ``fill`` (zero fill, never a wrap-around roll)."""
    lead = a.ndim - len(d)
    out = a
    for ax, dd in enumerate(d):
        if dd == 0:
            continue
        ax = lead + ax
        n = out.shape[ax]
        keep = out.narrow(ax, dd, n - dd) if dd > 0 else out.narrow(ax, 0, n + dd)
        pad_shape = list(out.shape)
        pad_shape[ax] = min(abs(dd), n)
        pad = torch.full(pad_shape, fill, dtype=out.dtype, device=out.device)
        if abs(dd) >= n:
            out = pad
        else:
            out = torch.cat([keep, pad] if dd > 0 else [pad, keep], dim=ax)
    return out


def pad_axis(a: torch.Tensor, axis: int, before: int, after: int, fill=0) -> torch.Tensor:
    """Constant pad of one axis (``jnp.pad`` with a single nonzero pair)."""
    parts = []
    if before:
        s = list(a.shape)
        s[axis] = before
        parts.append(torch.full(s, fill, dtype=a.dtype, device=a.device))
    parts.append(a)
    if after:
        s = list(a.shape)
        s[axis] = after
        parts.append(torch.full(s, fill, dtype=a.dtype, device=a.device))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else a


def axis_view(shape, axis: int) -> list:
    """Reshape target that puts a 1-D array along ``axis`` of a 3-D grid."""
    return [-1 if i == axis else 1 for i in range(len(shape))]


def coord_grids(shape: Shape3, offset, dtype, device):
    """Per-axis position tensors (cell units), broadcastable as (nx,1,1),
    (1,ny,1), (1,1,nz)."""
    xs = torch.arange(shape[0], dtype=dtype, device=device) + offset[0]
    ys = torch.arange(shape[1], dtype=dtype, device=device) + offset[1]
    zs = torch.arange(shape[2], dtype=dtype, device=device) + offset[2]
    return xs[:, None, None], ys[None, :, None], zs[None, None, :]


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of the MAC grid."""

    res: Shape3
    dx: float

    @property
    def nx(self):
        return self.res[0]

    @property
    def ny(self):
        return self.res[1]

    @property
    def nz(self):
        return self.res[2]

    @property
    def center_shape(self) -> Shape3:
        return self.res

    def face_shape(self, axis: int) -> Shape3:
        return face_shape(self.res, axis)

    def edge_shape(self, edge_axis: int) -> Shape3:
        return edge_shape(self.res, edge_axis)
