"""The packed apply as x-slabs over the devices of a mesh, the counterpart of
``polystokes_tpu.parallel.shard_apply``.

The packed [C, nx, ny, nz] vectors are split into n x-slabs of nx / n
planes, slab i on the i-th device along the mesh's axis.  The kernels reach
+-HALO_X planes along x, so each slab is given HALO_X planes from each
neighbour (zeros at the domain's ends, the zero halo of the whole array)
and the halo forms of the kernels run on it (``packed_apply``'s
``halo=HALO_X``):

  exchange x -> moments (the slab's cubes) -> region algebra (on the mesh's
  first device, on the slabs' moments joined along cube-x: the cube ->
  region sum crosses slabs, so regions may span them) -> expand (the
  slab's cubes) -> exchange u -> apply_reduced -> join

The uniform solve exchanges x and runs ``apply_uniform`` on each slab.  The
coefficient stack is split and exchanged once per builder; u every apply,
since a reduced face may sit one slot from a slab's edge in the untiled
mode.  A cube never spans two slabs (the tile divides nx / n), and each
kernel computes exactly what it computes on the whole array, so the
result is the unsharded apply's bit for bit.

The JAX package keeps the vectors sharded and exchanges with ppermute
inside shard_map; here the Krylov vectors stay whole on the mesh's first
device and each apply splits and joins them (ROADMAP.md Queue 3,
divergence 9).  A slab on another device than the vectors' is copied there
and back (peer copies between cards).
"""
from __future__ import annotations

import torch

from ..grid import Grid
from ..packed_apply import (
    HALO_X,
    apply_reduced_packed,
    apply_uniform_packed,
    expand_packed,
    moments_packed,
    pack_coeffs,
)


def shardable(grid: Grid, params, n_shards: int) -> bool:
    """Static check: can the packed apply run as ``n_shards`` x-slabs?  The
    slab's resolution (nx / n, ny, nz) must be one the packed layout takes
    (``solver._packed_layout``, the port's rule in place of JAX's
    ``pallas_compatible``: with reduced regions the tile divides nx / n,
    so a cube never spans slabs), and at least HALO_X planes deep, so that
    a neighbour's halo comes from that neighbour."""
    from ..solver import _packed_layout

    nx, ny, nz = grid.res
    if n_shards <= 1 or nx % n_shards:
        return False
    nxl = nx // n_shards
    return nxl >= HALO_X and _packed_layout((nxl, ny, nz), params)


def split(t: torch.Tensor, devices, dim: int = 1) -> list:
    """t cut into len(devices) equal pieces along ``dim``, piece i on
    devices[i] (a view where that is t's device)."""
    n = t.shape[dim] // len(devices)
    return [t.narrow(dim, i * n, n).to(d) for i, d in enumerate(devices)]


def join(pieces, device, dim: int = 1) -> torch.Tensor:
    """The pieces, in order, as one tensor on ``device``."""
    return torch.cat([p.to(device) for p in pieces], dim=dim)


def exchange_halos(slabs) -> list:
    """The port of ``_exchange_pad_local``/``_exchanged``: each [C, nxl, ny,
    nz] slab becomes [C, nxl + 2 HALO_X, ny, nz] on its own device, its
    halo planes the neighbouring slabs' edge planes (copied onto its
    device), zeros at the domain's ends."""
    def zeros(s):
        return s.new_zeros((s.shape[0], HALO_X) + tuple(s.shape[2:]))

    out = []
    for i, s in enumerate(slabs):
        lo = slabs[i - 1][:, -HALO_X:].to(s.device) if i > 0 else zeros(s)
        hi = slabs[i + 1][:, :HALO_X].to(s.device) if i + 1 < len(slabs) else zeros(s)
        out.append(torch.cat([lo, s, hi], dim=1))
    return out


def make_apply_packed_sharded(grid: Grid, cls, asm, params, R: int, mesh, axis: str = "x"):
    """The packed apply on [7, nx, ny, nz] vectors (on the mesh's first
    device) as x-slabs over the devices of ``axis``: the math of
    ``solver.make_apply_packed``, each kernel launched once a slab, the
    region algebra once on the first device."""
    from ..solver import _region_algebra_packed, _storage

    n = int(mesh.shape[axis])
    if not shardable(grid, params, n):
        raise ValueError(f"the packed apply does not split into {n} x-slabs at {grid.res} with tile "
                         f"{params.tile_size}")
    devices = mesh.axis_devices(axis)
    home = mesh.devices[0]

    reduced = params.do_reduced_regions
    coeffs = pack_coeffs(asm, cls if reduced else None, storage_dtype=_storage(params))
    coeffs_ex = exchange_halos(split(coeffs, devices))

    if not reduced:
        def apply_uniform(xp):
            xs = exchange_halos(split(xp, devices))
            return join([apply_uniform_packed(x, c, halo=HALO_X) for x, c in zip(xs, coeffs_ex)], home)

        return apply_uniform

    T, basis = params.tile_size, params.basis
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, R)
    reds = [r.contiguous() for r in split(red_packed, devices)]

    def apply_packed(xp):
        xs = exchange_halos(split(xp, devices))
        moms = [moments_packed(x, c, T, basis, halo=HALO_X) for x, c in zip(xs, coeffs_ex)]
        vs = split(algebra(join(moms, home, dim=0)), devices, dim=0)  # [cs0, cs1, 3K, cs2] by cube-x
        ups = exchange_halos([expand_packed(v, r, T, basis) for v, r in zip(vs, reds)])
        return join([apply_reduced_packed(x, c, u, halo=HALO_X) for x, c, u in zip(xs, coeffs_ex, ups)], home)

    return apply_packed
