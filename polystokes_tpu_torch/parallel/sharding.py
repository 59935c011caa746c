"""Meshes of devices and the sharded step, the counterpart of
``polystokes_tpu.parallel.sharding``.

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh``, and GSPMD partitions the step over it.  Here one
process drives a ``Mesh`` given as a list of ``torch.device`` laid out
over named axes; a device may repeat (n slabs on one card, or on the CPU),
as JAX's virtual CPU devices do.  The scene and the setup stay on the
mesh's first device.  A solve that ``pallas_shardable`` admits runs its
packed apply as x-slabs over the mesh (``shard_apply``); the port has no
partitioner for any other solve, which runs whole on the first device
(ROADMAP.md Queue 3, divergence 8).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` (``torch.device``, row-major) laid out over the axes
    ``axis_names`` of sizes ``dims``; ``shape`` maps each axis to its size,
    as a JAX mesh's does."""

    devices: tuple
    axis_names: tuple
    dims: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis``, in order, where every other axis has
        size 1."""
        if any(n > 1 for a, n in zip(self.axis_names, self.dims) if a != axis):
            raise ValueError(f"mesh {self.shape}: axis {axis!r} is not its only axis above size 1")
        return self.devices


def _device(d) -> torch.device:
    """d as a torch.device with its index (the current card for a bare "cuda")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None, axes=("x", "y")) -> Mesh:
    """A mesh of ``devices`` (default: every CUDA device), one axis for one
    axis name, else two, n factored as squarely as it goes (px <= sqrt(n)
    dividing n: (px, n / px)), as the JAX package's ``make_mesh``."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; name the devices")
    devices = tuple(_device(d) for d in devices)
    n = len(devices)
    if len(axes) == 1:
        return Mesh(devices, tuple(axes), (n,))
    px = math.isqrt(n)
    while n % px:
        px -= 1
    return Mesh(devices, tuple(axes), (px, n // px))


def _data_axes(mesh: Mesh) -> list:
    """The mesh axes that actually partition data (size > 1)."""
    return [a for a in mesh.axis_names if mesh.shape[a] > 1]


def scene_shardings(mesh: Mesh):
    """The device of each field of a ``solver.Scene`` on the mesh: its first
    device, where the setup runs, for every field (JAX shards the cell and
    face fields over the mesh)."""
    from ..solver import Scene

    d = mesh.devices[0]
    faces = (d, d, d)
    return Scene(surface_sdf=d, collision_sdf=d, velocity=faces, collision_velocity=faces, viscosity=d, dt=d,
                 surface_weights=faces, collision_weights=faces, density=d)


def shard_scene(scene, mesh: Mesh):
    """The scene with each tensor on its device of ``scene_shardings``."""
    sh = scene_shardings(mesh)

    def put(v, d):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(t.to(e) for t, e in zip(v, d))
        return v.to(d)

    return dataclasses.replace(scene, **{f.name: put(getattr(scene, f.name), getattr(sh, f.name))
                                         for f in dataclasses.fields(scene)})


def pallas_shardable(grid, params, mesh: Mesh) -> bool:
    """Can this solve keep the packed kernels on this mesh (the x-slab path
    of ``shard_apply``)?  As the JAX package's: ``use_pallas``, a mesh whose
    data decomposition is one axis, no deflation, a pointwise
    preconditioner (IDENTITY, DIAGONAL or CELL_ARROW: REGION_ARROW's solve
    and deflation's probes go through the single-device apply), the packed
    layout (``solver._use_packed``) and a grid that ``shardable`` splits."""
    from ..config import PreconditionerType
    from ..solver import _use_packed
    from .shard_apply import shardable

    if not params.use_pallas:
        return False
    ax = _data_axes(mesh)
    if len(ax) != 1 or params.deflation:
        return False
    if params.preconditioner not in (PreconditionerType.IDENTITY, PreconditionerType.DIAGONAL,
                                     PreconditionerType.CELL_ARROW):
        return False
    return _use_packed(grid, params) and shardable(grid, params, int(mesh.shape[ax[0]]))


def check_mesh_pallas(params, mesh: Mesh, grid=None):
    """Gate ``use_pallas`` under a mesh of more than one device: keep it
    where the solve is slab-legal (``pallas_shardable``; pass ``grid``), else
    warn, with the JAX package's text, and return params with
    ``use_pallas=False``: the solve then runs the unpacked step whole on the
    mesh's first device (JAX: the GSPMD-partitioned XLA apply)."""
    if params.use_pallas and mesh.size > 1:
        if grid is not None and pallas_shardable(grid, params, mesh):
            return params
        warnings.warn(
            f"use_pallas requested under a {mesh.size}-device mesh and the solve "
            "is not shard_map-legal (needs a 1-D data decomposition, x-extent "
            "divisible into pallas-compatible slabs with whole cubes per shard, "
            "and no deflation/REGION_ARROW) — falling back to the XLA apply "
            "for the sharded solve",
            stacklevel=2,
        )
        return params.replace(use_pallas=False)
    return params


def sharded_step(grid, params, mesh: Mesh):
    """``fn(scene) -> (new_velocity, valid_masks, stats)``: the step on the
    mesh, its packed apply split along the mesh's data axis.  ``solver.step``
    gates the solve (``check_mesh_pallas``): one the x-slab path cannot take
    warns and runs the unpacked step on the mesh's first device.
    ``stats["sharded"]`` says which ran."""
    from ..solver import step

    axes = _data_axes(mesh)
    axis = axes[0] if len(axes) == 1 else mesh.axis_names[0]
    return lambda scene: step(grid, scene, params, mesh=mesh, mesh_axis=axis)
