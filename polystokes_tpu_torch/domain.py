"""Solve-domain cropping: the Stokes solve on the liquid's bounding box
instead of the full grid, the counterpart of ``polystokes_tpu.domain``.

The reference receives its solve domain from the host app already fitted
to the liquid (Houdini hands HDK_PolyStokes a voxel range sized to the
surface field).  The scene builders allocate a full box around the scene,
and every dense pass of the solve (the packed kernels, the
preconditioner, the CG's vector work) scales with the box volume, not the
liquid's.  Cropping restores the reference's domain fitting.

The crop is chosen on the host: its shape decides the solve's shapes.  The
axis projections of the liquid are reduced on the scene's device and three
small bool vectors go to the host.  Extents are aligned to the tile
granularity so the crop keeps the global tile anchoring of ``classify``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .config import SolverParams
from .grid import Grid
from .solver import Scene, solve_chunked


def _align_for(params: SolverParams) -> int:
    """Crop offsets and extents keep (a) 16-divisibility along every axis,
    as the JAX package's block rule asks, and (b) the global tile
    anchoring: classify anchors tiles at index 0 of the grid, so the crop
    origin sits on a tile boundary.  Tiles of 8 or 16 divide 16; larger
    tiles set the alignment."""
    t = params.tile_size if (params.do_reduced_regions and (params.do_tile or params.cube_regions)) else 16
    return max(16, t)


def active_bbox(scene: Scene, params: SolverParams, margin: int = 4, min_saving: float = 0.10):
    """(lo, hi) cell-index bounds of the liquid's bounding box, padded by
    ``margin`` cells and aligned to ``_align_for``; None when there is no
    liquid, when the domain is not aligned, or when cropping saves less
    than ``min_saving`` of the domain's volume.

    The weight stencils (2x2x2 supersampling) and the packed halo reach at
    most 2 cells past the liquid surface, so margin >= 2 keeps every active
    DOF strictly inside the crop; 4 adds slack for the packed layout's
    dropped index-0 planes."""
    res = tuple(int(n) for n in scene.surface_sdf.shape)
    align = _align_for(params)
    if any(n % align for n in res):
        return None  # unaligned domain: a crop cannot keep the kernels' shapes legal
    liquid = scene.surface_sdf < 0
    proj = [liquid.any(dim=d).any(dim=e).cpu() for d, e in ((2, 1), (2, 0), (1, 0))]
    lo, hi = [], []
    for a in range(3):
        nzs = torch.nonzero(proj[a]).flatten().tolist()
        if not nzs:
            return None
        l = max(nzs[0] - margin, 0)  # noqa: E741
        h = min(nzs[-1] + 1 + margin, res[a])
        lo.append((l // align) * align)
        hi.append(min(-(-h // align) * align, res[a]))
    vol = 1
    for l, h in zip(lo, hi):  # noqa: E741
        vol *= h - l
    if vol > (1.0 - min_saving) * res[0] * res[1] * res[2]:
        return None
    return tuple(lo), tuple(hi)


def _crop_center(t, lo, hi):
    return t[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]


def _crop_face(t, a, lo, hi):
    sl = [slice(lo[i], hi[i]) for i in range(3)]
    sl[a] = slice(lo[a], hi[a] + 1)  # face arrays carry the +1 extent
    return t[tuple(sl)]


def _crop_faces(faces, lo, hi):
    return tuple(_crop_face(faces[a], a, lo, hi) for a in range(3))


def crop_scene(grid: Grid, scene: Scene, lo, hi) -> Tuple[Grid, Scene]:
    """The scene restricted to [lo, hi): the same dx, sliced fields (the
    input face weights and the density too, where the scene has them)."""
    grid_c = Grid(res=tuple(hi[i] - lo[i] for i in range(3)), dx=grid.dx)
    rep = dict(
        surface_sdf=_crop_center(scene.surface_sdf, lo, hi),
        collision_sdf=_crop_center(scene.collision_sdf, lo, hi),
        viscosity=_crop_center(scene.viscosity, lo, hi),
        velocity=_crop_faces(scene.velocity, lo, hi),
        collision_velocity=_crop_faces(scene.collision_velocity, lo, hi),
    )
    if scene.surface_weights is not None:
        rep["surface_weights"] = _crop_faces(scene.surface_weights, lo, hi)
    if scene.collision_weights is not None:
        rep["collision_weights"] = _crop_faces(scene.collision_weights, lo, hi)
    if scene.density is not None:
        rep["density"] = _crop_center(scene.density, lo, hi)
    return grid_c, dataclasses.replace(scene, **rep)


def embed_face(full, sub, a, lo):
    """A copy of the full-domain face array ``full`` with the cropped one
    pasted at ``lo`` (JAX's ``dynamic_update_slice``)."""
    out = full.clone()
    out[tuple(slice(lo[i], lo[i] + sub.shape[i]) for i in range(3))] = sub.to(full.dtype)
    return out


def bbox_contains(outer, inner) -> bool:
    """Whether crop ``outer`` covers crop ``inner`` (both (lo, hi) pairs)."""
    return all(outer[0][a] <= inner[0][a] and inner[1][a] <= outer[1][a] for a in range(3))


def solve_cropped(grid: Grid, scene: Scene, params: SolverParams, margin: int = 4, bbox=None, **kw):
    """``solve_chunked`` (``kw`` passed on) on the liquid's bounding box,
    with the velocity and the valid masks embedded back into full-domain
    tensors on the scene's device.  Faces outside the crop keep the input
    velocity and are not valid.  Falls back to ``solve_chunked`` on the
    full grid when no crop is worthwhile.  Returns (new_velocity, valid,
    stats); stats gain "crop" with the box's lo, hi and res.

    Inside the crop the operator, right-hand side and write-back are those
    of the uncropped solve (every active DOF's stencil lies strictly
    inside).  Outside it the uncropped solve also stamps the collision
    velocity on fully solid faces and marks them valid, values nothing
    downstream reads; the reference behaves as the cropped path does.

    ``bbox`` (a previous frame's (lo, hi)) pins the crop when it still
    contains this scene's tight box (margin 2, ``min_saving=0``); a stale
    box is replaced by this scene's own."""
    if bbox is None:
        bbox = active_bbox(scene, params, margin=margin)
    else:
        # a stale box would freeze the liquid outside it
        tight = active_bbox(scene, params, margin=2, min_saving=0.0)
        if tight is None or not bbox_contains(bbox, tight):
            bbox = active_bbox(scene, params, margin=margin)
    if bbox is None:
        return solve_chunked(grid, scene, params, **kw)
    lo, hi = bbox
    grid_c, scene_c = crop_scene(grid, scene, lo, hi)
    vel_c, valid_c, stats = solve_chunked(grid_c, scene_c, params, **kw)
    new_vel = tuple(embed_face(scene.velocity[a], vel_c[a], a, lo) for a in range(3))
    valid = tuple(embed_face(torch.zeros(grid.face_shape(a), dtype=valid_c[a].dtype, device=valid_c[a].device),
                             valid_c[a], a, lo) for a in range(3))
    stats = dict(stats)
    stats["crop"] = {"lo": tuple(lo), "hi": tuple(hi), "res": grid_c.res}
    return new_vel, valid, stats
