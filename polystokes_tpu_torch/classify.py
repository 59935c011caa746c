"""Grid classification: material labels, boundary bands and reduced
regions, down the tiled path of ``polystokes_tpu.classify``
(``do_tile=True``: padding slabs cut the interior into tile cubes), its
untiled cube-region path (``do_tile=False``, ``cube_regions=True``) and
its uniform branch (``do_reduced_regions=False``: every fluid DOF active,
no regions).

Labels and region ids equal the JAX package's exactly: per-region arrays
only compare when the region numbering matches, so every step keeps the
JAX formulation (min-label run propagation, slots numbered in increasing
component label, lowest region id kept per cube).

Label values (lib/include/units.h:55-66): UNSOLVED, SOLID, GENERICFLUID,
ACTIVEFLUID, REDUCED and BOUNDARY (edges that are both active and
reduced).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .config import SolverParams
from .grid import EDGE_OFFSET_AXES, Grid, axis_view, pad_axis, shift, unit

UNSOLVED = 0
SOLID = 1
GENERICFLUID = 2
ACTIVEFLUID = 3
REDUCED = 4
BOUNDARY = 5

INVALID_REGION = -1

_I32_MAX = 2**31 - 1


def is_active(lbl):
    return (lbl == ACTIVEFLUID) | (lbl == BOUNDARY)


def lower_faces(face_arr, axis):
    """Center-shaped view of each cell's lower face (face index == cell)."""
    return face_arr.narrow(axis, 0, face_arr.shape[axis] - 1)


def upper_faces(face_arr, axis):
    """Center-shaped view of each cell's upper face (face index == cell + 1)."""
    return face_arr.narrow(axis, 1, face_arr.shape[axis] - 1)


def _label(mask, value, other):
    """int8 labels: ``value`` where ``mask``, else ``other``."""
    return torch.where(mask, torch.tensor(value, dtype=torch.int8, device=mask.device), other)


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Cells (reference: classifyCells, Classifier.cpp:57-128)
# ---------------------------------------------------------------------------

def classify_cells(liquid_w, fluid_w) -> torch.Tensor:
    """UNSOLVED / SOLID / GENERICFLUID from the integration weights."""
    in_solve = liquid_w["center"] > 0
    for a in range(3):
        fw = liquid_w[f"face{a}"]
        in_solve = in_solve | (lower_faces(fw, a) > 0) | (upper_faces(fw, a) > 0)
    solid = fluid_w["center"] == 0
    labels = torch.full(in_solve.shape, UNSOLVED, dtype=torch.int8, device=in_solve.device)
    labels = _label(in_solve & solid, SOLID, labels)
    return _label(in_solve & ~solid, GENERICFLUID, labels)


# ---------------------------------------------------------------------------
# Boundary bands (Classifier.cpp:292-703)
# ---------------------------------------------------------------------------

def _frontier_neighbors(frontier, liquid_w):
    """Cells face-adjacent to ``frontier`` across faces with liquid weight > 0."""
    out = torch.zeros_like(frontier)
    for a in range(3):
        fw = liquid_w[f"face{a}"]
        out = out | (shift(frontier, unit(a, -1), False) & (lower_faces(fw, a) > 0))
        out = out | (shift(frontier, unit(a, 1), False) & (upper_faces(fw, a) > 0))
    return out


def construct_air_boundary_layer(labels, liquid_w, n_layers: int):
    """Flood ACTIVEFLUID inward from the liquid/air boundary; the loop body
    runs ``n_layers - 1`` times, as the reference's (Classifier.cpp:331-361)."""
    generic = labels == GENERICFLUID
    is_unsolved = labels == UNSOLVED
    unsolved_nb = torch.zeros_like(generic)
    weight_lt1 = torch.zeros_like(generic)
    for a in range(3):
        unsolved_nb = unsolved_nb | shift(is_unsolved, unit(a, -1), False) | shift(is_unsolved, unit(a, 1), False)
        fw = liquid_w[f"face{a}"]
        weight_lt1 = weight_lt1 | (lower_faces(fw, a) < 1.0) | (upper_faces(fw, a) < 1.0)
    frontier = generic & (unsolved_nb | weight_lt1)
    for layer in range(n_layers - 1):
        labels = _label(frontier, ACTIVEFLUID, labels)
        if layer < n_layers - 2:
            frontier = (labels == GENERICFLUID) & _frontier_neighbors(frontier, liquid_w)
    return labels


def construct_solid_boundary_layer(labels, liquid_w, n_layers: int):
    """Flood ACTIVEFLUID inward from solid contact and the domain border,
    with a visited mask (Classifier.cpp:511-703)."""
    fluid_like = (labels == GENERICFLUID) | (labels == ACTIVEFLUID)
    is_solid = labels == SOLID
    near_solid = torch.zeros_like(fluid_like)
    at_border = torch.zeros_like(fluid_like)
    for a in range(3):
        near_solid = near_solid | shift(is_solid, unit(a, -1), False) | shift(is_solid, unit(a, 1), False)
        idx = _arange(labels.shape[a], labels.device)
        bord = (idx == 0) | (idx == labels.shape[a] - 1)
        at_border = at_border | bord.reshape(axis_view(labels.shape, a))
    frontier = fluid_like & (near_solid | at_border)
    visited = torch.zeros_like(frontier)
    for layer in range(n_layers):
        labels = _label(frontier, ACTIVEFLUID, labels)
        visited = visited | frontier
        if layer < n_layers - 1:
            cand = (labels == GENERICFLUID) | (labels == ACTIVEFLUID)
            frontier = ~visited & cand & _frontier_neighbors(frontier, liquid_w)
    return labels


def construct_tiles(labels, tile_size: int, tile_padding: int):
    """Slice the interior into cubes: GENERICFLUID cells whose i, j or k
    falls in [0, padding) mod tile_size become ACTIVEFLUID
    (Classifier.cpp:706-746)."""
    in_pad = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for a in range(3):
        idx = _arange(labels.shape[a], labels.device) % tile_size < tile_padding
        in_pad = in_pad | idx.reshape(axis_view(labels.shape, a))
    return _label((labels == GENERICFLUID) & in_pad, ACTIVEFLUID, labels)


def construct_reduced_regions(labels, liquid_w, params: SolverParams):
    """GENERICFLUID -> ACTIVEFLUID (bands, tiles) or REDUCED (interior);
    constructReducedRegions (Classifier.cpp:180-190)."""
    labels = construct_air_boundary_layer(labels, liquid_w, params.liquid_boundary_layer_size)
    labels = construct_solid_boundary_layer(labels, liquid_w, params.solid_boundary_layer_size)
    if params.do_tile:
        labels = construct_tiles(labels, params.tile_size, params.tile_padding)
    return _label(labels == GENERICFLUID, REDUCED, labels)


# ---------------------------------------------------------------------------
# Connected components: min-label run propagation between REDUCED cells
# whose shared face has liquid weight > 0.
# ---------------------------------------------------------------------------

def connected_components(labels, liquid_w, max_iters: int):
    """Per-cell component label (min linear index in the component; -1
    where not REDUCED).  Each sweep spreads the minimum along whole
    straight runs on every axis by distance doubling; sweeps repeat until
    nothing changes (one host check per sweep) or ``max_iters``."""
    red = labels == REDUCED
    n = labels.numel()
    big = torch.tensor(n, dtype=torch.int32, device=labels.device)
    lin = _arange(n, labels.device).reshape(labels.shape)
    comp = torch.where(red, lin, big)

    link_lo = []
    for a in range(3):
        fw = liquid_w[f"face{a}"]
        link_lo.append(red & shift(red, unit(a, -1), False) & (lower_faces(fw, a) > 0))

    def run_min(m, a):
        fdn = link_lo[a]
        fup = shift(link_lo[a], unit(a, 1), False)
        d = 1
        while d < m.shape[a]:
            dn = shift(m, unit(a, -d), n)
            up = shift(m, unit(a, d), n)
            m = torch.minimum(m, torch.where(fdn, dn, big))
            m = torch.minimum(m, torch.where(fup, up, big))
            fdn = fdn & shift(fdn, unit(a, -d), False)
            fup = fup & shift(fup, unit(a, d), False)
            d *= 2
        return m

    for _ in range(max_iters):
        new = comp
        for a in range(3):
            new = run_min(new, a)
        changed = bool((new != comp).any())
        comp = new
        if not changed:
            break
    return torch.where(red, comp, torch.tensor(INVALID_REGION, dtype=torch.int32, device=labels.device))


def compact_regions(comp, max_regions: int):
    """Map component labels to dense slots [0, max_regions) in increasing
    component label.  Returns (region_ids, region_valid, n_regions,
    overflowed)."""
    n = comp.numel()
    flat = comp.reshape(-1)
    ok = flat >= 0
    present = torch.zeros(n, dtype=torch.int32, device=comp.device)
    present = present.scatter_reduce(0, torch.where(ok, flat, 0).long(), ok.to(torch.int32), reduce="amax")
    first_rank = torch.cumsum(present, 0, dtype=torch.int32) - present
    n_regions_total = first_rank[-1] + present[-1]
    pos = first_rank[flat.clamp(0, n - 1).long()].reshape(comp.shape)
    region_ids = torch.where((comp >= 0) & (pos < max_regions), pos, INVALID_REGION).to(torch.int32)
    n_regions = torch.clamp(n_regions_total, max=max_regions).to(torch.int32)
    region_valid = _arange(max_regions, comp.device) < n_regions
    return region_ids, region_valid, n_regions, n_regions_total > max_regions


# ---------------------------------------------------------------------------
# Region hygiene (Classifier.cpp:1074-1262)
# ---------------------------------------------------------------------------

def fix_region_boundaries(labels, region_ids, max_iters: int):
    """No ACTIVEFLUID cell may touch two different reduced regions: where
    one does, demote all its REDUCED neighbours.  ``max_iters`` sweeps."""
    big = 2**30
    for _ in range(max_iters):
        red = labels == REDUCED
        reg = torch.where(red, region_ids, INVALID_REGION)
        mn = torch.full(labels.shape, big, dtype=torch.int32, device=labels.device)
        mx = torch.full(labels.shape, -1, dtype=torch.int32, device=labels.device)
        for a in range(3):
            for d in (-1, 1):
                nb = shift(reg, unit(a, d), -1)
                mn = torch.minimum(mn, torch.where(nb >= 0, nb, big))
                mx = torch.maximum(mx, nb)
        bad = (labels == ACTIVEFLUID) & (mx >= 0) & (mn != mx)
        demote = torch.zeros_like(bad)
        for a in range(3):
            for d in (-1, 1):
                demote = demote | shift(bad, unit(a, d), False)
        demote = demote & red
        labels = _label(demote, ACTIVEFLUID, labels)
        region_ids = torch.where(demote, INVALID_REGION, region_ids).to(torch.int32)
    return labels, region_ids


def cube_shape(res, tile_size: int):
    return tuple(-(-n // tile_size) for n in res)


def cell_cube_ids(shape, tile_size: int, device):
    """Flattened tile-cube id per cell."""
    cs = cube_shape(shape, tile_size)
    idx = None
    for a in range(3):
        c = (_arange(shape[a], device) // tile_size).reshape(axis_view(shape, a))
        idx = c if idx is None else idx * cs[a] + c
    return idx, cs


def _cube_min(arr, tile_size: int, cs, fill):
    """Per-cube min of a cell array -> [ncubes]; ``fill`` pads ragged extents."""
    x = arr
    for i in range(3):
        x = pad_axis(x, i, 0, cs[i] * tile_size - x.shape[i], fill)
    T = tile_size
    x = x.reshape(cs[0] * T, cs[1] * T, cs[2], T).amin(dim=3)
    x = x.reshape(cs[0] * T, cs[1], T, cs[2]).amin(dim=2)
    x = x.reshape(cs[0], T, cs[1], cs[2]).amin(dim=1)
    return x.reshape(-1)


def enforce_one_region_per_cube(labels, region_ids, region_valid, tile_size: int, max_regions: int):
    """Keep only the lowest-id region per tile cube; demote the others'
    cells in that cube to ACTIVEFLUID.  Returns (labels, region_ids,
    region_valid, region_of_cube)."""
    red = labels == REDUCED
    cubes, cs = cell_cube_ids(labels.shape, tile_size, labels.device)
    big = 2**30
    cube_min = _cube_min(torch.where(red, region_ids, big).to(torch.int32), tile_size, cs, big)
    keep_reg = cube_min[cubes.expand(labels.shape).long()]
    demote = red & (region_ids != keep_reg)
    labels = _label(demote, ACTIVEFLUID, labels)
    region_ids = torch.where(demote, INVALID_REGION, region_ids).to(torch.int32)

    kept_ok = (cube_min >= 0) & (cube_min < big)
    present = torch.zeros(max_regions, dtype=torch.int32, device=labels.device)
    idx = torch.where(kept_ok, cube_min.clamp(0, max_regions - 1), 0).long()
    present = present.scatter_reduce(0, idx, kept_ok.to(torch.int32), reduce="amax")
    region_valid = region_valid & (present > 0)
    region_of_cube = torch.where(kept_ok, cube_min, INVALID_REGION).to(torch.int32)
    return labels, region_ids, region_valid, region_of_cube


def _wrap_i32(x):
    """int64 -> the value int32 arithmetic would give (two's complement)."""
    return (x + 2**31) % 2**32 - 2**31


def fix_small_regions(labels, region_ids, region_valid, max_regions: int):
    """Remove regions thinner than 4 cells on any axis (the reference keeps
    a region only if its bounding-box extent is >= 4)."""
    red = labels == REDUCED
    seg = torch.where(red & (region_ids >= 0), region_ids, max_regions).reshape(-1).long()
    big = 2**30
    cols = []
    for a in range(3):
        coord = _arange(labels.shape[a], labels.device).reshape(axis_view(labels.shape, a))
        coord = coord.expand(labels.shape).reshape(-1).long()
        cols.append(torch.where(red.reshape(-1), coord, big))
        cols.append(torch.where(red.reshape(-1), -coord, big))
    stacked = torch.stack(cols, dim=-1)  # [N, 6]
    ext = torch.full((max_regions + 1, 6), _I32_MAX, dtype=torch.int64, device=labels.device)
    ext = ext.scatter_reduce(0, seg[:, None].expand(-1, 6), stacked, reduce="amin")[:max_regions]
    remove = torch.zeros(max_regions, dtype=torch.bool, device=labels.device)
    for a in range(3):
        mn, neg_mx = ext[:, 2 * a], ext[:, 2 * a + 1]
        # an empty segment (a valid region that lost every cell) keeps the
        # int32 max identity; its extent wraps to 3 in int32 and is removed
        remove = remove | (_wrap_i32((-neg_mx) - mn + 1) <= 3)
    remove = remove & region_valid
    region_valid = region_valid & ~remove
    cell_remove = red & (region_ids >= 0) & remove[region_ids.clamp(0, max_regions - 1).long()]
    labels = _label(cell_remove, ACTIVEFLUID, labels)
    region_ids = torch.where(cell_remove, INVALID_REGION, region_ids).to(torch.int32)
    return labels, region_ids, region_valid


# ---------------------------------------------------------------------------
# Faces and edges (Classifier.cpp:752-1067)
# ---------------------------------------------------------------------------

def classify_faces(liquid_w, fluid_w, axis: int) -> torch.Tensor:
    """findFaceLabelFromCenter (Classifier.cpp:784-832)."""
    cw = liquid_w["center"]
    n = cw.shape[axis]
    cw_p = pad_axis(cw, axis, 1, 1, 0.0)
    active = (cw_p.narrow(axis, 0, n + 1) > 0) | (cw_p.narrow(axis, 1, n + 1) > 0)
    for e in range(3):
        if e == axis:
            continue
        t = 3 - axis - e
        ew = liquid_w[f"edge{e}"]
        n_t = ew.shape[t] - 1
        active = active | (ew.narrow(t, 0, n_t) > 0) | (ew.narrow(t, 1, n_t) > 0)
    fw = fluid_w[f"face{axis}"]
    labels = torch.full(active.shape, UNSOLVED, dtype=torch.int8, device=active.device)
    labels = _label(active & (fw < 0.5), SOLID, labels)
    return _label(active & ~(fw < 0.5), GENERICFLUID, labels)


def classify_edges(liquid_w, fluid_w, edge_axis: int) -> torch.Tensor:
    """findEdgeLabelFromFaceAlt (Classifier.cpp:1021-1067)."""
    e = edge_axis
    ok = (liquid_w[f"edge{e}"] > 0) & (fluid_w[f"edge{e}"] > 0)
    p, q = EDGE_OFFSET_AXES[e]
    for fa, other in ((p, q), (q, p)):
        fw = liquid_w[f"face{fa}"]
        n_o = fw.shape[other]
        fw_p = pad_axis(fw, other, 1, 1, 0.0)
        ok = ok & (fw_p.narrow(other, 0, n_o + 1) > 0) & (fw_p.narrow(other, 1, n_o + 1) > 0)
    labels = torch.full(ok.shape, UNSOLVED, dtype=torch.int8, device=ok.device)
    return _label(ok, GENERICFLUID, labels)


def _demote_foreign_cube_faces(face_labels, face_region, region_of_cube, tile_size: int, axis: int, res):
    """REDUCED faces whose slot cube (the lower cell's cube) keeps another
    region, or that lie on the index-0 plane, become ACTIVEFLUID."""
    cs = cube_shape(res, tile_size)
    roc3 = region_of_cube.reshape(cs)
    shape = face_labels.shape
    idx = []
    for i in range(3):
        c = _arange(shape[i], face_labels.device)
        if i == axis:
            c = c - 1
        idx.append(torch.clamp(torch.div(c, tile_size, rounding_mode="floor"), 0, cs[i] - 1).long().reshape(axis_view(shape, i)))
    cube_reg = roc3[idx[0], idx[1], idx[2]]
    outside = (_arange(shape[axis], face_labels.device) == 0).reshape(axis_view(shape, axis))
    bad = (face_labels == REDUCED) & ((face_region != cube_reg) | outside)
    return _label(bad, ACTIVEFLUID, face_labels), torch.where(bad, INVALID_REGION, face_region).to(torch.int32)


def face_reduced_indices(cell_labels, cell_region, face_labels, axis: int):
    """A face next to a REDUCED cell takes that cell's region (upper cell
    first, Classifier.cpp:1498-1528) and becomes REDUCED."""
    reg = torch.where(cell_labels == REDUCED, cell_region, INVALID_REGION).to(torch.int32)
    n = cell_labels.shape[axis]
    reg_p = pad_axis(reg, axis, 1, 1, INVALID_REGION)
    upper = reg_p.narrow(axis, 1, n + 1)
    lower = reg_p.narrow(axis, 0, n + 1)
    idx = torch.where(upper >= 0, upper, lower)
    return _label(idx >= 0, REDUCED, face_labels), idx


def edge_reduced_indices(face_labels, face_regions, edge_labels, edge_axis: int):
    """Edges with all 4 surrounding faces REDUCED become REDUCED, with some
    REDUCED become BOUNDARY; region id in the reference's priority order
    (Classifier.cpp:1534-1659)."""
    p, q = EDGE_OFFSET_AXES[edge_axis]

    def face_views(fa, other):
        fl, fr = face_labels[fa], face_regions[fa]
        n_o = fl.shape[other]
        fl_p = pad_axis(fl, other, 1, 1, UNSOLVED)
        fr_p = pad_axis(fr, other, 1, 1, INVALID_REGION)
        return ((fl_p.narrow(other, 1, n_o + 1), fr_p.narrow(other, 1, n_o + 1)),
                (fl_p.narrow(other, 0, n_o + 1), fr_p.narrow(other, 0, n_o + 1)))

    (pl0, pr0), (pl1, pr1) = face_views(p, q)
    (ql0, qr0), (ql1, qr1) = face_views(q, p)
    checks = [(pl0, pr0), (pl1, pr1), (ql0, qr0), (ql1, qr1)]
    all_red = (pl0 == REDUCED) & (pl1 == REDUCED) & (ql0 == REDUCED) & (ql1 == REDUCED)
    any_red = (pl0 == REDUCED) | (pl1 == REDUCED) | (ql0 == REDUCED) | (ql1 == REDUCED)
    bnd_idx = torch.full(pl0.shape, INVALID_REGION, dtype=torch.int32, device=pl0.device)
    for lbl, reg in reversed(checks):
        bnd_idx = torch.where(lbl == REDUCED, reg, bnd_idx)
    new_labels = _label(all_red, REDUCED, _label(any_red & ~all_red, BOUNDARY, edge_labels))
    idx = torch.where(all_red, pr0, torch.where(any_red, bnd_idx, INVALID_REGION)).to(torch.int32)
    return new_labels, idx


# ---------------------------------------------------------------------------
# The bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Classification:
    """All labels and region ids for one solve."""

    cell_labels: torch.Tensor
    face_labels: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    edge_labels: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    cell_region: torch.Tensor
    face_region: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    edge_region: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    region_valid: torch.Tensor  # [max_regions] bool
    n_regions: torch.Tensor  # 0-d int32
    region_overflow: torch.Tensor  # 0-d bool
    region_of_cube: torch.Tensor  # [ncubes] region slot per tile cube


def effective_max_regions(grid: Grid, params: SolverParams) -> int:
    """Region slot bound: max(2 * ncubes, 64) when tiled (``max_regions``
    is ignored, as in JAX), ``max_regions`` on the untiled path, 1 (an
    unused slot) for the uniform solve."""
    if not params.do_reduced_regions:
        return 1
    if params.do_tile:
        return max(2 * math.prod(cube_shape(grid.res, params.tile_size)), 64)
    return params.max_regions


def _classify_uniform(grid: Grid, cell_labels, face_labels, edge_labels, max_regions: int) -> Classification:
    """The uniform branch: GENERICFLUID becomes ACTIVEFLUID everywhere and
    every region map is INVALID_REGION."""
    def activate(lbl):
        return _label(lbl == GENERICFLUID, ACTIVEFLUID, lbl)

    dev = cell_labels.device

    def invalid(shape):
        return torch.full(shape, INVALID_REGION, dtype=torch.int32, device=dev)

    return Classification(
        cell_labels=activate(cell_labels),
        face_labels=tuple(activate(l) for l in face_labels),
        edge_labels=tuple(activate(l) for l in edge_labels),
        cell_region=invalid(grid.center_shape),
        face_region=tuple(invalid(grid.face_shape(a)) for a in range(3)),
        edge_region=tuple(invalid(grid.edge_shape(e)) for e in range(3)),
        region_valid=torch.zeros((max_regions,), dtype=torch.bool, device=dev),
        n_regions=torch.tensor(0, dtype=torch.int32, device=dev),
        region_overflow=torch.tensor(False, device=dev),
        region_of_cube=invalid((1,)),
    )


def classify(grid: Grid, liquid_w, fluid_w, params: SolverParams) -> Classification:
    """Full label pipeline of the tiled or the untiled cube-region path, or
    the uniform one (exec/HDK_PolyStokes.C:356-404).  Tiled, the connected
    components run at most 4 * tile_size sweeps, and no face needs the
    untiled path's cube alignment: the padding slabs keep every region's
    faces inside its own cube."""
    max_regions = effective_max_regions(grid, params)
    face_labels = [classify_faces(liquid_w, fluid_w, a) for a in range(3)]
    edge_labels = [classify_edges(liquid_w, fluid_w, e) for e in range(3)]
    if not params.do_reduced_regions:
        return _classify_uniform(grid, classify_cells(liquid_w, fluid_w), face_labels, edge_labels, max_regions)
    cell_labels = construct_reduced_regions(classify_cells(liquid_w, fluid_w), liquid_w, params)

    cc_iters = 4 * params.tile_size if params.do_tile else sum(grid.res)
    comp = connected_components(cell_labels, liquid_w, cc_iters)
    cell_region, region_valid, _, overflow = compact_regions(comp, max_regions)
    cell_labels, cell_region = fix_region_boundaries(cell_labels, cell_region, params.region_fix_max_iters)
    cell_labels, cell_region, region_valid = fix_small_regions(cell_labels, cell_region, region_valid, max_regions)
    cell_labels, cell_region, region_valid, region_of_cube = enforce_one_region_per_cube(
        cell_labels, cell_region, region_valid, params.tile_size, max_regions
    )
    n_regions = region_valid.sum().to(torch.int32)

    face_region = []
    for a in range(3):
        nl, nr = face_reduced_indices(cell_labels, cell_region, face_labels[a], a)
        if not params.do_tile:
            nl, nr = _demote_foreign_cube_faces(nl, nr, region_of_cube, params.tile_size, a, grid.res)
        face_labels[a] = nl
        face_region.append(nr)
    edge_region = []
    for e in range(3):
        edge_labels[e], er = edge_reduced_indices(face_labels, face_region, edge_labels[e], e)
        edge_region.append(er)

    # remaining GENERICFLUID entries become ACTIVEFLUID (Classifier.cpp:257-284)
    def activate(lbl):
        return _label(lbl == GENERICFLUID, ACTIVEFLUID, lbl)

    return Classification(
        cell_labels=activate(cell_labels),
        face_labels=tuple(activate(l) for l in face_labels),
        edge_labels=tuple(activate(l) for l in edge_labels),
        cell_region=cell_region,
        face_region=tuple(face_region),
        edge_region=tuple(edge_region),
        region_valid=region_valid,
        n_regions=n_regions,
        region_overflow=overflow,
        region_of_cube=region_of_cube,
    )
