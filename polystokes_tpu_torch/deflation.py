"""A-DEF2 two-level deflation for the pressure-stress Schur system, the
counterpart of ``polystokes_tpu.deflation``.

A two-level correction for the low-frequency cluster the CELL_ARROW block
preconditioner cannot see (Tang, Nabben, Vuik & Erlangga, J. Sci. Comput.
39, 2009):

    z = z1 + W E^-1 W^T (r - A z1),      z1 = M^-1 r,
    E = W^T (-A) W,
    x0' = x0 - W E^-1 W^T (b - A x0)     (start with W^T r0 = 0)

with W = per-cube constants of each of the 7 solve families (p, tau_cc,
tau_e) masked to the active DOFs, k = 7 * n_cubes coarse unknowns.  E is
built from 189 probe applies (27 colours of the cube lattice, spacing 3,
times 7 families: the support of A w_cube reaches at most 2 cells beyond
the cube, so cubes 3 apart never share an output aggregate), then
equilibrated and inverted once.  Each CG iteration adds one operator apply
(A z1) and two [k, k] products.

The algebra is plain torch, as it is XLA in the JAX package; the probe
and per-iteration applies are the step's own (the packed kernels, or the
unpacked apply).  One divergence: E is written with a masked index
assignment, where JAX scatter-adds.  Each (row, column) of E receives one
value, so the result is the same, and it does not depend on the order of
atomics (``index_put_(accumulate=True)`` is not run-to-run deterministic
on CUDA).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from .classify import Classification
from .config import SolverParams
from .grid import Grid
from .operators import PTau
from .packed_apply import pack_ptau, packed_masks, unpack_ptau

# the dense-E ceiling: E is [k, k], k = 7 * n_cubes, built and inverted
# densely; k = 8192 is 256 MB for E and as much for its inverse in f32
# (128^3 at tile 16 and 256^3 at deflation_tile 32 both give k = 3584)
MAX_COARSE_DOFS = 8192
N_COLORS = 27
N_FAMILIES = 7


@dataclasses.dataclass(frozen=True)
class DeflationState:
    """The per-step deflation operators."""

    masks: torch.Tensor  # [7, nx, ny, nz] DOF masks in the packed layout
    e: torch.Tensor  # [k, k] E = W^T (-A) W, kept for the refinement step
    einv: torch.Tensor  # [k, k] the equilibrated inverse of E
    cs: Tuple[int, int, int]  # the coarse lattice
    tile: int  # the coarse cube's edge


def deflation_tile(grid: Grid, params: SolverParams) -> int:
    """The coarse cube size: ``params.deflation_tile``, else the reduction
    tile on the tiled reduced step and 16 otherwise."""
    tc = params.deflation_tile
    if tc <= 0:
        tc = params.tile_size if (params.do_reduced_regions and params.do_tile) else 16
    return tc


def deflation_supported(grid: Grid, params: SolverParams) -> bool:
    """Whether deflation can run: the coarse tile divides the grid, E fits
    (``MAX_COARSE_DOFS``), and a reduced step is tiled with the coarse tile
    a multiple of the reduction tile, so that each probe's support stays in
    one ring of cubes."""
    tc = deflation_tile(grid, params)
    if any(n % tc for n in grid.res):
        return False
    nc = 1
    for n in grid.res:
        nc *= n // tc
    if N_FAMILIES * nc > MAX_COARSE_DOFS:
        return False
    if params.do_reduced_regions:
        if not params.do_tile:
            return False  # general regions have unbounded probe support
        if tc % params.tile_size:
            return False
    return True


def _restrict(xp: torch.Tensor, masks: torch.Tensor, cs, T: int) -> torch.Tensor:
    """W^T x: masked per-cube sums, [7, nx, ny, nz] -> [7 * nc], family-major."""
    v = (masks * xp).reshape(N_FAMILIES, cs[0], T, cs[1], T, cs[2], T)
    return v.sum(dim=(2, 4, 6)).reshape(-1)


def _prolong(mu: torch.Tensor, masks: torch.Tensor, cs, T: int) -> torch.Tensor:
    """W mu: each cube's coefficient over its masked DOFs."""
    f = mu.reshape(N_FAMILIES, cs[0], 1, cs[1], 1, cs[2], 1).expand(N_FAMILIES, cs[0], T, cs[1], T, cs[2], T)
    return masks * f.reshape(masks.shape)


def _assemble_e(agg: torch.Tensor, cs) -> torch.Tensor:
    """E [k, k] from the probe aggregates agg [189, 7, nc]: column (f, c)
    is probe (colour of c, f), read on the rows (f', c') of the 27 cubes
    around c.  Every (row, column) gets at most one value, written by a
    masked index assignment (no accumulation)."""
    nc = cs[0] * cs[1] * cs[2]
    k = N_FAMILIES * nc
    dev = agg.device
    r3 = torch.arange(3, device=dev)
    colors = torch.stack(torch.meshgrid(r3, r3, r3, indexing="ij"), dim=-1).reshape(-1, 3)  # [27, 3]
    cgrid = torch.stack(torch.meshgrid(*(torch.arange(c, device=dev) for c in cs), indexing="ij"), dim=-1).reshape(-1, 3)
    color_of = (cgrid[:, 0] % 3) * 9 + (cgrid[:, 1] % 3) * 3 + (cgrid[:, 2] % 3)  # [nc]
    nbr = cgrid[:, None, :] + (colors - 1)[None, :, :]  # [nc, 27, 3]
    lim = torch.tensor(cs, device=dev)
    valid = ((nbr >= 0) & (nbr < lim)).all(dim=-1)  # [nc, 27]
    nbr = torch.minimum(nbr.clamp(min=0), lim - 1)
    nbr_flat = (nbr[..., 0] * cs[1] + nbr[..., 1]) * cs[2] + nbr[..., 2]  # [nc, 27]
    fam = torch.arange(N_FAMILIES, device=dev)
    # vals[c, f, d, f'] = agg[color_of(c) * 7 + f, f', nbr_flat[c, d]]
    pass_idx = color_of[:, None] * N_FAMILIES + fam[None, :]  # [nc, 7]
    vals = agg[pass_idx[:, :, None, None], fam[None, None, None, :], nbr_flat[:, None, :, None]]
    rows = (fam[None, None, None, :] * nc + nbr_flat[:, None, :, None]).expand(vals.shape)
    cols = (fam[None, :, None, None] * nc + torch.arange(nc, device=dev)[:, None, None, None]).expand(vals.shape)
    keep = valid[:, None, :, None].expand(vals.shape)
    e = torch.zeros((k, k), dtype=agg.dtype, device=dev)
    e[rows[keep], cols[keep]] = -vals[keep]
    return 0.5 * (e + e.T)


def build_deflation(grid: Grid, cls: Classification, params: SolverParams, apply_packed: Callable) -> DeflationState:
    """The W masks and the inverted coarse operator E^-1.  ``apply_packed``
    is the full Schur apply on packed [7, ...] vectors (A, negative
    definite): E[(f', c'), (f, c)] = -w_{f'c'}^T A w_{fc}."""
    T = deflation_tile(grid, params)
    if any(n % T for n in grid.res):
        raise ValueError(f"deflation tile {T} must divide the resolution {tuple(grid.res)}")
    cs = tuple(n // T for n in grid.res)
    dtype = params.dtype
    masks = packed_masks(cls, dtype)
    dev = masks.device
    # the cube coordinate of each cell along each axis, mod 3 (the colour)
    cube3 = [(torch.arange(n, device=dev) // T) % 3 for n in grid.res]
    agg = []
    for cx in range(3):
        for cy in range(3):
            for cz in range(3):
                lit = ((cube3[0] == cx)[:, None, None] & (cube3[1] == cy)[None, :, None]
                       & (cube3[2] == cz)[None, None, :]).to(dtype)
                lit_masks = masks * lit
                for f in range(N_FAMILIES):
                    w = torch.zeros_like(masks)
                    w[f] = lit_masks[f]
                    y = apply_packed(w)
                    agg.append((masks * y).reshape(N_FAMILIES, cs[0], T, cs[1], T, cs[2], T).sum(dim=(2, 4, 6)))
    e = _assemble_e(torch.stack(agg, dim=0).reshape(N_COLORS * N_FAMILIES, N_FAMILIES, -1), cs)

    # equilibrate, regularise dead coarse DOFs, invert once
    d = torch.diagonal(e)
    dead = d <= 0
    s = torch.where(dead, 0.0, 1.0 / torch.sqrt(torch.where(dead, 1.0, d)))
    k = e.shape[0]
    e_eq = e * s[:, None] * s[None, :] + torch.diag(dead.to(dtype))
    e_eq = e_eq + 1e-6 * torch.eye(k, dtype=dtype, device=dev)
    einv = torch.linalg.inv(e_eq) * s[:, None] * s[None, :]
    return DeflationState(masks=masks, e=e, einv=einv, cs=cs, tile=T)


def coarse_solve(defl: DeflationState, q: torch.Tensor) -> torch.Tensor:
    """E^-1 q with one step of iterative refinement (which guards the f32
    inverse against the coarse operator's conditioning)."""
    mu = defl.einv @ q
    return mu + defl.einv @ (q - defl.e @ mu)


def deflated_precond_packed(defl: DeflationState, apply_packed: Callable, base: Callable = None) -> Callable:
    """The A-DEF2 preconditioner on packed vectors:
    z = z1 + W E^-1 W^T (r - A z1), z1 = base(r) (r itself without one)."""

    def solve(rp):
        z1 = base(rp) if base is not None else rp
        # r - (-A) z1 = r + A z1 (A is the negative operator)
        q = _restrict(rp + apply_packed(z1), defl.masks, defl.cs, defl.tile)
        return z1 + _prolong(coarse_solve(defl, q), defl.masks, defl.cs, defl.tile)

    return solve


def deflate_guess_packed(defl: DeflationState, apply_packed: Callable, b, x0):
    """x0' = x0 - W E^-1 W^T (b - A x0): makes W^T r0 = 0, as A-DEF2
    requires."""
    mu = coarse_solve(defl, _restrict(b - apply_packed(x0), defl.masks, defl.cs, defl.tile))
    return x0 - _prolong(mu, defl.masks, defl.cs, defl.tile)


def deflated_precond_ptau(defl: DeflationState, apply_ptau: Callable, base: Callable = None) -> Callable:
    """A-DEF2 on PTau vectors (the unpacked apply): the restriction and the
    prolongation run on the packed layout."""

    def solve(r: PTau) -> PTau:
        z1 = base(r) if base is not None else r
        q = _restrict(pack_ptau(r) + pack_ptau(apply_ptau(z1)), defl.masks, defl.cs, defl.tile)
        return z1 + unpack_ptau(_prolong(coarse_solve(defl, q), defl.masks, defl.cs, defl.tile))

    return solve


def deflate_guess_ptau(defl: DeflationState, apply_ptau: Callable, b: PTau, x0: PTau) -> PTau:
    """``deflate_guess_packed`` on PTau vectors."""
    mu = coarse_solve(defl, _restrict(pack_ptau(b - apply_ptau(x0)), defl.masks, defl.cs, defl.tile))
    return x0 - unpack_ptau(_prolong(mu, defl.masks, defl.cs, defl.tile))
