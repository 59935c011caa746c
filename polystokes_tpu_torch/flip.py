"""The FLIP/PIC particle loop around the Stokes solve, the counterpart of
``polystokes_tpu.flip`` (the CLI's ``--flip``).

The reference node is a microsolver inside Houdini's FLIP loop
(reference README.md:26-28): Houdini owns the particles, advection and
surface tracking, and the node replaces the viscous pressure projection.
This module stands in for that host loop, so the built-in scenes run end
to end with the outer structure the reference's results assume
(``sim.py``'s grid semi-Lagrangian loop stays the cheaper alternative).

Per frame:  P2G transfer -> gravity -> Stokes solve (``solver.step``)
            -> FLIP/PIC blended G2P -> RK2 particle advection
            -> particle surface rebuild (SDF) [-> reseed]

Plain torch on the tensors' device, as the JAX package's is plain XLA: a
fixed particle buffer with adaptive recycling inside it (``reseed``),
P2G as weighted sums over the trilinear corners, G2P and advection as
gathers (``sim._velocity_at``), the surface as bounded 6-neighbour
distance sweeps from the particle occupancy.

P2G sums in a fixed order (``_fixed_order_scatter``): a stable sort of
the target indices, then a segmented scan of log2 steps, so two frames on
the same inputs are bit-equal on the card, where ``index_add_`` sums in
another order on every run.  JAX sums corner by corner in particle order;
the two agree to round-off.  The occupancy counts add ``alive`` in {0, 1},
exact small integers, so their order does not matter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SolverParams
from .grid import Grid, shift, unit
from .sim import _trilinear, _velocity_at
from .solver import Scene, step


@dataclasses.dataclass(frozen=True)
class FlipState:
    """Particle state (cell units: position p sits at world p*dx)."""

    pos: torch.Tensor  # [P, 3] float, cell units
    vel: torch.Tensor  # [P, 3] float, world units
    alive: torch.Tensor  # [P] float 0/1


def seed_particles(grid: Grid, surface_sdf, max_particles: int, ppc_axis: int = 2, seed: int = 0,
                   dtype=torch.float32) -> FlipState:
    """Host-side seeding, in numpy exactly as the JAX package's: a jittered
    ppc_axis^3-per-cell lattice restricted to liquid cells (sdf < 0),
    packed into a fixed [max_particles, 3] buffer (excess dropped
    deterministically, underfill marked dead), float32 and then cast to
    ``dtype``.  The state lives on the SDF's device (the card for an SDF
    given as an array)."""
    device = surface_sdf.device if isinstance(surface_sdf, torch.Tensor) else "cuda"
    sdf = surface_sdf.detach().cpu().numpy() if isinstance(surface_sdf, torch.Tensor) else np.asarray(surface_sdf)
    rng = np.random.default_rng(seed)
    liquid = np.argwhere(sdf < 0.0)  # [L, 3] cell indices
    q = ppc_axis
    # lattice offsets within the cell: (k + 0.5)/q + jitter
    offs = (np.stack(np.meshgrid(*([np.arange(q)] * 3), indexing="ij"), -1).reshape(-1, 3) + 0.5) / q
    pos = (liquid[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    pos = pos + rng.uniform(-0.5 / q, 0.5 / q, pos.shape)
    if len(pos) > max_particles:
        sel = rng.permutation(len(pos))[:max_particles]
        pos = pos[sel]
    alive = np.zeros(max_particles, np.float32)
    alive[: len(pos)] = 1.0
    buf = np.zeros((max_particles, 3), np.float32)
    buf[: len(pos)] = pos
    return FlipState(
        pos=torch.from_numpy(buf).to(device=device, dtype=dtype),
        vel=torch.zeros((max_particles, 3), dtype=dtype, device=device),
        alive=torch.from_numpy(alive).to(device=device, dtype=dtype),
    )


def _fixed_order_scatter(flat_idx, vals, size: int):
    """out[size, C] with out[i] = sum of vals[j] over flat_idx[j] == i, in
    an order fixed by the data alone: a stable sort groups the samples
    of each target, an inclusive segmented scan (step d adds the partial
    sum d back where it lies in the same segment) sums each group as a
    tree, and each group's last sample writes its total once."""
    key, order = torch.sort(flat_idx, stable=True)
    v = vals[order]
    n = key.shape[0]
    if n == 0:
        return vals.new_zeros((size,) + tuple(vals.shape[1:]))
    # the longest group bounds the scan's steps (one host read)
    longest = int(torch.unique_consecutive(key, return_counts=True)[1].max())
    d = 1
    while d < longest:
        same = (key[d:] == key[:-d]).unsqueeze(-1)
        v = torch.cat([v[:d], v[d:] + torch.where(same, v[:-d], 0.0)])
        d *= 2
    last = torch.ones(n, dtype=torch.bool, device=key.device)
    last[:-1] = key[1:] != key[:-1]
    out = vals.new_zeros((size,) + tuple(vals.shape[1:]))
    out[key[last]] = v[last]
    return out


def _corner_scatter(shape, idx0, frac, w, val):
    """(acc, wacc): trilinear-weighted ``val`` and the weights summed onto
    the 8 corners around idx0 + frac, [P]-vectorized; the 16 weighted
    scatter-adds of the JAX package as one fixed-order sum."""
    idx, cws = [], []
    for dx_ in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cw = (
                    (frac[:, 0] if dx_ else 1.0 - frac[:, 0])
                    * (frac[:, 1] if dy else 1.0 - frac[:, 1])
                    * (frac[:, 2] if dz else 1.0 - frac[:, 2])
                ) * w
                ix = torch.clamp(idx0[:, 0] + dx_, 0, shape[0] - 1)
                iy = torch.clamp(idx0[:, 1] + dy, 0, shape[1] - 1)
                iz = torch.clamp(idx0[:, 2] + dz, 0, shape[2] - 1)
                idx.append((ix * shape[1] + iy) * shape[2] + iz)
                cws.append(cw)
    cw = torch.cat(cws)
    sums = _fixed_order_scatter(torch.cat(idx), torch.stack([cw * val.repeat(8), cw], dim=-1),
                                shape[0] * shape[1] * shape[2])
    return sums[:, 0].reshape(shape), sums[:, 1].reshape(shape)


def p2g(state: FlipState, grid: Grid, dtype=torch.float32):
    """Particle -> MAC grid velocity transfer.  Returns (vel, coverage):
    per-axis face tensors and the per-face weight sums (0 where no particle
    reaches the face: callers keep the prior grid velocity there)."""
    vels, covs = [], []
    pos, alive, pvel = state.pos.to(dtype), state.alive.to(dtype), state.vel.to(dtype)
    for a in range(3):
        fshape = grid.face_shape(a)
        # face a of cell i sits at cell-unit position i - 1/2 along a:
        # sample position in FACE index space is pos + 0.5 along a
        off = torch.tensor([0.5 if i == a else 0.0 for i in range(3)], dtype=dtype, device=pos.device)
        p = pos + off[None, :]
        idx0 = torch.floor(p).to(torch.int64)
        hi = torch.tensor([s - 2 for s in fshape], dtype=torch.int64, device=pos.device)
        idx0 = torch.minimum(torch.clamp(idx0, min=0), hi)
        frac = p - idx0
        acc, wacc = _corner_scatter(fshape, idx0, frac, alive, pvel[:, a])
        vels.append(acc / torch.where(wacc > 0, wacc, 1.0))
        covs.append(wacc)
    return tuple(vels), tuple(covs)


def g2p_flip(state: FlipState, vel_old, vel_new, alpha: float = 0.95) -> FlipState:
    """FLIP/PIC blended grid -> particle update:
    v_p' = alpha * (v_p + dv_interp) + (1 - alpha) * v_new_interp."""
    px, py, pz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    new = torch.stack(_velocity_at(vel_new, px, py, pz), dim=-1)
    delta = new - torch.stack(_velocity_at(vel_old, px, py, pz), dim=-1)
    v = alpha * (state.vel + delta) + (1.0 - alpha) * new
    return dataclasses.replace(state, vel=v)


def advect_particles(state: FlipState, vel, dt_over_dx, res) -> FlipState:
    """RK2 (midpoint) particle advection in the grid velocity; positions
    clamped to the domain interior."""
    px, py, pz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    u1 = _velocity_at(vel, px, py, pz)
    mx = px + 0.5 * dt_over_dx * u1[0]
    my = py + 0.5 * dt_over_dx * u1[1]
    mz = pz + 0.5 * dt_over_dx * u1[2]
    u2 = _velocity_at(vel, mx, my, mz)
    new = torch.stack([px + dt_over_dx * u2[0], py + dt_over_dx * u2[1], pz + dt_over_dx * u2[2]], dim=-1)
    lo = torch.full((3,), 0.01, dtype=new.dtype, device=new.device)
    hi = torch.tensor([n - 0.01 for n in res], dtype=new.dtype, device=new.device)
    return dataclasses.replace(state, pos=torch.minimum(torch.maximum(new, lo), hi))


def _cell_index(pos, res):
    """The cell of each particle: round(pos - 0.5) (half to even, as
    ``jnp.round``), clipped into the grid."""
    idx = torch.round(pos - 0.5).to(torch.int64)
    hi = torch.tensor([n - 1 for n in res], dtype=torch.int64, device=pos.device)
    return torch.minimum(torch.clamp(idx, min=0), hi)


def _occupancy(idx, alive, res):
    """Live particles per cell: exact small integers in ``alive``'s dtype."""
    cnt = torch.zeros(res, dtype=alive.dtype, device=alive.device)
    return cnt.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), alive, accumulate=True)


def surface_from_particles(state: FlipState, grid: Grid, radius: float = 0.9, sweeps: int = 6,
                           dtype=torch.float32):
    """Particle surface rebuild: occupancy scatter -> two bounded
    6-neighbour distance propagations (outside/inside) -> signed distance
    in world units, minus the particle radius (cell units).

    The propagation is exact on the sweeps-wide band around the surface
    (all the solver's classifiers look at) and clamps beyond it."""
    occ = _occupancy(_cell_index(state.pos, grid.res), state.alive.to(dtype), grid.res)
    inside = occ > 0
    big = float(sweeps + 1)

    def sweep_min(d):
        m = d
        for ax in range(3):
            m = torch.minimum(m, shift(d, unit(ax, 1), big) + 1.0)
            m = torch.minimum(m, shift(d, unit(ax, -1), big) + 1.0)
        return m

    def prop(mask):
        d = torch.where(mask, 0.0, big).to(dtype)
        for _ in range(sweeps):
            d = sweep_min(d)
        return d

    d_out = prop(inside)  # distance to liquid, in cells (0 inside)
    d_in = prop(~inside)  # distance to air, in cells (0 outside)
    phi_cells = torch.where(inside, -(d_in - 0.5), d_out - 0.5) - radius
    return phi_cells * torch.tensor(grid.dx, dtype=dtype, device=occ.device)


# R3 low-discrepancy constants (plastic-number sequence): deterministic
# in-cell jitter for reseeded particles without threading a generator
_R3 = (0.8191725133961645, 0.6710436067037893, 0.5497004779019703)


def _cell_counts(state: FlipState, res):
    idx = _cell_index(state.pos, res)
    return _occupancy(idx, state.alive, res), idx


def reseed(state: FlipState, grid: Grid, surface_sdf, vel, frame_idx, min_ppc: float = 3.0, target_ppc: int = 8,
           kill_dist_cells: float = 1.5, interior_margin_cells: float = 1.0) -> FlipState:
    """Adaptive particle recycling within the fixed slot budget (the
    analog of Houdini's FLIP reseeding, which the reference's host loop
    relies on, reference README.md:26-28):

      1. kill particles that escaped the liquid (sampled SDF > kill_dist)
      2. refill liquid cells with fewer than ``min_ppc`` live particles up
         to ``target_ppc``, assigning dead slots to deficit cells by rank
         (cumsum over per-cell deficits + searchsorted, static shapes)

    New particles get a low-discrepancy in-cell jitter (no generator) and
    the grid velocity at their position.  When the total deficit exceeds
    the dead pool, cells earlier in lexicographic order fill first."""
    dtype = state.pos.dtype
    dev = state.pos.device
    res = grid.res
    dx = torch.tensor(grid.dx, dtype=dtype, device=dev)

    # 1. kill escapees
    phi_p = _trilinear(surface_sdf.to(dtype), state.pos[:, 0] - 0.5, state.pos[:, 1] - 0.5, state.pos[:, 2] - 0.5)
    alive = state.alive * (phi_p < kill_dist_cells * dx).to(dtype)
    state = dataclasses.replace(state, alive=alive)

    # 2. per-cell deficits over STRICTLY INTERIOR liquid cells (the margin
    # keeps the refill off the SDF's smoothing shell around the particle
    # cloud: refilling phi ~ -0.4dx shell cells would inflate the liquid
    # by one cell per frame through the occupancy -> surface feedback)
    cnt, _ = _cell_counts(state, res)
    liquid = surface_sdf < -interior_margin_cells * dx
    need = torch.where(liquid & (cnt < min_ppc), float(target_ppc) - cnt, 0.0)
    need = torch.clamp(torch.round(need), min=0.0).to(torch.int32).reshape(-1)
    cum = torch.cumsum(need, 0, dtype=torch.int32)
    total_need = cum[-1]

    # dead-slot ranks (0-based among dead slots)
    dead = alive <= 0
    rank = torch.cumsum(dead.to(torch.int32), 0, dtype=torch.int32) - 1
    fill = dead & (rank < total_need)

    # target cell of each filled slot: the first cell whose cumulative
    # need interval contains the slot's rank
    cell_flat = torch.searchsorted(cum, rank, right=True)
    cell_flat = torch.clamp(cell_flat, 0, need.shape[0] - 1)
    cz = cell_flat % res[2]
    cy = (cell_flat // res[2]) % res[1]
    cx = cell_flat // (res[1] * res[2])

    # in-cell low-discrepancy jitter keyed by (slot, within-cell ordinal,
    # frame): u = fract(seq * R3), scaled into the cell's interior; cum at
    # index -1 where cell_flat is 0 is masked, as in JAX
    ordinal = rank - torch.where(cell_flat > 0, cum[cell_flat - 1], 0)
    seq = ordinal.to(dtype)[:, None] + torch.as_tensor(frame_idx, dtype=dtype, device=dev) * float(target_ppc + 1)
    u = torch.remainder(seq * torch.tensor(_R3, dtype=dtype, device=dev)[None, :], 1.0)
    new_pos = torch.stack([cx, cy, cz], dim=-1).to(dtype) + 0.1 + 0.8 * u

    pos = torch.where(fill[:, None], new_pos, state.pos)
    new_vel = torch.stack(_velocity_at(vel, pos[:, 0], pos[:, 1], pos[:, 2]), dim=-1)
    velp = torch.where(fill[:, None], new_vel, state.vel)
    alive = torch.where(fill, 1.0, alive).to(dtype)
    return FlipState(pos=pos, vel=velp, alive=alive)


def flip_frame(grid: Grid, scene: Scene, state: FlipState, params: SolverParams, gravity: float = -9.8,
               gravity_axis: int = 2, alpha: float = 0.95, do_reseed: bool = False, frame_idx=0):
    """One FLIP frame.  Returns (scene', state', stats).  With ``do_reseed``
    the frame ends with a kill + refill pass over the advected particles
    (see ``reseed``) against the post-advection particle surface."""
    dtype = params.dtype
    dt = scene.dt
    dt_over_dx = dt / torch.tensor(grid.dx, dtype=dtype, device=dt.device)

    pvel, cov = p2g(state, grid, dtype)
    # faces no particle reaches keep the prior grid velocity (Houdini
    # keeps the previous field outside the particle band too)
    vel = [torch.where(cov[a] > 0, pvel[a], scene.velocity[a].to(dtype)) for a in range(3)]
    surf = surface_from_particles(state, grid, dtype=dtype)

    vel[gravity_axis] = vel[gravity_axis] + torch.tensor(gravity, dtype=dtype, device=dt.device) * dt
    vel_old = tuple(vel)
    scene = dataclasses.replace(scene, velocity=vel_old, surface_sdf=surf)

    new_vel, valid, stats = step(grid, scene, params)

    state = g2p_flip(state, vel_old, new_vel, alpha)
    state = advect_particles(state, new_vel, dt_over_dx, grid.res)
    if do_reseed:
        surf2 = surface_from_particles(state, grid, dtype=dtype)
        state = reseed(state, grid, surf2, new_vel, frame_idx)
    out = dataclasses.replace(scene, velocity=new_vel)
    return out, state, stats


def simulate_flip(grid: Grid, scene: Scene, params: SolverParams, frames: int, max_particles: int = 1 << 20,
                  gravity: float = -9.8, alpha: float = 0.95, seed: int = 0, callback=None, do_reseed: bool = True):
    """Run ``frames`` FLIP frames from ``scene`` (particles seeded from its
    surface SDF, on its device).  Returns (final scene, final state, list of
    stats).  Adaptive recycling (``reseed``) is on by default, matching the
    Houdini host loop the reference assumes."""
    state = seed_particles(grid, scene.surface_sdf, max_particles, seed=seed, dtype=params.dtype)
    all_stats = []
    for k in range(frames):
        scene, state, stats = flip_frame(grid, scene, state, params, gravity, alpha=alpha, do_reseed=do_reseed,
                                         frame_idx=k)
        all_stats.append(dict(stats))
        if callback is not None:
            callback(k, scene, state, stats)
    return scene, state, all_stats
