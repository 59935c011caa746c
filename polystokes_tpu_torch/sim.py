"""The frame loop around the Stokes solve, the counterpart of
``polystokes_tpu.sim``:

  per frame:  add gravity -> viscous Stokes solve (``solver.step``)
              -> semi-Lagrangian advection of velocity and surface SDF

The reference is a microsolver inside Houdini's FLIP loop, where Houdini
supplies advection, gravity and surface tracking; this loop is the JAX
package's extension that drives the built-in scenes over frames without a
host application (grid-based semi-Lagrangian advection, no particles).

The advection is plain torch on the solve's device, as the JAX package's
is plain XLA: ``advect_field`` is the windowed form the JAX frame loop runs
(a weighted sum over static shifts), ``advect_field_gather`` the exact RK2
backtrace through gathers.  The substep count is a host int
(``cfl_substeps``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .config import SolverParams
from .grid import Grid, coord_grids, face_offsets
from .solver import Scene, step


def _trilinear(field, x, y, z):
    """Sample ``field`` at fractional index positions (tensors), edge-clamped.

    The eight corner reads are 1-D takes on flat indices; the clamps keep
    every corner index inside the array (``torch.take`` raises out of range
    where JAX clips)."""
    shape = field.shape
    x = torch.clamp(x, 0.0, shape[0] - 1.0)
    y = torch.clamp(y, 0.0, shape[1] - 1.0)
    z = torch.clamp(z, 0.0, shape[2] - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, shape[0] - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, shape[1] - 2)
    z0 = torch.clamp(torch.floor(z).long(), 0, shape[2] - 2)
    fx = x - x0
    fy = y - y0
    fz = z - z0

    sy, sz = shape[1] * shape[2], shape[2]
    base = x0 * sy + y0 * sz + z0
    flat = field.reshape(-1)

    def g(i, j, k):
        return torch.take(flat, base + (i * sy + j * sz + k))

    c00 = g(0, 0, 0) * (1 - fz) + g(0, 0, 1) * fz
    c01 = g(0, 1, 0) * (1 - fz) + g(0, 1, 1) * fz
    c10 = g(1, 0, 0) * (1 - fz) + g(1, 0, 1) * fz
    c11 = g(1, 1, 0) * (1 - fz) + g(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def _velocity_at(vel, px, py, pz):
    """MAC velocity sampled at positions (cell units).  Face array of axis
    a is indexed at position + 0.5 along a (face i sits at i - 1/2)."""
    out = []
    for a, v in enumerate(vel):
        off = [0.0, 0.0, 0.0]
        off[a] = 0.5
        out.append(_trilinear(v, px + off[0], py + off[1], pz + off[2]))
    return out


def _avg_down(f, ax):
    """n+1 -> n along ax: midpoint average 0.5*(f[j] + f[j+1])."""
    n = f.shape[ax] - 1
    return 0.5 * (f.narrow(ax, 0, n) + f.narrow(ax, 1, n))


def _avg_up(f, ax):
    """n -> n+1 along ax, edge-clamped: out[i] = 0.5*(f[i-1] + f[i]) with
    out[0] = f[0], out[n] = f[n-1], which is _trilinear's clamp at the
    domain box for a static -0.5 offset."""
    n = f.shape[ax]
    left = torch.cat([f.narrow(ax, 0, 1), f], dim=ax)
    right = torch.cat([f, f.narrow(ax, n - 1, 1)], dim=ax)
    return 0.5 * (left + right)


def velocity_at_lattice(vel, a):
    """MAC velocity sampled at the static lattice positions of sampling
    family ``a`` (face axis 0/1/2, or None = cell centers).

    These positions are the grid itself, so the trilinear weights are the
    constants {0, 1/2}: the sample is a stencil average, not a gather, and
    equals _velocity_at at those positions, edge clamps included."""
    out = []
    for b, v in enumerate(vel):
        if a == b:
            out.append(v)
        else:
            u = _avg_down(v, b)
            if a is not None:
                u = _avg_up(u, a)
            out.append(u)
    return out


def _lattice_velocity(vel, offsets, px, py, pz):
    """Velocity at the target family's own (static) sample positions:
    stencil averages for face and center families, gathers otherwise."""
    nz = [a for a in range(3) if offsets[a] != 0.0]
    if not nz:
        return velocity_at_lattice(vel, None)  # cell centers
    if len(nz) == 1 and offsets[nz[0]] == -0.5:
        return velocity_at_lattice(vel, nz[0])  # face family
    return _velocity_at(vel, px, py, pz)  # edge or custom offsets


def _positions(field, offsets):
    """(px, py, pz): the sample positions of ``field``'s family, broadcast
    to its shape."""
    xs, ys, zs = coord_grids(field.shape, offsets, field.dtype, field.device)
    return tuple(torch.broadcast_to(c, field.shape) for c in (xs, ys, zs))


def advect_field_gather(field, vel, dt_over_dx, offsets):
    """Semi-Lagrangian advection of a field sampled at ``offsets``, exact
    RK2 backtrace through gathers (unbounded displacement).  The JAX frame
    loop runs the windowed ``advect_field`` instead."""
    px, py, pz = _positions(field, offsets)
    u = _lattice_velocity(vel, offsets, px, py, pz)
    mx = px - 0.5 * dt_over_dx * u[0]
    my = py - 0.5 * dt_over_dx * u[1]
    mz = pz - 0.5 * dt_over_dx * u[2]
    um = _velocity_at(vel, mx, my, mz)
    bx = px - dt_over_dx * um[0]
    by = py - dt_over_dx * um[1]
    bz = pz - dt_over_dx * um[2]
    return _trilinear(field, bx, by, bz)


def _hat(t):
    """Linear interpolation kernel: max(0, 1 - |t|)."""
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _window_interp(field, dx_, dy_, dz_, D: int):
    """``field`` sampled at (p + d) for a per-point displacement d =
    (dx_, dy_, dz_) with |d| <= D (clamped), as a weighted sum over the
    (2D+2)^3 static integer shifts: out[p] = sum_o hat(dx-ox) hat(dy-oy)
    hat(dz-oz) field[p+o].  hat is the exact trilinear weight, so for
    |d| <= D this equals gather-based interpolation; the edge-replicated
    border (clamped indices) reproduces the position clamp at the domain
    box.  The sums nest as JAX's: z innermost, then y, then x."""
    dx_ = torch.clamp(dx_, -D, D)
    dy_ = torch.clamp(dy_, -D, D)
    dz_ = torch.clamp(dz_, -D, D)
    offs = list(range(-D, D + 2))
    fpad = field
    for ax, n in enumerate(field.shape):
        idx = torch.clamp(torch.arange(-(D + 1), n + D + 1, device=field.device), 0, n - 1)
        fpad = fpad.index_select(ax, idx)
    n0, n1, n2 = field.shape
    wx = [_hat(dx_ - o) for o in offs]
    wy = [_hat(dy_ - o) for o in offs]
    wz = [_hat(dz_ - o) for o in offs]

    def fma(acc, w, v):
        """acc + w v, in place after the first term (one launch a term)."""
        return w * v if acc is None else acc.addcmul_(w, v)

    out = None
    for ix, ox in enumerate(offs):
        acc_y = None
        for iy, oy in enumerate(offs):
            acc_z = None
            for iz, oz in enumerate(offs):
                sl = fpad[D + 1 + ox:D + 1 + ox + n0, D + 1 + oy:D + 1 + oy + n1, D + 1 + oz:D + 1 + oz + n2]
                acc_z = fma(acc_z, wz[iz], sl)
            acc_y = fma(acc_y, wy[iy], acc_z)
        out = fma(out, wx[ix], acc_y)
    return out


def advect_field(field, vel, dt_over_dx, offsets, max_disp: int = 2, substeps: int = 1):
    """Semi-Lagrangian advection of a field sampled at ``offsets`` in the
    gather-free windowed form of the JAX frame loop.

    The MAC velocity is first resampled to the target's own lattice
    (velocity_at_lattice), so every window interpolation is single-shape.
    Each of ``substeps`` equal sub-intervals then does an RK2 (midpoint)
    backtrace along the frozen velocity, its displacement clamped to
    ``max_disp`` cells (``_window_interp``); with substeps >= ceil(max |u|
    dt/dx / max_disp) (``cfl_substeps``) the clamp is inactive and each
    interpolation is exact trilinear.  The velocity is frozen, so the
    midpoint displacement is the same every substep: it is computed once,
    and the substeps compose interpolations of the field."""
    px, py, pz = _positions(field, offsets)
    u0 = _lattice_velocity(vel, offsets, px, py, pz)
    u0 = [torch.broadcast_to(u, field.shape) for u in u0]
    sub_dt = dt_over_dx / substeps
    D_mid = max(-(-max_disp // 2), 1)

    md = [-0.5 * sub_dt * u0[a] for a in range(3)]
    um = [_window_interp(u0[a], md[0], md[1], md[2], D_mid) for a in range(3)]
    dxs = (-sub_dt * um[0], -sub_dt * um[1], -sub_dt * um[2])
    out = field
    for _ in range(substeps):
        out = _window_interp(out, dxs[0], dxs[1], dxs[2], max_disp)
    return out


def cfl_substeps(vel, dt_over_dx, max_disp: int = 2) -> int:
    """Host-side substep count so each substep's backtrace stays within
    ``max_disp`` cells: ceil(max |u| dt/dx / max_disp), at least 1.  The
    three maxima are reduced on the device and fetched together."""
    m = max(torch.stack([v.abs().amax() for v in vel]).tolist())
    return max(1, int(math.ceil(m * float(dt_over_dx) / max_disp)))


def _gravity_kick(scene: Scene, params: SolverParams, gravity: float = -9.8, gravity_axis: int = 2) -> Scene:
    """The frame's first stage: vel[axis] + gravity dt, in params.dtype."""
    vel = list(scene.velocity)
    g = torch.tensor(gravity, dtype=params.dtype, device=scene.dt.device)
    vel[gravity_axis] = vel[gravity_axis] + g * scene.dt
    return dataclasses.replace(scene, velocity=tuple(vel))


def simulate_frame(grid: Grid, scene: Scene, params: SolverParams, gravity: float = -9.8, gravity_axis: int = 2,
                   substeps: int = 1):
    """One frame: gravity -> Stokes solve -> advect velocity + surface.

    ``substeps`` bounds each advection backtrace to the windowed
    interpolation's clamp (see advect_field / cfl_substeps); ``simulate``
    picks it per frame from the velocity CFL.  Returns (scene, stats)."""
    dtype = params.dtype
    dt_over_dx = scene.dt / torch.tensor(grid.dx, dtype=dtype, device=scene.dt.device)
    scene = _gravity_kick(scene, params, gravity, gravity_axis)

    new_vel, valid, stats = step(grid, scene, params)

    adv_vel = tuple(
        advect_field(new_vel[a], new_vel, dt_over_dx, face_offsets(a), substeps=substeps) for a in range(3)
    )
    surf = advect_field(scene.surface_sdf.to(dtype), new_vel, dt_over_dx, (0.0, 0.0, 0.0), substeps=substeps)
    return dataclasses.replace(scene, velocity=adv_vel, surface_sdf=surf), stats


def simulate(grid: Grid, scene: Scene, params: SolverParams, frames: int, gravity: float = -9.8, callback=None):
    """Run ``frames`` frames; returns the final scene and a list of stats.
    ``callback(k, scene, stats)`` is called after frame k."""
    all_stats = []
    for k in range(frames):
        dt_over_dx = float(scene.dt) / grid.dx
        substeps = cfl_substeps(scene.velocity, dt_over_dx)
        scene, stats = simulate_frame(grid, scene, params, gravity, substeps=substeps)
        all_stats.append(dict(stats))
        if callback is not None:
            callback(k, scene, stats)
    return scene, all_stats
