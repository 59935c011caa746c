"""Programmatic scene builders, the counterparts of
``polystokes_tpu.scenes.builders``: each is an analytic SDF configuration
on the MAC grid.  All return ``(Grid, Scene)`` with every tensor on
``device``, the CUDA card unless the caller passes ``device="cpu"`` (with
no card, torch raises); the domain is the unit cube."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import sdf
from ..grid import Grid
from ..solver import Scene


def _zero_faces(grid: Grid, dtype, device):
    return tuple(torch.zeros(grid.face_shape(a), dtype=dtype, device=device) for a in range(3))


def _base(grid: Grid, surface, collision, dtype, device, dt, viscosity, velocity=None, collision_velocity=None):
    surf = sdf.sample_at_centers(surface, grid.res, grid.dx, dtype, device)
    coll = sdf.sample_at_centers(collision, grid.res, grid.dx, dtype, device)
    vel = velocity if velocity is not None else _zero_faces(grid, dtype, device)
    svel = collision_velocity if collision_velocity is not None else _zero_faces(grid, dtype, device)
    return Scene(
        surface_sdf=surf,
        collision_sdf=coll,
        velocity=vel,
        collision_velocity=svel,
        viscosity=torch.full(grid.res, viscosity, dtype=dtype, device=device),
        dt=torch.tensor(dt, dtype=dtype, device=device),
    )


def _gravity_velocity(grid: Grid, dtype, device, g=-9.8, dt=1 / 24, axis=2):
    vel = list(_zero_faces(grid, dtype, device))
    vel[axis] = torch.full(grid.face_shape(axis), g * dt, dtype=dtype, device=device)
    return tuple(vel)


def viscous_beam(n: int = 64, dtype=torch.float32, device="cuda", viscosity: float = 20.0, dt: float = 1 / 24) -> Tuple[Grid, Scene]:
    """A horizontal beam of liquid clamped into a wall on the -x side."""
    grid = Grid(res=(n, n, n), dx=1.0 / n)
    beam = sdf.box((0.0, 0.35, 0.55), (0.8, 0.65, 0.8))
    wall = sdf.box((-0.2, -0.2, -0.2), (0.08, 1.2, 1.2))
    floor = sdf.plane((0, 0, 1.0), 0.05)
    scene = _base(grid, beam, sdf.union(wall, floor), dtype, device, dt, viscosity,
                  velocity=_gravity_velocity(grid, dtype, device, dt=dt))
    return grid, scene


def honey_coil(n: int = 128, dtype=torch.float32, device="cuda", viscosity: float = 50.0, dt: float = 1 / 48) -> Tuple[Grid, Scene]:
    """A viscous column falling onto a pool: the 128^3 benchmark scene."""
    grid = Grid(res=(n, n, n), dx=1.0 / n)
    column = sdf.capsule((0.5, 0.5, 0.35), (0.5, 0.5, 0.95), 0.08)
    pool = sdf.box((0.05, 0.05, 0.02), (0.95, 0.95, 0.22))
    coil = sdf.torus((0.5, 0.5, 0.26), 0.1, 0.05, axis=2)
    floor = sdf.plane((0, 0, 1.0), 0.02)
    scene = _base(grid, sdf.union(column, pool, coil), floor, dtype, device, dt, viscosity,
                  velocity=_gravity_velocity(grid, dtype, device, dt=dt))
    return grid, scene


def armadillo_melt(n: int = 96, dtype=torch.float32, device="cuda", viscosity: float = 10.0, dt: float = 1 / 24) -> Tuple[Grid, Scene]:
    """A blobby standing mass melting onto the floor."""
    grid = Grid(res=(n, n, n), dx=1.0 / n)
    body = sdf.union(
        sdf.sphere((0.5, 0.5, 0.42), 0.22),
        sdf.sphere((0.5, 0.5, 0.66), 0.15),
        sdf.capsule((0.34, 0.5, 0.3), (0.24, 0.5, 0.12), 0.07),
        sdf.capsule((0.66, 0.5, 0.3), (0.76, 0.5, 0.12), 0.07),
        sdf.capsule((0.36, 0.5, 0.52), (0.2, 0.5, 0.4), 0.06),
        sdf.capsule((0.64, 0.5, 0.52), (0.8, 0.5, 0.4), 0.06),
        sdf.box((0.1, 0.1, 0.02), (0.9, 0.9, 0.1)),
    )
    floor = sdf.plane((0, 0, 1.0), 0.02)
    scene = _base(grid, body, floor, dtype, device, dt, viscosity,
                  velocity=_gravity_velocity(grid, dtype, device, dt=dt))
    return grid, scene


def jelly_jam(n: int = 64, dtype=torch.float32, device="cuda", viscosity: float = 30.0, dt: float = 1 / 24) -> Tuple[Grid, Scene]:
    """Viscous blobs inside a jar-shaped solid."""
    grid = Grid(res=(n, n, n), dx=1.0 / n)
    jar_outer = sdf.box((0.1, 0.1, 0.02), (0.9, 0.9, 0.9))
    jar_inner = sdf.box((0.18, 0.18, 0.1), (0.82, 0.82, 1.2))
    jar = sdf.intersection(jar_outer, sdf.complement(jar_inner))
    blobs = sdf.union(
        sdf.sphere((0.4, 0.45, 0.4), 0.16),
        sdf.sphere((0.6, 0.55, 0.55), 0.14),
        sdf.sphere((0.5, 0.4, 0.68), 0.12),
        sdf.box((0.22, 0.22, 0.12), (0.78, 0.78, 0.3)),
    )
    scene = _base(grid, blobs, jar, dtype, device, dt, viscosity,
                  velocity=_gravity_velocity(grid, dtype, device, dt=dt))
    return grid, scene


def jelly_jam_si(n: int = 64, dtype=torch.float32, device="cuda", viscosity: float = 400.0, density: float = 1000.0, dt: float = 1 / 24) -> Tuple[Grid, Scene]:
    """jelly_jam at the reference scene file's SI parameters (viscosity
    400 kg/(m s), density 1000 kg/m^3, dt 1/24)."""
    grid, scene = jelly_jam(n=n, dtype=dtype, device=device, viscosity=viscosity, dt=dt)
    density_field = torch.full(grid.res, density, dtype=dtype, device=device)
    return grid, dataclasses.replace(scene, density=density_field)


def armadillo_melt_si(n: int = 256, dtype=torch.float32, device="cuda", viscosity: float = 400.0, density: float = 1000.0, dt: float = 1 / 24) -> Tuple[Grid, Scene]:
    """armadillo_melt at the reference's SI parameter regime."""
    grid, scene = armadillo_melt(n=n, dtype=dtype, device=device, viscosity=viscosity, dt=dt)
    density_field = torch.full(grid.res, density, dtype=dtype, device=device)
    return grid, dataclasses.replace(scene, density=density_field)


def conveyor_belt(n: int = 64, dtype=torch.float32, device="cuda", viscosity: float = 15.0, dt: float = 1 / 24, belt_speed: float = 0.5) -> Tuple[Grid, Scene]:
    """Liquid blob resting on a moving solid belt."""
    grid = Grid(res=(n, n, n), dx=1.0 / n)
    blob = sdf.union(
        sdf.sphere((0.35, 0.5, 0.35), 0.15),
        sdf.box((0.2, 0.35, 0.13), (0.6, 0.65, 0.3)),
    )
    belt = sdf.plane((0, 0, 1.0), 0.16)
    svel = list(_zero_faces(grid, dtype, device))
    svel[0] = torch.full(grid.face_shape(0), belt_speed, dtype=dtype, device=device)
    scene = _base(grid, blob, belt, dtype, device, dt, viscosity,
                  velocity=_gravity_velocity(grid, dtype, device, dt=dt),
                  collision_velocity=tuple(svel))
    return grid, scene


SCENES = {
    "viscous_beam": viscous_beam,
    "honey_coil": honey_coil,
    "armadillo_melt": armadillo_melt,
    "jelly_jam": jelly_jam,
    "jelly_jam_si": jelly_jam_si,
    "conveyor_belt": conveyor_belt,
}
