"""Carry state over from the JAX package, so that both packages compute
from identical inputs.  Nothing here imports JAX: the functions read
attributes, enum values and numpy arrays (``np.asarray`` of each field).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config
from .flip import FlipState
from .grid import Grid
from .solver import Scene

_ENUMS = {
    "basis": config.BasisOrder,
    "matrix_scheme": config.MatrixScheme,
    "solver_type": config.SolverType,
    "preconditioner": config.PreconditionerType,
}


def torch_dtype(dtype) -> torch.dtype:
    """numpy-compatible dtype (a jnp dtype included) -> torch dtype."""
    return {"float32": torch.float32, "float64": torch.float64}[np.dtype(dtype).name]


def params_from_jax(p) -> config.SolverParams:
    """The JAX package's SolverParams -> the port's (every field)."""
    kw = {}
    for f in dataclasses.fields(config.SolverParams):
        val = getattr(p, f.name)
        if f.name in _ENUMS:
            val = _ENUMS[f.name](val.value)
        elif f.name == "dtype":
            val = torch_dtype(val)
        kw[f.name] = val
    return config.SolverParams(**kw)


def grid_from_jax(g) -> Grid:
    return Grid(res=tuple(int(n) for n in g.res), dx=float(g.dx))


def _tensor(a, device, dtype=None):
    arr = np.asarray(a)
    t = torch.from_numpy(np.array(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def scene_from_numpy(scene, device, dtype=None) -> Scene:
    """Any object with the Scene fields (a JAX Scene included) -> the
    port's Scene on ``device``, each field through ``np.asarray``;
    ``dtype`` casts the float fields when given."""

    def opt_faces(v):
        return None if v is None else tuple(_tensor(a, device, dtype) for a in v)

    return Scene(
        surface_sdf=_tensor(scene.surface_sdf, device, dtype),
        collision_sdf=_tensor(scene.collision_sdf, device, dtype),
        velocity=tuple(_tensor(a, device, dtype) for a in scene.velocity),
        collision_velocity=tuple(_tensor(a, device, dtype) for a in scene.collision_velocity),
        viscosity=_tensor(scene.viscosity, device, dtype),
        dt=_tensor(scene.dt, device, dtype),
        surface_weights=opt_faces(scene.surface_weights),
        collision_weights=opt_faces(scene.collision_weights),
        density=None if scene.density is None else _tensor(scene.density, device, dtype),
    )


def flip_state_from_numpy(state, device, dtype=None):
    """Any object with FlipState's fields (a JAX FlipState included) ->
    the port's ``flip.FlipState`` on ``device``, each field through
    ``np.asarray``; ``dtype`` casts the three when given."""
    return FlipState(pos=_tensor(state.pos, device, dtype), vel=_tensor(state.vel, device, dtype),
                     alive=_tensor(state.alive, device, dtype))


def flip_state_to_numpy(state) -> dict:
    """The port's FlipState -> {"pos", "vel", "alive"} numpy arrays, the
    keyword arguments of a JAX FlipState."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in ("pos", "vel", "alive")}
