"""Scene and simulation-state checkpoints, the counterpart of
``polystokes_tpu.io.checkpoint``, in its file format.

The reference relies on Houdini's sim-cache files for frame resume.  Here
a checkpoint is a self-contained npz snapshot of the Scene plus named
extra state, and ``SolverParams`` round-trip through JSON (enums by name,
the dtype as "float32" or "float64").  The npz keys and the JSON are the
JAX package's, so a checkpoint written by either package loads in the
other.  The snapshot holds the SDFs, viscosity, dt, velocities and
collision velocities, as there, and also, where the scene has them,
``scene.density`` and the input face weights (``surface_weights``,
``collision_weights``), under the format's own ``extra_`` keys
(``extra_scene_density``, ``extra_scene_surface_weights0``..2,
``extra_scene_collision_weights0``..2), which the load restores into the
scene.  The JAX package writes none of the three, so a resumed SI scene
lost its density there; its loader returns ``extra_*`` entries without
reading them, so either package still loads the other's files.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import BasisOrder, MatrixScheme, PreconditionerType, SolverParams, SolverType
from ..grid import Grid
from ..solver import Scene

_ENUMS = {
    "matrix_scheme": MatrixScheme,
    "solver_type": SolverType,
    "preconditioner": PreconditionerType,
    "basis": BasisOrder,
}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the Scene fields the JAX format leaves out, written under extra_<_SCENE>...
_SCENE = "scene_"
_FACE_FIELDS = ("surface_weights", "collision_weights")


def params_to_json(params: SolverParams) -> str:
    d = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)}
    for k in _ENUMS:
        d[k] = d[k].name
    d["dtype"] = str(params.dtype).removeprefix("torch.")
    return json.dumps(d, indent=2)


def params_from_json(s: str, base: SolverParams = None) -> SolverParams:
    """Decode SolverParams from JSON.  With ``base``, the JSON is a partial
    override: only the keys present replace the base's fields (how the
    CLI's --params composes with its other flags)."""
    d = json.loads(s)
    for k, enum_t in _ENUMS.items():
        if k in d and isinstance(d[k], str):
            d[k] = enum_t[d[k]]
    if "dtype" in d:
        d["dtype"] = _DTYPES[d["dtype"]]
    if base is not None:
        return dataclasses.replace(base, **d)
    return SolverParams(**d)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(path: str, grid: Grid, scene: Scene, params: SolverParams, step_index: int = 0,
                    extra: dict = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "surface_sdf": _np(scene.surface_sdf),
        "collision_sdf": _np(scene.collision_sdf),
        "viscosity": _np(scene.viscosity),
        "dt": _np(scene.dt),
        "res": np.asarray(grid.res),
        "dx": np.asarray(grid.dx),
        "step_index": np.asarray(step_index),
    }
    for a in range(3):
        payload[f"velocity{a}"] = _np(scene.velocity[a])
        payload[f"collision_velocity{a}"] = _np(scene.collision_velocity[a])
    if scene.density is not None:
        payload[f"extra_{_SCENE}density"] = _np(scene.density)
    for name in _FACE_FIELDS:
        for a, t in enumerate(getattr(scene, name) or ()):
            payload[f"extra_{_SCENE}{name}{a}"] = _np(t)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = _np(v)
    np.savez_compressed(path, params_json=params_to_json(params), **payload)


def load_checkpoint(path: str, device="cuda"):
    """(grid, scene, params, step_index, extra): the scene's tensors on
    ``device`` (the card unless the caller asks for the CPU) in the params'
    dtype, the density and input face weights restored where the file has
    them; ``extra`` holds the other ``extra_`` entries as numpy arrays."""
    with np.load(path, allow_pickle=False) as d:
        params = params_from_json(str(d["params_json"]))
        grid = Grid(res=tuple(int(x) for x in d["res"]), dx=float(d["dx"]))

        def t(key):
            return torch.as_tensor(d[key], dtype=params.dtype, device=device)

        def faces(name):
            keys = [f"extra_{_SCENE}{name}{a}" for a in range(3)]
            return tuple(t(k) for k in keys) if all(k in d.files for k in keys) else None

        density_key = f"extra_{_SCENE}density"
        scene = Scene(
            surface_sdf=t("surface_sdf"),
            collision_sdf=t("collision_sdf"),
            velocity=tuple(t(f"velocity{a}") for a in range(3)),
            collision_velocity=tuple(t(f"collision_velocity{a}") for a in range(3)),
            viscosity=t("viscosity"),
            dt=t("dt"),
            surface_weights=faces("surface_weights"),
            collision_weights=faces("collision_weights"),
            density=t(density_key) if density_key in d.files else None,
        )
        extra = {k[6:]: d[k] for k in d.files if k.startswith("extra_") and not k.startswith(f"extra_{_SCENE}")}
        step_index = int(d["step_index"])
    return grid, scene, params, step_index, extra
