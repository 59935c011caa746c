"""Host-side explicit solve path — the analog of the reference's EIGEN
SolverType (solveEigenCG with solveWithGuess, Solver.cpp:814-862), the
counterpart of ``polystokes_tpu.host_solve``.

Unlike the device ``step`` (which always runs the factored
pressure-stress scheme, like the reference's PCG_MATRIX_VECTOR_PRODUCTS
path), this dispatches on ``params.matrix_scheme`` (assemble(),
AssembleSystem.cpp:4-37) and honors ``params.use_warm_start``
(constructGuessVectors, Solver.cpp:521-531).  Setup (weights, classify,
assembly) runs on the scene's device; the Krylov solve runs in scipy on
the explicit sparse system; the write-back runs on the device again.
"""
from __future__ import annotations

import numpy as np
import torch

from .classify import classify, effective_max_regions
from .config import MatrixScheme, SolverParams, SolverType
from .grid import Grid
from .solver import Scene, _weights, apply_solution_to_velocity, assemble

_SCHEME_NAMES = {
    MatrixScheme.PRESSURE_STRESS: "pressure_stress",
    MatrixScheme.ALL_DOFS: "all_dofs",
    MatrixScheme.PRESSURE_VELOCITY: "pressure_velocity",
    MatrixScheme.ALL_DOFS_EXPLICIT_INTERIOR_STRESS: "all_dofs_explicit_interior_stress",
}


def _unpack_faces(x_v, ops, grid, dtype, device):
    """Packed velocity vector -> 3 face tensors on ``device``."""
    out = []
    off = 0
    for a in range(3):
        arr = np.zeros(grid.face_shape(a), dtype=np.float64)
        arr[ops.face_idx[a] >= 0] = x_v[off:off + ops.nF[a]]
        out.append(torch.as_tensor(arr, dtype=dtype, device=device))
        off += ops.nF[a]
    return tuple(out)


def solve_host(grid: Grid, scene: Scene, params: SolverParams, method: str = "auto"):
    """One Stokes solve via the explicit host path.  Returns
    (new_velocity, valid_masks, stats) like ``step``, the velocities on the
    scene's device; ``stats`` holds JAX's keys, as Python scalars."""
    from .export import solve_explicit

    R = effective_max_regions(grid, params)
    dev = scene.surface_sdf.device
    liquid_w, fluid_w = _weights(grid, scene, params)
    cls = classify(grid, liquid_w, fluid_w, params)
    asm, _ = assemble(grid, scene, cls, liquid_w, fluid_w, params, R)

    scheme = _SCHEME_NAMES[params.matrix_scheme]
    iters = [0]

    def _count(_xk):
        iters[0] += 1

    x, ops, info = solve_explicit(
        grid, cls, asm, params,
        scheme=scheme,
        warm_start=params.use_warm_start,
        weights=(liquid_w, fluid_w),
        viscosity=scene.viscosity,
        method=method,
        callback=_count,
    )

    dt = float(asm.dt)
    if scheme == "pressure_stress":
        p = x[:ops.nP]
        t = x[ops.nP:]
        v = ops.vectors()
        McInv, G, Dt = ops.McInv(), ops.G(), ops.Dt()
        x_v = McInv @ v["activeRHS"] - dt * (McInv @ (G @ p + Dt @ t))
        if ops.R:
            x_w = ops.BInv() @ (v["reducedRHS"] / dt - ops.JG() @ p - ops.JDt() @ t)
        else:
            x_w = np.zeros(0)
    else:
        x_v = x[:ops.nV]
        x_w = x[ops.nV:ops.nV + ops.nW]

    vel_faces = _unpack_faces(x_v, ops, grid, params.dtype, dev)
    D = params.reduced_dof
    w = torch.as_tensor(x_w.reshape(R, D) if ops.nW else np.zeros((R, D)), dtype=params.dtype, device=dev)
    new_vel, valid = apply_solution_to_velocity(grid, cls, asm, scene, vel_faces, w, params)

    stats = {
        "iterations": iters[0],
        "converged": info == 0,
        "scheme": scheme,
        "n_regions": int(cls.n_regions),
        "solver": "eigen_host",
    }
    return new_vel, valid, stats


def solve(grid: Grid, scene: Scene, params: SolverParams):
    """Solver dispatch (Solver::solve, Solver.cpp:644-692): EIGEN goes to
    the host explicit path, everything else to the device step."""
    from .solver import step

    if params.solver_type == SolverType.EIGEN:
        return solve_host(grid, scene, params)
    return step(grid, scene, params)
