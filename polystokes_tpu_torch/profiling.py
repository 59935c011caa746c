"""Per-stage instrumentation and solve statistics, the counterpart of
``polystokes_tpu.profiling``: the reference's per-stage perf-monitor
scopes (exec/HDK_PolyStokes.C:350-568), its setup and solve clocks
(Solver.cpp:920-935) and ``printStats`` (Solver.cpp:608-619).

Each stage runs on its own and is timed on the host clock with the
device synchronised at its end; each is also a
``torch.profiler.record_function`` range, so a ``torch.profiler`` trace
taken around ``step_instrumented`` shows the stages.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from . import krylov
from .classify import classify, effective_max_regions
from .config import SolverParams
from .grid import Grid
from .operators import ravel_ptau, unravel_ptau
from .solver import Scene, _flat, apply_solution_to_velocity, assemble, build_rhs, make_apply, recover_velocity
from .weights import compute_weights


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(name: str, timings: Dict[str, float], device):
    """A named stage: its wall seconds, the device synchronised at its end,
    added to ``timings[name]``, inside a profiler range of that name."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        yield
        _sync(device)
        timings[name] = timings.get(name, 0.0) + (time.perf_counter() - t0)


def step_instrumented(grid: Grid, scene: Scene, params: SolverParams):
    """The pipeline of ``solver.step``, one stage at a time, with the wall
    seconds of each, as the JAX package's: the weights (without the scene's
    input face weights, as there), classify, assemble, the right-hand
    side, then unpreconditioned CG through ``solver.make_apply`` (the packed
    kernels between a pack and an unpack where the step would run packed,
    else the unpacked apply), recovery and write-back.  Returns (velocity,
    valid, stats); stats hold the reference's printed fields and the
    per-stage breakdown."""
    R = effective_max_regions(grid, params)
    device = scene.surface_sdf.device
    t: Dict[str, float] = {}
    setup0 = time.perf_counter()
    with trace("build_integration_weights", t, device):
        lw, fw = compute_weights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
    with trace("classify", t, device):
        cls = classify(grid, lw, fw, params)
    with trace("assemble", t, device):
        asm, _ = assemble(grid, scene, cls, lw, fw, params, R)
    with trace("build_rhs", t, device):
        b = ravel_ptau(build_rhs(grid, cls, asm, params, R))
    setup_s = time.perf_counter() - setup0

    apply_A = _flat(make_apply(grid, cls, asm, params, R), grid)
    solve0 = time.perf_counter()
    with trace("solve", t, device):
        res = krylov.pcg(apply_A, b, torch.zeros_like(b), tol=params.tolerance, max_iters=params.max_iterations)
    solve_s = time.perf_counter() - solve0

    with trace("recover_velocity", t, device):
        v, w = recover_velocity(grid, cls, asm, unravel_ptau(res.x, grid), params, R)
    with trace("apply_solution", t, device):
        vel, valid = apply_solution_to_velocity(grid, cls, asm, scene, v, w, params)

    iters = int(res.iterations)
    stats = {
        "iterations": iters,
        "error": float(res.error),
        "converged": bool(res.converged),
        "n_regions": int(cls.n_regions),
        "setup_wall_s": setup_s,
        "solve_wall_s": solve_s,
        "solve_s_per_iteration": solve_s / max(iters, 1),
        "stage_wall_s": t,
    }
    return vel, valid, stats


def print_stats(stats: dict):
    """printStats parity (Solver.cpp:608-619)."""
    print(f"Setup wall time: {stats['setup_wall_s']*1e3:.1f} ms")
    print(f"Solve wall time: {stats['solve_wall_s']*1e3:.1f} ms")
    print(f"Solve iterations: {stats['iterations']}")
    print(f"Solve error: {stats['error']:.3e}")
    for k, v in stats.get("stage_wall_s", {}).items():
        print(f"  {k}: {v*1e3:.1f} ms")
