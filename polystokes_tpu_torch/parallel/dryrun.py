"""A small sharded step as a dry run of the mesh path, the counterpart of
``__graft_entry__.dryrun_multichip`` of the JAX package."""
from __future__ import annotations

import torch

from ..config import PreconditionerType, SolverParams
from ..scenes.builders import honey_coil
from .sharding import make_mesh, shard_scene, sharded_step


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run one step of honey_coil 16^3 on a ``make_mesh`` of ``n_devices``
    copies of ``device`` (the card unless the caller names the CPU):
    JAX's case (f32, tiled, tile 8 with padding 1, CELL_ARROW, no fallback,
    at most 50 iterations, its default apply).  Raises on a degenerate mesh
    or a step that made no progress; returns the step's stats."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu' to run on the CPU")
    mesh = make_mesh([device] * n_devices)
    if mesh.size != n_devices:  # never report ok on a degenerate mesh
        raise RuntimeError(f"mesh size {mesh.size} != requested {n_devices}")
    params = SolverParams(dtype=torch.float32, do_reduced_regions=True, do_tile=True, tile_size=8, tile_padding=1,
                          max_iterations=50, bicgstab_fallback=False, preconditioner=PreconditionerType.CELL_ARROW)
    grid, scene = honey_coil(n=16, dtype=torch.float32, device=device)
    _, _, stats = sharded_step(grid, params, mesh)(shard_scene(scene, mesh))
    iters = int(stats["iterations"])
    if iters <= 0:
        raise RuntimeError(f"sharded step made no progress (iterations={iters})")
    print(f"dryrun_multichip ok on {n_devices} devices: mesh={mesh.shape}, iters={iters}, "
          f"err={float(stats['error']):.3e}, sharded={stats['sharded']}")
    return stats
