"""PolyStokes in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``polystokes_tpu`` (JAX / Pallas), which stays the reference.
It runs one implicit Stokes ``step`` on the tiled reduced configuration
(the default: tile 16, padding 2), the untiled cube-region one or the
uniform one, CELL_ARROW preconditioned CG, on the packed kernel path::

    from polystokes_tpu_torch import SolverParams, step
    from polystokes_tpu_torch.scenes.builders import honey_coil
    grid, scene = honey_coil(n=128, dtype=torch.float32, device="cuda")
    velocity, valid, stats = step(grid, scene, SolverParams())

``solve_chunked`` runs the same solve in CG segments that can be
interrupted, timed out and resumed from a state file, as the JAX package's.
On the card the CG iteration is replayed from a CUDA graph (``krylov``).
Importing the package turns TF32 off (``precision.py``).
"""
from .config import BasisOrder, MatrixScheme, PreconditionerType, SolverParams, SolverType
from .grid import Grid
from .precision import disable_tf32
from .solver import Scene, solve_chunked, step

disable_tf32()

__all__ = [
    "BasisOrder",
    "Grid",
    "MatrixScheme",
    "PreconditionerType",
    "Scene",
    "SolverParams",
    "SolverType",
    "solve_chunked",
    "step",
]
