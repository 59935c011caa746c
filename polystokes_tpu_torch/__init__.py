"""PolyStokes in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``polystokes_tpu`` (JAX / Pallas), which stays the reference.
It runs one implicit Stokes ``step`` on the untiled cube-region reduced
configuration, CELL_ARROW preconditioned CG, on the packed kernel path::

    from polystokes_tpu_torch import SolverParams, step
    from polystokes_tpu_torch.scenes.builders import honey_coil
    grid, scene = honey_coil(n=128, dtype=torch.float32, device="cuda")
    velocity, valid, stats = step(grid, scene, SolverParams(max_regions=64))

Importing the package turns TF32 off (``precision.py``).
"""
from .config import BasisOrder, MatrixScheme, PreconditionerType, SolverParams, SolverType
from .grid import Grid
from .precision import disable_tf32
from .solver import Scene, step

disable_tf32()

__all__ = [
    "BasisOrder",
    "Grid",
    "MatrixScheme",
    "PreconditionerType",
    "Scene",
    "SolverParams",
    "SolverType",
    "step",
]
