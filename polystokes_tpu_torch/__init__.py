"""PolyStokes in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``polystokes_tpu`` (JAX / Pallas), which stays the reference.
It runs one implicit Stokes ``step`` on the tiled reduced configuration
(the default: tile 16, padding 2), an untiled one (cube regions or the
reference's general regions) or the uniform one, preconditioned CG (or
BiCGStab or MINRES), through the unpacked apply (``use_pallas=False``,
JAX's default) or the hand-written kernels of the packed path::

    from polystokes_tpu_torch import PreconditionerType, SolverParams, step
    from polystokes_tpu_torch.scenes.builders import honey_coil
    grid, scene = honey_coil(n=128, dtype=torch.float32, device="cuda")
    params = SolverParams(preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)
    velocity, valid, stats = step(grid, scene, params)

``solve_chunked`` runs the same solve in CG segments that can be
interrupted, timed out and resumed from a state file, as the JAX package's.
On the card the CG iteration is replayed from a CUDA graph (``krylov``).
``sim.simulate`` runs frames of gravity, ``step`` and advection, as the
JAX package's frame loop; ``device_warm_start`` starts each solve from
the old velocity.  ``domain.solve_cropped`` solves on the liquid's
bounding box, ``io.checkpoint`` saves and loads scenes in the JAX
package's format, and ``python -m polystokes_tpu_torch.run`` is the CLI.
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
