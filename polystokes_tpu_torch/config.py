"""Configuration for the PyTorch port of the PolyStokes solver.

The same schema as ``polystokes_tpu.config``, with the same defaults: the
enums, the reference constants and one frozen ``SolverParams`` with every
field, the dtype as a torch dtype.  The port runs preconditioned CG
(IDENTITY, the default, DIAGONAL, CELL_ARROW, REGION_ARROW or MULTIGRID;
with JAX's BiCGStab fallback when CG does not converge, on by default as
in JAX), or unpreconditioned BiCGStab or MINRES (``solver_type``), on

* the tiled reduced step (``do_reduced_regions=True``, ``do_tile=True``,
  the JAX default), with any ``tile_padding``;
* the untiled reduced step (``do_tile=False``) with cube regions
  (``cube_regions=True``) or the reference's general region shapes
  (``cube_regions=False``);
* the uniform step (``do_reduced_regions=False``), the baseline the
  reduced step is measured against;

in either basis (``basis`` QUADRATIC, the default, or AFFINE, the CLI's
``--affine``), through one of two applies, picked as the JAX package
picks them (``solver._use_packed``): the unpacked apply on (p, tau)
fields (``use_pallas=False``, the default), or the hand-written CUDA
kernels on packed [7, nx, ny, nz] vectors (``use_pallas=True``, where the
packed layout takes the configuration; never under MULTIGRID), with
``fuse_pap``, ``fuse_update`` and ``fuse_expand`` choosing among the
packed kernels.  Untiled, ``cc_host_callback`` labels the connected
components on the host (``classify.connected_components_host``).

Every value of JAX's accepts here too.  As there, ``step`` always runs the
factored pressure-stress system: ``matrix_scheme`` and ``solver_type``
EIGEN act on the host explicit path (``host_solve.solve``, the CLI's
``--solver eigen``), and ``step`` handed EIGEN runs MINRES; the export
switches drive the CLI's export (``export.py``).
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class MatrixScheme(enum.Enum):
    """Which system layout to assemble (reference: units.h:76-83)."""

    PRESSURE_STRESS = "pressure_stress"
    ALL_DOFS = "all_dofs"
    PRESSURE_VELOCITY = "pressure_velocity"
    ALL_DOFS_EXPLICIT_INTERIOR_STRESS = "all_dofs_explicit_interior_stress"


class SolverType(enum.Enum):
    """Which Krylov solver to use (reference: units.h:85-94)."""

    PCG_MATRIX_VECTOR_PRODUCTS = "pcg_matrix_vector_products"
    BICGSTAB = "bicgstab"
    MINRES = "minres"
    EIGEN = "eigen"


class PreconditionerType(enum.Enum):
    """Preconditioner choice (reference: units.h:47-53, plus the device
    CELL_ARROW / MULTIGRID / REGION_ARROW additions of the JAX package)."""

    IDENTITY = "identity"
    DIAGONAL = "diagonal"
    CELL_ARROW = "cell_arrow"
    MULTIGRID = "multigrid"
    REGION_ARROW = "region_arrow"


class BasisOrder(enum.Enum):
    """Polynomial reduction basis (reference: units.h:9-18)."""

    QUADRATIC = 26
    AFFINE = 11


# Reference constants (exec/HDK_PolyStokesSolver.h:226-227).
MINWEIGHT = 0.1
NSAMPLES = 2


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """All solver knobs of ``polystokes_tpu.config.SolverParams``.

    ``device_warm_start`` with ``use_warm_start`` seeds the device CG with
    the warm-start guess (``solver._warm_guess``), as in the JAX package.
    There ``use_warm_start`` alone feeds only the host EIGEN path
    (``host_solve.solve_host``); the ``mg_*`` knobs act only under
    MULTIGRID.  ``fuse_expand`` acts only under ``fuse_update`` on the
    reduced step."""

    # -- discretization / solve control
    tolerance: float = 1e-3
    max_iterations: int = 5000
    do_solve: bool = True
    keep_non_converged: bool = True
    use_warm_start: bool = True
    device_warm_start: bool = False

    # -- reduction topology
    do_reduced_regions: bool = True
    do_tile: bool = True
    tile_size: int = 16
    tile_padding: int = 2
    liquid_boundary_layer_size: int = 2
    solid_boundary_layer_size: int = 2
    basis: BasisOrder = BasisOrder.QUADRATIC
    max_regions: int = 1024
    region_fix_max_iters: int = 8
    cc_host_callback: bool = False
    cube_regions: bool = True

    # -- material
    constant_density: float = 1.0
    min_density: float = 1.0
    max_density: float = 100000.0

    # -- matrix & solver scheme
    matrix_scheme: MatrixScheme = MatrixScheme.PRESSURE_STRESS
    solver_type: SolverType = SolverType.PCG_MATRIX_VECTOR_PRODUCTS
    preconditioner: PreconditionerType = PreconditionerType.IDENTITY
    bicgstab_fallback: bool = True
    deflation: bool = False
    deflation_tile: int = 0
    fuse_pap: bool = True
    fuse_update: bool = False
    fuse_expand: bool = True
    coeff_bf16: bool = False

    # -- multigrid preconditioner knobs
    mg_levels: int = 5
    mg_coarsest: int = 4
    mg_smooth_degree: int = 3
    mg_coarse_iters: int = 4

    # -- numerics
    dtype: torch.dtype = torch.float32

    # -- the packed kernel path (packed_apply.py); off: the unpacked apply
    use_pallas: bool = False

    # -- observability
    export_matrices: bool = False
    export_component_matrices: bool = False
    export_stats: bool = False
    export_prefix: str = "output_data/polystokes."

    @property
    def reduced_dof(self) -> int:
        return self.basis.value

    @property
    def effective_density(self) -> float:
        """constant_density clamped into [min_density, max_density]."""
        return min(max(self.constant_density, self.min_density), self.max_density)

    def __post_init__(self):
        if self.min_density > self.max_density:
            raise ValueError(f"min_density {self.min_density} > max_density {self.max_density}")
        if self.tile_size < 1 or self.tile_padding < 0:
            raise ValueError("tile_size >= 1 and tile_padding >= 0 required")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {self.dtype}")

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)
