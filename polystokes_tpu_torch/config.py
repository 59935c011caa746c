"""Configuration for the PyTorch port of the PolyStokes solver.

The same schema as ``polystokes_tpu.config``: the enums, the reference
constants and one frozen ``SolverParams`` with every field, the dtype as a
torch dtype.  The port implements these families on the packed kernel
path with CELL_ARROW, REGION_ARROW, DIAGONAL or IDENTITY preconditioned
CG:

* the tiled reduced step (``do_reduced_regions=True``, ``do_tile=True``
  with ``tile_padding >= 1``, the JAX default): one region per tile cube
  at most;
* the untiled cube-region reduced step (``do_tile=False``,
  ``cube_regions=True``);
* the uniform step (``do_reduced_regions=False``), the baseline the
  reduced step is measured against;

each with ``fuse_pap`` on (the fused apply that also returns <p, A p>,
the JAX default) or off, and ``fuse_update`` (the fused CG update, with
``fuse_expand`` choosing the kernel that expands the region polynomials in
place) on or off.  A field set to a value outside these families
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it;
nothing is ignored silently.  Where the JAX default lies outside them
(``preconditioner``, ``bicgstab_fallback``, ``use_pallas``) the port's
default is the supported value.
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

# (field, supported values, ROADMAP.md item that ports the other values)
_UNSUPPORTED = (
    ("cube_regions", (True,), "Queue 1 item 6 (segmented general regions)"),
    ("basis", (BasisOrder.QUADRATIC,), "Queue 1 item 11 (affine basis)"),
    ("cc_host_callback", (False,), "Queue 1 item 3 (host connected components)"),
    ("matrix_scheme", (MatrixScheme.PRESSURE_STRESS,), "Queue 1 item 13 (host explicit schemes)"),
    ("solver_type", (SolverType.PCG_MATRIX_VECTOR_PRODUCTS,), "Queue 1 item 11 (other solvers)"),
    ("preconditioner", (PreconditionerType.CELL_ARROW, PreconditionerType.REGION_ARROW, PreconditionerType.DIAGONAL,
                        PreconditionerType.IDENTITY), "Queue 1 item 15 (multigrid)"),
    ("bicgstab_fallback", (False,), "Queue 1 item 11 (BiCGStab fallback)"),
    ("deflation", (False,), "Queue 1 item 15 (deflation)"),
    ("coeff_bf16", (False,), "Queue 1 item 15 (bf16 coefficients)"),
    ("use_pallas", (True,), "Queue 1 item 7 (the unpacked apply)"),
    ("device_warm_start", (False,), "Queue 1 item 11 (device warm start)"),
    ("export_matrices", (False,), "Queue 1 item 13 (export)"),
    ("export_component_matrices", (False,), "Queue 1 item 13 (export)"),
    ("export_stats", (False,), "Queue 1 item 13 (export)"),
)


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """All solver knobs of ``polystokes_tpu.config.SolverParams``.

    ``use_warm_start`` feeds only the host EIGEN path and the ``mg_*``
    knobs only under MULTIGRID, exactly as in the JAX package; each of those
    switches raises above.  ``fuse_expand`` acts only under ``fuse_update``
    on the reduced step."""

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
    preconditioner: PreconditionerType = PreconditionerType.CELL_ARROW
    bicgstab_fallback: bool = False
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

    # -- packed kernel path (packed_apply.py)
    use_pallas: bool = True

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
        if self.do_reduced_regions and self.do_tile and self.tile_padding == 0:
            # tiles without padding slabs: JAX's packed path refuses them and
            # runs the unpacked apply (pallas_apply.pallas_compatible)
            raise NotImplementedError(
                "SolverParams.do_tile=True with tile_padding=0 is not ported yet "
                "(only tile_padding >= 1); see ROADMAP.md Queue 1 item 7 (the unpacked apply)"
            )
        for name, supported, item in _UNSUPPORTED:
            if getattr(self, name) not in supported:
                raise NotImplementedError(
                    f"SolverParams.{name}={getattr(self, name)!r} is not ported yet "
                    f"(only {' or '.join(repr(v) for v in supported)}); see ROADMAP.md {item}"
                )

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)
