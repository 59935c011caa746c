"""One implicit Stokes step: weights -> classify -> reduce -> assemble ->
solve -> recover -> write back, the counterpart of ``polystokes_tpu.solver``
(reference: exec/HDK_PolyStokes.C:222-609 ``solveGasSubclass``).

Every tensor lives on the device of the scene's tensors.  The Krylov loop
runs on one of two layouts, picked as the JAX package picks them
(``_use_packed``):

* unpacked (``use_pallas=False``, the default): the apply of
  ``make_apply`` on (p, tau) fields in plain torch ops, the JAX package's
  XLA apply, on one flat vector (``operators.ravel_ptau``); it launches no
  hand-written kernel.
* packed (``use_pallas=True`` where the packed layout takes the
  configuration): [7, nx, ny, nz] vectors through the kernels of
  ``packed_apply``.  The reduced apply is per-cube moments -> the small
  per-cube region algebra -> polynomial expand -> the reduced apply; with
  ``fuse_pap`` each CG iteration instead runs the fused grid branch with
  moments and <p, A p> partials -> region algebra -> expand -> finish.  The
  uniform solve (``do_reduced_regions=False``) runs one kernel per apply.
  With ``fuse_update`` and a pointwise preconditioner (CELL_ARROW,
  DIAGONAL, IDENTITY) one kernel does the CG's vector update,
  preconditioner and dots; under ``fuse_pap`` on the reduced step it also
  does the finish (and with ``fuse_expand`` the expand), which the apply
  then defers to it.  ``coeff_bf16`` stores the kernels' coefficient stack
  and reduced-face masks in bfloat16 (the arithmetic stays in the compute
  dtype); the unpacked path ignores it, as JAX's does.

On either layout ``deflation`` wraps the preconditioner in the A-DEF2
two-level correction of ``deflation.py`` and projects the initial guess;
the fused update is then off, as in JAX.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from . import krylov
from .basis import monomial_matrix, monomial_shift_matrix, n_monomials
from .classify import REDUCED, SOLID, UNSOLVED, Classification, classify, effective_max_regions, is_active
from .config import MINWEIGHT, PreconditionerType, SolverParams, SolverType
from .deflation import (
    build_deflation,
    deflate_guess_packed,
    deflate_guess_ptau,
    deflated_precond_packed,
    deflated_precond_ptau,
    deflation_supported,
)
from .grid import EDGE_OFFSET_AXES, Grid
from .operators import (
    Assembled,
    PTau,
    build_diagonals,
    build_gated_weights,
    coeff_fields,
    face_at_cell,
    forward_face_values,
    ravel_ptau,
    scatter_face_to_edge,
    transpose_from_faces,
    unravel_ptau,
)
from .packed_apply import (
    _edge_to_slot,
    _face_to_slot,
    apply_reduced_packed,
    apply_uniform_packed,
    apply_uniform_pap_packed,
    cg_update_packed,
    exp_finish_update_packed,
    expand_packed,
    finish_packed,
    finish_update_packed,
    grid_mom_pap_packed,
    moments_packed,
    pack_arrow_factors,
    pack_coeffs,
    pack_ptau,
    reduced_face_masks,
    transpose_u_packed,
    unpack_ptau,
)
from .precond import _arrow_solve_from, _safe_inv, cell_arrow_factors, make_preconditioner, region_schur_inv, schur_diagonal
from .reduced import Coupling, ReducedData, RegionSum, build_reduced, expand_J, finalize_reduced, reduce_J
from .weights import compute_weights


@dataclasses.dataclass(frozen=True)
class Scene:
    """One solve's input state on the MAC grid (the reference's Houdini
    input fields, exec/HDK_PolyStokes.C:235-314).

    Optional ``surface_weights`` / ``collision_weights`` (3 face tensors
    each) override the face liquid / fluid weights, floored at MINWEIGHT
    where positive (Solver.cpp:183-237).  ``density`` is carried as in the
    JAX package, where ``step`` does not read it either: ``sample_density``
    validates it and folds its constant into the parameters."""

    surface_sdf: torch.Tensor  # (nx,ny,nz) liquid SDF at centers, <0 inside
    collision_sdf: torch.Tensor  # (nx,ny,nz) solid SDF at centers, <0 inside
    velocity: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # face arrays
    collision_velocity: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    viscosity: torch.Tensor  # (nx,ny,nz) dynamic viscosity at centers
    dt: torch.Tensor  # 0-d timestep
    surface_weights: Optional[tuple] = None
    collision_weights: Optional[tuple] = None
    density: Optional[torch.Tensor] = None


def sample_density(scene: Scene, params: SolverParams) -> SolverParams:
    """Density-field input validation (HDK_PolyStokes.C:290-304), as the
    JAX package's: the reference rejects a variable density field ("only
    constant density is supported") and otherwise samples the constant
    from it, which ``effective_density`` clamps into [min_density,
    max_density].  Returns ``params`` itself when the scene carries no
    field, else params with ``constant_density`` set.  The field's min and
    max are reduced on its device; two scalars go to the host."""
    if scene.density is None:
        return params
    lo, hi = torch.stack(torch.aminmax(torch.as_tensor(scene.density))).tolist()
    scale = max(abs(lo), abs(hi), 1e-30)
    if (hi - lo) / scale > 1e-6:
        raise ValueError(
            f"variable density fields are not supported (field range [{lo}, {hi}]); "
            "the reference solver imposes the same restriction (HDK_PolyStokes.C:290-304)"
        )
    return params.replace(constant_density=lo)


def _apply_input_weights(lw, fw, scene, dtype):
    def floor_min(w):
        w = w.to(dtype)
        return torch.where(w > 0, torch.clamp(w, min=MINWEIGHT), 0.0)

    if scene.surface_weights is not None:
        lw = dict(lw)
        for a in range(3):
            lw[f"face{a}"] = floor_min(scene.surface_weights[a])
    if scene.collision_weights is not None:
        fw = dict(fw)
        for a in range(3):
            fw[f"face{a}"] = floor_min(scene.collision_weights[a])
    return lw, fw


def _pad_edge(a, axis, before, after):
    """Edge-mode pad of one axis."""
    n = a.shape[axis]
    parts = [a.narrow(axis, 0, 1)] * before + [a] + [a.narrow(axis, n - 1, 1)] * after
    return torch.cat(parts, dim=axis)


def edge_viscosity(viscosity_c, edge_axis: int):
    """Viscosity at edges: the average of the 4 surrounding cell centers
    with edge-clamped borders (Solver.cpp:693-695)."""
    p, q = EDGE_OFFSET_AXES[edge_axis]
    v = _pad_edge(_pad_edge(viscosity_c, p, 1, 1), q, 1, 1)
    n = viscosity_c.shape

    def view(dp, dq):
        return v.narrow(p, dp, n[p] + 1).narrow(q, dq, n[q] + 1)

    return 0.25 * (view(0, 0) + view(0, 1) + view(1, 0) + view(1, 1))


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def _solid_rhs(grid: Grid, cls: Classification, asm, fluid_w, collision_velocity, dtype) -> PTau:
    """Solid-velocity boundary RHS terms (ConstructMatrixBlocks.cpp:424-441,
    493-511, 581-599)."""
    dev = asm.clw_s.device
    p_out = torch.zeros(grid.center_shape, dtype=dtype, device=dev)
    tc_out = [torch.zeros(grid.center_shape, dtype=dtype, device=dev) for _ in range(3)]
    te_out = [torch.zeros(fluid_w[f"edge{e}"].shape, dtype=dtype, device=dev) for e in range(3)]
    phi_c = (fluid_w["center"] < 1.0).to(dtype)
    for a in range(3):
        c_lo, c_hi, erow = coeff_fields(asm, a)
        svel = collision_velocity[a].to(dtype) * is_active(cls.face_labels[a]).to(dtype)
        w1 = svel * (fluid_w[f"face{a}"] < 1.0).to(dtype)
        t1 = face_at_cell(c_hi * w1, a, 0) - face_at_cell(c_lo * w1, a, 1)
        t2 = (face_at_cell(c_hi * svel, a, 0) - face_at_cell(c_lo * svel, a, 1)) * phi_c
        contrib = t1 - t2
        p_out = p_out + contrib
        tc_out[a] = tc_out[a] + contrib
        for e, (elo, ehi) in erow.items():
            phi_e = (fluid_w[f"edge{e}"] < 1.0).to(dtype)
            s1 = scatter_face_to_edge(ehi * w1, a, e, 1) - scatter_face_to_edge(elo * w1, a, e, 0)
            s2 = (scatter_face_to_edge(ehi * svel, a, e, 1) - scatter_face_to_edge(elo * svel, a, e, 0)) * phi_e
            te_out[e] = te_out[e] + s1 - s2
    return PTau(p=p_out, tc=tuple(tc_out), te=tuple(te_out))


def assemble(grid: Grid, scene: Scene, cls: Classification, liquid_w, fluid_w, params: SolverParams, R: int):
    """All operator state of the pressure-stress factored scheme
    (AssembleSystem.cpp:432-470); the uniform solve gets zero region data.
    Returns (Assembled, ReducedData)."""
    dtype = params.dtype
    dev = scene.surface_sdf.device
    dt = scene.dt.to(dtype)
    visc_c = scene.viscosity.to(dtype)
    visc_e = tuple(edge_viscosity(visc_c, e) for e in range(3))
    clw_s, elw_s, ffw = build_gated_weights(grid, cls, liquid_w, fluid_w, params)
    mc, mc_inv, uinv_c, u_c, uinv_e, u_e = build_diagonals(grid, cls, liquid_w, fluid_w, visc_c, visc_e, params)
    vmask = tuple(is_active(cls.face_labels[a]).to(dtype) for a in range(3))
    if params.do_reduced_regions:
        rd = build_reduced(grid, cls, scene.velocity, visc_c, visc_e, params, R)
        rd = finalize_reduced(rd, cls.region_valid, dt, dtype, params.reduced_dof)
    else:
        D = params.reduced_dof
        zeros_rdd = torch.zeros((R, D, D), dtype=dtype, device=dev)
        zeros_rd = torch.zeros((R, D), dtype=dtype, device=dev)
        rd = ReducedData(com=torch.zeros((R, 3), dtype=dtype, device=dev), cell_counts=torch.zeros((R,), dtype=dtype, device=dev),
                         mr=zeros_rdd, vr=zeros_rdd, binv=zeros_rdd, best_fit=zeros_rd, b_w=zeros_rd)
    asm = Assembled(
        dt=dt,
        inv_dx=torch.tensor(1.0 / grid.dx, dtype=dtype, device=dev),
        clw_s=clw_s,
        elw_s=elw_s,
        ffw=ffw,
        mc=mc,
        mc_inv=mc_inv,
        uinv_c=uinv_c,
        u_c=u_c,
        uinv_e=uinv_e,
        u_e=u_e,
        b_v=tuple(scene.velocity[a].to(dtype) * mc[a] for a in range(3)),
        old_v=tuple(scene.velocity[a].to(dtype) * vmask[a] for a in range(3)),
        rhs_solid=None,
        com=rd.com,
        binv=rd.binv,
        mr=rd.mr,
        vr=rd.vr,
        best_fit=rd.best_fit,
        b_w=rd.b_w,
        region_valid=cls.region_valid,
        face_region=cls.face_region,
    )
    asm = dataclasses.replace(asm, rhs_solid=_solid_rhs(grid, cls, asm, fluid_w, scene.collision_velocity, dtype))
    return asm, rd


# ---------------------------------------------------------------------------
# The matrix-free Schur operator (ApplyPressureStressMatrix.h:102-179)
# ---------------------------------------------------------------------------

def _use_packed(grid: Grid, params: SolverParams) -> bool:
    """Whether the step runs the packed kernels: ``use_pallas``, not
    MULTIGRID, and a configuration the packed layout takes
    (``_packed_layout``)."""
    if not params.use_pallas or params.preconditioner == PreconditionerType.MULTIGRID:
        return False
    return _packed_layout(grid.res, params)


def _packed_layout(res, params: SolverParams) -> bool:
    """Whether the packed layout takes the resolution ``res`` (the grid's,
    or an x-slab's), as in the JAX package (``pallas_compatible``): tiled
    with padding slabs, or untiled with cube regions, and a tile that
    divides every resolution; the uniform step always.  The TPU's block
    rule (x and y divisible by its block) is not the port's, so a
    resolution that only that rule refuses runs packed here and unpacked in
    JAX."""
    if not params.do_reduced_regions:
        return True
    if params.do_tile and params.tile_padding < 1:
        return False
    if not params.do_tile and not params.cube_regions:
        return False
    return all(n % params.tile_size == 0 for n in res)


def make_apply(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, R: int):
    """The Schur apply on PTau values, as the JAX package's ``make_apply``:
    the packed kernels between a pack and an unpack where ``_use_packed``,
    else the unpacked apply in plain torch ops,

        A x = -[G Dt]^T (dt McInv + [J^T BInv J on reduced faces]) [G Dt] x
              - 0.5 uInv x,

    whose J couplings (``reduced.Coupling``) are set up here, once."""
    if _use_packed(grid, params):
        apply_packed = make_apply_packed(grid, cls, asm, params, R)
        return lambda x: unpack_ptau(apply_packed(pack_ptau(x)))
    J = Coupling(grid, cls, asm.com, params, R) if params.do_reduced_regions else None

    def apply_A(x: PTau) -> PTau:
        s = forward_face_values(asm, x)  # (G p + Dt tau) on every face
        # active branch: -dt [G Dt]^T McInv [G Dt] x
        fv = [-asm.dt * asm.mc_inv[a] * s[a] for a in range(3)]
        if J is not None:
            # reduced branch: -[JG JDt]^T BInv [JG JDt] x
            u = J.expand(torch.einsum("rij,rj->ri", asm.binv, J.reduce(s)))
            fv = [fv[a] - u[a] for a in range(3)]
        out = transpose_from_faces(asm, fv)
        tc = tuple(out.tc[a] - 0.5 * asm.uinv_c * x.tc[a] for a in range(3))
        te = tuple(out.te[e] - 0.5 * asm.uinv_e[e] * x.te[e] for e in range(3))
        return PTau(p=out.p, tc=tc, te=te)

    return apply_A


def _flat(fn, grid: Grid):
    """A PTau -> PTau function as one on flat vectors (None stays None)."""
    if fn is None:
        return None
    return lambda xf: ravel_ptau(fn(unravel_ptau(xf, grid)))


def _region_algebra_packed(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, R: int, matrix=None):
    """The per-cube region algebra between the moments and expand kernels:
    mom [cs0, cs1, 3K, cs2] -> v [cs0, cs1, 3K, cs2], the cube-origin
    polynomial coefficients of ``matrix`` (J x), per region, BInv by
    default (REGION_ARROW passes inv(S)); plus the reduced-face mask stack.
    The shift S(com - origin) turns the kernels' origin moments into
    COM-relative ones here, so the kernels never see the COM."""
    dtype = params.dtype
    dev = asm.com.device
    T = params.tile_size
    K = n_monomials(params.basis)
    A_mats = [torch.as_tensor(monomial_matrix(a, params.basis), dtype=dtype, device=dev) for a in range(3)]
    cs = tuple(-(-n // T) for n in grid.res)
    axes = [torch.arange(c, dtype=dtype, device=dev) * T for c in cs]
    origins = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    roc = cls.region_of_cube
    safe = roc.clamp(0, asm.com.shape[0] - 1).long()
    com_cube = torch.where((roc >= 0)[:, None], asm.com[safe], 0.0)
    cprime = com_cube - origins
    S = monomial_shift_matrix(cprime[:, 0], cprime[:, 1], cprime[:, 2], params.basis)  # [nc, K, K]
    safe_cube = roc.clamp(0, R - 1).long()
    cube_ok = (roc >= 0).to(dtype)
    rsum = RegionSum(roc, R)  # built here, once: a static index tensor inside the captured pass
    # under coeff_bf16 the 0/1 masks are stored in bfloat16 (exact), halving
    # the expand kernel's reads
    red_packed = torch.stack([_face_to_slot(m.to(dtype), a) for a, m in enumerate(reduced_face_masks(cls))], dim=0)
    red_packed = red_packed.to(_storage(params) or dtype).contiguous()
    mtx = asm.binv if matrix is None else matrix

    def algebra(mom):
        m = mom.permute(0, 1, 3, 2).reshape(-1, 3, K)
        m_rel = torch.einsum("ckj,caj->cak", S, m)
        y = sum(m_rel[:, a, :] @ A_mats[a].T for a in range(3))  # [nc, D]
        w = torch.einsum("rij,rj->ri", mtx, rsum(y))
        w_cube = w[safe_cube] * cube_ok[:, None]
        v_com = torch.stack([w_cube @ A_mats[a] for a in range(3)], dim=1)  # [nc, 3, K]
        v_origin = torch.einsum("ckj,cak->caj", S, v_com)
        return v_origin.reshape(cs[0], cs[1], cs[2], 3 * K).permute(0, 1, 3, 2).contiguous()

    return algebra, red_packed


def _storage(params: SolverParams):
    """The coefficient stack's storage dtype: bfloat16 under coeff_bf16,
    else None (the compute dtype)."""
    return torch.bfloat16 if params.coeff_bf16 else None


def make_apply_packed(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, R: int):
    """The kernel apply on packed [7, nx, ny, nz] vectors: moments kernel
    -> region algebra -> expand kernel -> reduced-apply kernel (which
    recomputes s rather than storing it); the uniform solve runs the
    uniform-apply kernel alone."""
    if not params.do_reduced_regions:
        coeffs = pack_coeffs(asm, storage_dtype=_storage(params))
        return lambda xp: apply_uniform_packed(xp, coeffs)
    coeffs = pack_coeffs(asm, cls, storage_dtype=_storage(params))
    T, basis = params.tile_size, params.basis
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, R)

    def apply_packed(xp):
        up = expand_packed(algebra(moments_packed(xp, coeffs, T, basis)), red_packed, T, basis)
        return apply_reduced_packed(xp, coeffs, up)

    return apply_packed


def make_apply_packed_pap(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, R: int,
                          defer_finish: bool = False):
    """The fused apply returning (A x, <x, A x>).  Reduced: one kernel
    gives the grid branch with its mass terms, the per-cube moments and the
    per-cube partials of <x, out_grid>; the region algebra turns the
    moments into v; expand and finish add the reduced branch.  That
    branch's share of <x, A x> is -sum(mom * v) on the small per-cube
    arrays (<x, F^T(-chi J v)> = -<chi F x, J v>), so finish never reads x.
    With ``defer_finish`` finish is left to the fused update, and A x comes
    back as the pair (out_grid, v) under ``fuse_expand`` (the update
    kernel expands too) or (out_grid, u).  Uniform: one kernel gives A x and
    the partials."""
    if not params.do_reduced_regions:
        coeffs = pack_coeffs(asm, storage_dtype=_storage(params))

        def apply_dot_uniform(xp):
            out, pap = apply_uniform_pap_packed(xp, coeffs)
            return out, torch.sum(pap)

        return apply_dot_uniform
    coeffs = pack_coeffs(asm, cls, storage_dtype=_storage(params))
    T, basis = params.tile_size, params.basis
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, R)
    fuse_expand = _fuse_expand_ok(params)

    def apply_dot(xp):
        out_grid, mom, pap_grid = grid_mom_pap_packed(xp, coeffs, T, basis)
        v = algebra(mom)
        pap = torch.sum(pap_grid) - torch.sum(mom * v)
        if defer_finish and fuse_expand:
            return (out_grid, v), pap
        up = expand_packed(v, red_packed, T, basis)
        if defer_finish:
            return (out_grid, up), pap
        return finish_packed(coeffs, out_grid, up), pap

    return apply_dot


def _fuse_expand_ok(params: SolverParams) -> bool:
    """Whether the deferred finish goes to the update kernel that also
    expands (``exp_finish_update_packed``).  The JAX package also asks its
    TPU kernel's block rule (``exp_finish_supported``); the CUDA kernel
    takes every resolution the tile size divides."""
    return bool(params.fuse_expand and params.do_reduced_regions)


def make_fused_update(params: SolverParams, factors, cls: Classification, asm: Assembled):
    """The fused CG update ``fused(x, r, p, Ap, alpha, out=None)`` of
    ``fuse_update`` for the pointwise preconditioners (CELL_ARROW: kind
    "arrow" on the 13-channel stack; DIAGONAL: "diag" on the packed inverse
    diagonal; IDENTITY: "none"), else None, as in the JAX package:
    REGION_ARROW's solve is not pointwise.  Ap is a stored A p
    (``cg_update_packed``) or, on the reduced step, the deferred pair of
    ``make_apply_packed_pap(defer_finish=True)``: (out_grid, v) goes to
    ``exp_finish_update_packed``, (out_grid, u) to ``finish_update_packed``.
    ``out`` (x', r') names the tensors the kernel writes x' and r' to.
    Deflation wraps the preconditioner with an apply, so it is None under
    ``deflation`` too."""
    if not params.fuse_update or params.deflation:
        return None
    if params.preconditioner == PreconditionerType.CELL_ARROW:
        fstack, kind = pack_arrow_factors(factors), "arrow"
    elif params.preconditioner == PreconditionerType.DIAGONAL:
        fstack, kind = factors["inv_packed"], "diag"
    elif params.preconditioner == PreconditionerType.IDENTITY:
        fstack, kind = None, "none"
    else:
        return None
    coeffs = pack_coeffs(asm, cls, storage_dtype=_storage(params)) if params.do_reduced_regions else None
    fuse_expand = _fuse_expand_ok(params)
    T = params.tile_size

    def fused(x, r, p, ap, alpha, out=None):
        if isinstance(ap, tuple):
            og, tail = ap
            if fuse_expand:
                return exp_finish_update_packed(x, r, p, alpha, coeffs, og, tail, T, factors=fstack, kind=kind, out=out,
                                                basis=params.basis)
            return finish_update_packed(x, r, p, alpha, coeffs, og, tail, factors=fstack, kind=kind, out=out)
        return cg_update_packed(x, r, p, ap, alpha, factors=fstack, kind=kind, out=out)

    return fused


def _defer_finish(params: SolverParams, fused_update) -> bool:
    """Whether apply_dot returns the deferred pair: only when a fused
    update will finish it."""
    return bool(params.do_reduced_regions and fused_update is not None)


def precond_factors_packed(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams):
    """Loop-invariant preconditioner factor fields in the packed layout:
    None for IDENTITY; ``inv_packed``, the packed inverse of |diag(A)|, for
    DIAGONAL; the arrow factors for CELL_ARROW and REGION_ARROW, under
    REGION_ARROW with regions also ``sinv``, the per-region inverse
    capacitance, and the arrow block without the reduced quadratic form.
    The uniform step has no regions and takes the plain arrow factors."""
    if params.preconditioner == PreconditionerType.IDENTITY:
        return None
    if params.preconditioner == PreconditionerType.DIAGONAL:
        d = schur_diagonal(grid, cls, asm, params)
        return dict(inv_packed=pack_ptau(PTau(p=_safe_inv(d.p), tc=tuple(_safe_inv(t) for t in d.tc),
                                              te=tuple(_safe_inv(t) for t in d.te))))
    region = params.preconditioner == PreconditionerType.REGION_ARROW and params.do_reduced_regions
    fac = cell_arrow_factors(grid, cls, asm, params, include_reduced_q=not region)
    k, inv_d, kd, inv_schur, te_inv = fac
    out = dict(k=list(k), inv_d=list(inv_d), kd=list(kd), inv_schur=inv_schur,
               te_inv_s=[_edge_to_slot(te_inv[e], e) for e in range(3)])
    if region:
        out["sinv"] = region_schur_inv(grid, cls, asm, params, asm.binv.shape[0], _arrow_solve_from(*fac))
    return out


def make_preconditioner_packed(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, factors=None):
    """The packed preconditioner: None for IDENTITY; the Jacobi product for
    DIAGONAL; the arrow solve (closed-form per-cell arrow inverse) and,
    when ``factors`` hold ``sinv``, REGION_ARROW's Woodbury correction
    z = y - M0^-1 F^T chi J^T S^-1 J chi F y, y = M0^-1 r: the moments and
    expand kernels of the apply and the transpose_u kernel."""
    if params.preconditioner == PreconditionerType.IDENTITY:
        return None
    if factors is None:
        factors = precond_factors_packed(grid, cls, asm, params)
    if params.preconditioner == PreconditionerType.DIAGONAL:
        inv_packed = factors["inv_packed"]
        return lambda rp: inv_packed * rp
    k, inv_d, kd = factors["k"], factors["inv_d"], factors["kd"]
    inv_schur, te_inv_s = factors["inv_schur"], factors["te_inv_s"]

    def solve_arrow(rp):
        z_p = (rp[0] + sum(kd[a] * rp[1 + a] for a in range(3))) * inv_schur
        z_tc = [(rp[1 + a] + k[a] * z_p) * inv_d[a] for a in range(3)]
        z_te = [rp[4 + e] * te_inv_s[e] for e in range(3)]
        return torch.stack([z_p] + z_tc + z_te, dim=0)

    if "sinv" not in factors:
        return solve_arrow
    T, basis = params.tile_size, params.basis
    coeffs = pack_coeffs(asm, cls, storage_dtype=_storage(params))
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, asm.binv.shape[0], matrix=factors["sinv"])

    def solve_region(rp):
        y = solve_arrow(rp)
        up = expand_packed(algebra(moments_packed(y, coeffs, T, basis)), red_packed, T, basis)
        return y - solve_arrow(transpose_u_packed(coeffs, up))

    return solve_region


def build_rhs(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, R: int) -> PTau:
    """b = -[G Dt]^T McInv b_v - (1/dt) [JG JDt]^T BInv b_w + rhs_solid
    (AssembleSystem.cpp:448-459); no region term in the uniform solve."""
    fv = [-(asm.mc_inv[a] * asm.b_v[a]) for a in range(3)]
    if params.do_reduced_regions:
        w0 = torch.einsum("rij,rj->ri", asm.binv, asm.b_w) / asm.dt
        u0 = expand_J(grid, cls, asm.com, w0, params)
        fv = [fv[a] - u0[a] for a in range(3)]
    return transpose_from_faces(asm, fv) + asm.rhs_solid


def _warm_guess(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams) -> PTau:
    """The device warm start (the reference's constructGuessVectors,
    Solver.cpp:521-531), as the JAX package builds it: the old velocity,
    plus the regions' best-fit polynomials on the reduced step, taken to
    the solve variable through t = [G Dt]^T f:
    x0 = (-t.p, 2 uinv_c t.tc, 2 uinv_e t.te)."""
    fguess = list(asm.old_v)
    if params.do_reduced_regions:
        u_fit = expand_J(grid, cls, asm.com, asm.best_fit, params)
        fguess = [fguess[a] + u_fit[a] for a in range(3)]
    t = transpose_from_faces(asm, fguess)
    return PTau(p=-t.p, tc=tuple(2.0 * asm.uinv_c * t.tc[a] for a in range(3)),
                te=tuple(2.0 * asm.uinv_e[e] * t.te[e] for e in range(3)))


def _make_deflation(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams):
    """The A-DEF2 state (``deflation.build_deflation``) under ``deflation``
    where ``deflation_supported``, else None; where it is not supported it
    warns and the step runs undeflated, as in the JAX package.  The probes
    run through the step's own apply on packed vectors (the unpacked apply
    between an unpack and a pack where the step runs unpacked)."""
    if not params.deflation:
        return None
    if not deflation_supported(grid, params):
        warnings.warn(
            "deflation requested but unsupported for this grid/params "
            "(coarse tile must divide the resolution; reduced solves must "
            "be tiled with deflation_tile a multiple of tile_size) — "
            "continuing without deflation",
            stacklevel=2,
        )
        return None
    R = effective_max_regions(grid, params)
    if _use_packed(grid, params):
        ap = make_apply_packed(grid, cls, asm, params, R)
    else:
        inner = make_apply(grid, cls, asm, params, R)

        def ap(xp):
            return pack_ptau(inner(unpack_ptau(xp)))

    return build_deflation(grid, cls, params, ap)


def _build_krylov_system(grid: Grid, cls, asm, scene: Scene, params: SolverParams, initial_guess=None, pfac=None,
                         defl=None, mesh=None, mesh_axis: str = "x"):
    """(apply_K, apply_dot, fused_update, precond, b_K, x0_K), as the JAX
    package's ``_build_krylov_system``.  Packed (``_use_packed``), the
    vectors are [7, nx, ny, nz] tensors, ``apply_dot`` the fused apply with
    <p, A p> under ``fuse_pap``, else None, and ``fused_update`` the fused
    CG update under ``fuse_update`` with a pointwise preconditioner, else
    None.  ``mesh`` (a ``parallel.sharding.Mesh`` of more than one device
    whose only axis above 1 is ``mesh_axis``, the caller having checked
    ``pallas_shardable``) takes the packed apply through the x-slab kernels
    of ``parallel.shard_apply``; the fused apply and update are then None,
    as in JAX, and the vectors stay whole on the mesh's first device.
    Unpacked, the vectors are
    flat (``operators.ravel_ptau``), the apply and the preconditioner are
    ``make_apply`` and ``precond.make_preconditioner`` on them, and both
    fused forms are None.  ``initial_guess`` (a PTau) seeds the solve;
    without it ``device_warm_start`` and ``use_warm_start`` together seed it
    with ``_warm_guess``, else it starts from zero.  ``pfac``
    (``precond_factors_packed``) skips the packed factors, which
    ``solve_chunked`` computes once.  ``defl`` (a ``DeflationState``) wraps
    the preconditioner in the A-DEF2 correction and projects x0."""
    R = effective_max_regions(grid, params)
    b = build_rhs(grid, cls, asm, params, R)
    if initial_guess is None and params.device_warm_start and params.use_warm_start:
        initial_guess = _warm_guess(grid, cls, asm, params)
    if not _use_packed(grid, params):
        apply_p, precond_p = make_apply(grid, cls, asm, params, R), make_preconditioner(grid, cls, asm, params)
        b_K = ravel_ptau(b)
        x0_K = torch.zeros_like(b_K) if initial_guess is None else ravel_ptau(initial_guess).to(b_K.dtype)
        if defl is not None:
            x0_K = ravel_ptau(deflate_guess_ptau(defl, apply_p, b, unravel_ptau(x0_K, grid)))
            precond_p = deflated_precond_ptau(defl, apply_p, base=precond_p)
        return _flat(apply_p, grid), None, None, _flat(precond_p, grid), b_K, x0_K
    b_K = pack_ptau(b)
    if pfac is None:
        pfac = precond_factors_packed(grid, cls, asm, params)
    if mesh is not None and mesh.size > 1:
        from .parallel.shard_apply import make_apply_packed_sharded

        apply_K = make_apply_packed_sharded(grid, cls, asm, params, R, mesh, axis=mesh_axis)
        fused_update = apply_dot = None  # single-device kernels: the slab path runs the unfused apply
    else:
        apply_K = make_apply_packed(grid, cls, asm, params, R)
        fused_update = make_fused_update(params, pfac, cls, asm)
        apply_dot = (make_apply_packed_pap(grid, cls, asm, params, R, defer_finish=_defer_finish(params, fused_update))
                     if params.fuse_pap else None)
    precond = make_preconditioner_packed(grid, cls, asm, params, pfac)
    x0_K = torch.zeros_like(b_K) if initial_guess is None else pack_ptau(initial_guess).to(b_K.dtype)
    if defl is not None:
        x0_K = deflate_guess_packed(defl, apply_K, b_K, x0_K)
        precond = deflated_precond_packed(defl, apply_K, base=precond)
    return apply_K, apply_dot, fused_update, precond, b_K, x0_K


def recover_velocity(grid: Grid, cls: Classification, asm: Assembled, x: PTau, params: SolverParams, R: int):
    """v = dt McInv (b_v/dt - G p - Dt tau); w = BInv (b_w/dt - JG p - JDt tau)
    (Solver.cpp:493-510); w is 0 in the uniform solve."""
    s = forward_face_values(asm, x)
    v = tuple(asm.mc_inv[a] * asm.b_v[a] - asm.dt * asm.mc_inv[a] * s[a] for a in range(3))
    if not params.do_reduced_regions:
        return v, torch.zeros((R, params.reduced_dof), dtype=params.dtype, device=asm.dt.device)
    y = reduce_J(grid, cls, asm.com, s, params, R)
    w = torch.einsum("rij,rj->ri", asm.binv, asm.b_w / asm.dt - y)
    return v, w


def apply_solution_to_velocity(grid: Grid, cls: Classification, asm: Assembled, scene: Scene, v, w, params: SolverParams):
    """Per-face write-back (Solver.cpp:938-1028): reduced faces evaluate
    the region polynomial (none in the uniform solve), active faces take
    the solved value, solid faces the collision velocity, invalid faces keep
    their velocity.  Also returns the valid-face masks
    (Classifier.cpp:5-54)."""
    dtype = params.dtype
    u_red = expand_J(grid, cls, asm.com, w, params) if params.do_reduced_regions else None
    new_vel, valid = [], []
    for a in range(3):
        lbl = cls.face_labels[a]
        val = lbl != UNSOLVED
        old = scene.velocity[a].to(dtype)
        out = torch.where(lbl == SOLID, scene.collision_velocity[a].to(dtype), old)
        out = torch.where(is_active(lbl), v[a], out)
        if u_red is not None:
            out = torch.where((lbl == REDUCED) & (cls.face_region[a] >= 0), u_red[a], out)
        new_vel.append(torch.where(val, out, old))
        valid.append(val)
    return tuple(new_vel), tuple(valid)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _dof_counts(cls: Classification):
    n_center = int(is_active(cls.cell_labels).sum())
    n_faces = sum(int(is_active(l).sum()) for l in cls.face_labels)
    n_edges = sum(int(is_active(l).sum()) for l in cls.edge_labels)
    return n_center, n_faces, n_edges


def _boundary_active(cls: Classification) -> int:
    """Active faces and edges on the index-0 planes the packed layout drops."""
    total = 0
    for a in range(3):
        total += int(is_active(cls.face_labels[a].narrow(a, 0, 1)).sum())
    for e in range(3):
        for ax in EDGE_OFFSET_AXES[e]:
            total += int(is_active(cls.edge_labels[e].narrow(ax, 0, 1)).sum())
    return total


def _weights(grid: Grid, scene: Scene, params: SolverParams):
    liquid_w, fluid_w = compute_weights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
    return _apply_input_weights(liquid_w, fluid_w, scene, params.dtype)


def _setup(grid: Grid, scene: Scene, params: SolverParams):
    """Weights -> classify -> assemble: the scene-dependent part."""
    liquid_w, fluid_w = _weights(grid, scene, params)
    cls = classify(grid, liquid_w, fluid_w, params)
    asm, _ = assemble(grid, scene, cls, liquid_w, fluid_w, params, effective_max_regions(grid, params))
    return cls, asm


def boundary_activity(grid: Grid, scene: Scene, params: SolverParams) -> int:
    """Count of active faces and edges on the dropped index-0 planes; the
    packed layout is exact iff it is 0."""
    return _boundary_active(classify(grid, *_weights(grid, scene, params), params))


def check_pallas(grid: Grid, scene: Scene, params: SolverParams) -> SolverParams:
    """Pre-flight of the packed layout, as the JAX package's: where the
    step would run packed and the scene has active DOFs on the index-0
    planes that the packed layout drops, warn and return params with
    ``use_pallas=False`` (the unpacked apply is exact there); else return
    params unchanged.  Call once per scene topology before ``step``."""
    if not _use_packed(grid, params):
        return params
    n = boundary_activity(grid, scene, params)
    if n:
        warnings.warn(
            f"scene has {n} active DOFs on the domain-boundary index-0 planes; "
            "the packed layout drops those, so use_pallas is disabled "
            "for this solve (falling back to the unpacked apply)",
            stacklevel=2,
        )
        return params.replace(use_pallas=False)
    return params


def _write_back(grid: Grid, scene: Scene, params: SolverParams, cls: Classification, asm: Assembled,
                res: krylov.KrylovResult):
    """Recover, write back, the boundary fail-safe, ``keep_non_converged``
    and the stats: the tail of ``step`` and ``solve_chunked``."""
    R = effective_max_regions(grid, params)
    packed = _use_packed(grid, params)
    x = unpack_ptau(res.x) if packed else unravel_ptau(res.x, grid)
    v, w = recover_velocity(grid, cls, asm, x, params, R)
    new_vel, valid = apply_solution_to_velocity(grid, cls, asm, scene, v, w, params)

    # fail safe on the packed layout invariant: liquid touching the domain
    # box puts active DOFs on the dropped index-0 planes, so a packed solve
    # is reported as failed instead of returning wrong physics
    boundary_active = _boundary_active(cls)
    converged = bool(res.converged) and (boundary_active == 0 or not packed)
    if not params.keep_non_converged and not converged:
        new_vel = tuple(scene.velocity[a].to(params.dtype) for a in range(3))

    n_center, n_faces, n_edges = _dof_counts(cls)
    n_regions = int(cls.n_regions)
    stats = {
        "boundary_active": boundary_active,
        "iterations": res.iterations,
        "error": res.error,
        "converged": converged,
        "operator_applies": res.applies,
        "loop_passes": res.passes,
        "n_pressures": n_center,
        "n_active_velocities": n_faces,
        "n_stresses": 3 * n_center + n_edges,
        "n_regions": n_regions,
        "n_reduced_dofs": n_regions * params.reduced_dof,
        "region_overflow": bool(cls.region_overflow),
    }
    return new_vel, valid, stats


def _chunk_init(grid: Grid, scene: Scene, params: SolverParams, cls, asm, initial_guess=None, pfac=None, defl=None,
                mesh=None, mesh_axis: str = "x"):
    """(carry, loop): the initial PCG carry and the ``krylov.PCGLoop`` that
    holds the Krylov system, whose CUDA graph every segment replays (JAX's
    ``_chunk_init`` returns the carry and rebuilds the system inside each
    jitted segment, each with the deflated preconditioner of ``defl`` and
    the sharded apply of ``mesh``)."""
    apply_K, apply_dot, fused_update, precond, b_K, x0_K = _build_krylov_system(grid, cls, asm, scene, params,
                                                                                 initial_guess, pfac, defl, mesh,
                                                                                 mesh_axis)
    loop = krylov.PCGLoop(apply_K, precond, tol=params.tolerance, max_iters=params.max_iterations, apply_dot=apply_dot,
                          fused_update=fused_update, graph=_slab_graph(mesh, mesh_axis))
    return krylov.pcg_init(apply_K, b_K, x0_K, precond), loop


def _carry_leaves(grid: Grid, params: SolverParams, carry: krylov.PCGCarry) -> list:
    """The carry as the JAX package's pytree leaves: on the unpacked layout
    x, r and p are PTau values, seven leaves each."""
    if _use_packed(grid, params):
        return list(carry)
    vecs = [t for v in carry[:3] for t in unravel_ptau(v, grid).fields()]
    return vecs + list(carry[3:])


def _carry_from_leaves(grid: Grid, params: SolverParams, like: krylov.PCGCarry, leaves) -> krylov.PCGCarry:
    """The inverse of ``_carry_leaves`` (numpy leaves), on ``like``'s device
    and dtypes."""
    def t(a, ref):
        return torch.as_tensor(a).to(device=ref.device, dtype=ref.dtype)

    if _use_packed(grid, params):
        return krylov.PCGCarry(*(t(a, ref) for a, ref in zip(leaves, like)))
    vecs = [torch.cat([t(a, like.x).reshape(-1) for a in leaves[7 * i:7 * i + 7]]) for i in range(3)]
    return krylov.PCGCarry(*vecs, *(t(a, ref) for a, ref in zip(leaves[21:], like[3:])))


def _chunk_segment(loop: krylov.PCGLoop, carry: krylov.PCGCarry, segment_iters: int) -> krylov.PCGCarry:
    """At most ``segment_iters`` more iterations of the loop from carry."""
    return loop.segment(carry, segment_iters)


def _chunk_finalize(grid: Grid, scene: Scene, params: SolverParams, cls, asm, carry: krylov.PCGCarry, passes: int = 0):
    """(new_velocity, valid_masks, stats) from the final carry; ``passes``
    is the loop passes launched, reported as ``loop_passes``."""
    return _write_back(grid, scene, params, cls, asm, krylov.pcg_result(carry, passes))


def _fallback(apply_K, b_K, pcg_res: krylov.KrylovResult, fb: krylov.KrylovResult):
    """(result, kept) after BiCGStab ran as PCG's fallback: BiCGStab's
    result where its x is finite and its true residual |b - A x| is no
    larger than PCG's x's, else PCG's x, iterations and error; the applies
    and passes of both solves either way.  One apply for each x, not
    counted in ``applies``.  A divergence from the JAX package, which
    writes BiCGStab's x back unchecked, NaN or blown up in f32 (ROADMAP.md
    Queue 3, divergence 4)."""

    def resid(x):
        return float(torch.linalg.vector_norm((b_K - apply_K(x)).double()))

    keep = bool(torch.isfinite(fb.x).all()) and resid(fb.x) <= resid(pcg_res.x)
    res = fb if keep else pcg_res
    res = res._replace(applies=pcg_res.applies + fb.applies, passes=pcg_res.passes + fb.passes)
    return res, "bicgstab" if keep else "pcg"


def _slab_graph(mesh, mesh_axis: str):
    """``krylov.PCGLoop``'s ``graph`` for a solve whose apply runs as
    x-slabs over ``mesh`` (None: unsharded): None, a graph where the
    vectors are on CUDA, when every slab of ``mesh_axis`` is on the mesh's
    first device, where the vectors live; else False, an eager loop, since
    a CUDA graph captures the launches of one device."""
    if mesh is None or all(d == mesh.devices[0] for d in mesh.axis_devices(mesh_axis)):
        return None
    return False


def _mesh_gate(grid: Grid, scene: Scene, params: SolverParams, mesh):
    """(scene, params, sharded) of a solve on ``mesh`` (None: no mesh).  The
    scene moves to the mesh's first device, where the setup and the Krylov
    vectors live.  A solve that ``parallel.sharding.pallas_shardable``
    admits keeps its params and runs the x-slab apply (sharded True); any
    other on a mesh of more than one device warns and runs the unpacked
    step whole on the first device (``check_mesh_pallas``; the JAX package
    hands it to GSPMD's partitioned apply, which the port does not have:
    ROADMAP.md Queue 3, divergence 8)."""
    if mesh is None:
        return scene, params, False
    from .parallel.sharding import check_mesh_pallas, shard_scene

    scene = shard_scene(scene, mesh)
    if mesh.size <= 1:
        return scene, params, False
    if params.use_pallas:
        gated = check_mesh_pallas(params, mesh, grid)
        return scene, gated, gated.use_pallas
    warnings.warn(
        f"the unpacked apply (use_pallas=False) has no x-slab form: the solve runs whole on the first device "
        f"of the {mesh.size}-device mesh",
        stacklevel=3,
    )
    return scene, params, False


def step(grid: Grid, scene: Scene, params: SolverParams, initial_guess=None, mesh=None, mesh_axis: str = "x"):
    """One Stokes solve.  Returns (new_velocity, valid_masks, stats).
    ``initial_guess`` (optional PTau) seeds the Krylov solve, as in the JAX
    package.  The layout is ``_use_packed``'s: the packed kernels, or the
    unpacked apply, which launches none.

    ``mesh`` (a ``parallel.sharding.Mesh``) and ``mesh_axis`` run the
    packed apply as x-slabs over the mesh's devices, one slab a device
    (``parallel.shard_apply``: the halo forms of kernels 1 and 3, or 7, and
    kernel 2 on each slab), where ``pallas_shardable`` admits the solve;
    the Krylov vectors stay whole on the mesh's first device.  Any other
    solve on the mesh warns and runs unpacked on that device
    (``_mesh_gate``).  ``stats["sharded"]`` says whether the slab apply ran.
    ``parallel.sharding.sharded_step`` picks the axis.

    ``solver_type`` picks the solver as in the JAX package: preconditioned
    CG, then with ``bicgstab_fallback`` BiCGStab from the same x0 when CG
    did not converge (a host branch where JAX has ``lax.cond``); or
    BiCGStab or MINRES alone, unpreconditioned, on the step's apply (on the
    packed layout kernels 1-3, or 7 on the uniform step).  After a fallback
    the step keeps BiCGStab's result only where it is the better one
    (``_fallback``), else PCG's x, iterations and error;
    ``stats["fallback_kept"]`` says which ("bicgstab" or "pcg", None where
    no fallback ran), and ``operator_applies`` and ``loop_passes`` are the
    sum of both solves'.  Under ``deflation`` the A-DEF2 state is built
    after the setup (``_make_deflation``) and the solves start from the
    projected guess."""
    scene, params, sharded = _mesh_gate(grid, scene, params, mesh)
    mesh = mesh if sharded else None
    cls, asm = _setup(grid, scene, params)
    defl = _make_deflation(grid, cls, asm, params)
    apply_K, apply_dot, fused_update, precond, b_K, x0_K = _build_krylov_system(
        grid, cls, asm, scene, params, initial_guess, defl=defl, mesh=mesh, mesh_axis=mesh_axis)
    capture, kept = 0.0, None
    tol, max_iters = params.tolerance, params.max_iterations
    if not params.do_solve:
        res = krylov.KrylovResult(x=x0_K, iterations=0, error=0.0, converged=True, applies=0, passes=0)
    elif params.solver_type == SolverType.PCG_MATRIX_VECTOR_PRODUCTS:
        loop = krylov.PCGLoop(apply_K, precond, tol=tol, max_iters=max_iters, apply_dot=apply_dot,
                              fused_update=fused_update, graph=_slab_graph(mesh, mesh_axis))
        res = krylov.pcg_result(loop.segment(krylov.pcg_init(apply_K, b_K, x0_K, precond)), loop.passes)
        capture = loop.capture_seconds or 0.0  # the CUDA graphs' capture, 0 where none
        del loop  # its buffers and graphs, before a fallback allocates its own
        if params.bicgstab_fallback and not res.converged:
            res, kept = _fallback(apply_K, b_K, res, krylov.bicgstab(apply_K, b_K, x0_K, tol=tol, max_iters=max_iters))
    elif params.solver_type == SolverType.BICGSTAB:
        res = krylov.bicgstab(apply_K, b_K, x0_K, tol=tol, max_iters=max_iters)
    else:
        res = krylov.minres(apply_K, b_K, x0_K, tol=tol, max_iters=max_iters)
    new_vel, valid, stats = _write_back(grid, scene, params, cls, asm, res)
    stats["capture_seconds"] = capture
    stats["fallback_kept"] = kept
    stats["sharded"] = sharded
    return new_vel, valid, stats


def solve_chunked(grid: Grid, scene: Scene, params: SolverParams, segment_iters: int = 500, max_seconds: float = None,
                  callback=None, state_path: str = None, resume: bool = False, initial_guess=None, mesh=None,
                  mesh_axis: str = "x"):
    """One Stokes solve as a host loop over CG segments of at most
    ``segment_iters`` iterations, the Krylov state held on the device
    between them, as the JAX package's ``solve_chunked``; ``mesh`` and
    ``mesh_axis`` as in ``step``.  It restores the reference's interrupt semantics (opInterrupt
    polling, Classifier.cpp:73-74): Ctrl-C between segments returns the
    partial result under ``keep_non_converged``.

      * max_seconds: stop after the segment in which this much wall-clock
        has passed (partial result)
      * callback(stats_dict) -> truthy to request a stop
      * state_path + resume: persist the PCG carry after each segment
        (``np.savez``, keys leaf0, leaf1, ... in the JAX package's pytree
        leaf order: x, r, p, rsold, k, rre, done, where on the unpacked
        layout x, r and p are seven fields each, ``PTau.fields``) and
        resume a killed run from it (same scene and params)

    It runs preconditioned CG whatever ``solver_type`` says, with no
    BiCGStab fallback, as the JAX package's does.

    ``POLYSTOKES_VERBOSE=1`` prints each stage.  Returns (new_velocity,
    valid_masks, stats) like ``step``, with ``stats["interrupted"]``."""
    verbose = bool(int(os.environ.get("POLYSTOKES_VERBOSE", "0")))
    last = [None]

    def _v(msg):
        if verbose:
            now = time.monotonic()
            dt = 0.0 if last[0] is None else now - last[0]
            last[0] = now
            print(f"[solve_chunked +{dt:7.1f}s] {msg}", flush=True)

    t_start = time.monotonic()
    scene, params, sharded = _mesh_gate(grid, scene, params, mesh)
    _v("setup...")
    cls, asm = _setup(grid, scene, params)
    _v("deflation build...")
    defl = _make_deflation(grid, cls, asm, params)
    pfac = None
    if _use_packed(grid, params):
        _v("precond factors...")
        pfac = precond_factors_packed(grid, cls, asm, params)
    _v("chunk init...")
    carry, loop = _chunk_init(grid, scene, params, cls, asm, initial_guess, pfac, defl, mesh if sharded else None,
                              mesh_axis)
    _v("first segment...")
    if resume and state_path and os.path.exists(state_path):
        with np.load(state_path) as d:
            carry = _carry_from_leaves(grid, params, carry, [d[f"leaf{i}"] for i in range(len(d.files))])

    interrupted = False
    try:
        while True:
            carry = _chunk_segment(loop, carry, segment_iters)
            k, done, rre = int(carry.k), bool(carry.done), float(carry.rre)
            _v(f"segment done: k={k} rre={rre:.3e} done={done}")
            if state_path:
                np.savez(state_path, **{f"leaf{i}": t.cpu().numpy()
                                        for i, t in enumerate(_carry_leaves(grid, params, carry))})
            if callback is not None and callback({"iterations": k, "rre": rre, "done": done}):
                interrupted = True
            if done or k >= params.max_iterations or interrupted:
                break
            if max_seconds is not None and time.monotonic() - t_start > max_seconds:
                interrupted = True
                break
    except KeyboardInterrupt:
        # the reference's opInterrupt: abort mid-solve, keep partial state
        interrupted = True

    new_vel, valid, stats = _chunk_finalize(grid, scene, params, cls, asm, carry, loop.passes)
    stats["interrupted"] = interrupted
    stats["capture_seconds"] = loop.capture_seconds or 0.0  # as step's
    stats["sharded"] = sharded
    return new_vel, valid, stats
