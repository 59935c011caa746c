"""One implicit Stokes step: weights -> classify -> reduce -> assemble ->
solve -> recover -> write back, the counterpart of ``polystokes_tpu.solver``
on its packed-kernel path (reference: exec/HDK_PolyStokes.C:222-609
``solveGasSubclass``).

Every tensor lives on the device of the scene's tensors.  The Krylov loop
runs on packed [7, nx, ny, nz] vectors through the kernels of
``packed_apply``.  The reduced apply is per-cube moments -> the small
per-cube region algebra -> polynomial expand -> the reduced apply; with
``fuse_pap`` each CG iteration instead runs the fused grid branch with
moments and <p, A p> partials -> region algebra -> expand -> finish.  The
uniform solve (``do_reduced_regions=False``) runs one kernel per apply.
With ``fuse_update`` and a pointwise preconditioner (CELL_ARROW, DIAGONAL,
IDENTITY) one kernel does the CG's vector update, preconditioner and dots;
under ``fuse_pap`` on the reduced step it also does the finish (and with
``fuse_expand`` the expand), which the apply then defers to it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import krylov
from .basis import monomial_matrix, monomial_shift_matrix, n_monomials
from .classify import REDUCED, SOLID, UNSOLVED, Classification, classify, effective_max_regions, is_active
from .config import MINWEIGHT, PreconditionerType, SolverParams
from .grid import EDGE_OFFSET_AXES, Grid
from .operators import (
    Assembled,
    PTau,
    build_diagonals,
    build_gated_weights,
    coeff_fields,
    face_at_cell,
    forward_face_values,
    scatter_face_to_edge,
    transpose_from_faces,
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
from .precond import _arrow_solve_from, _safe_inv, cell_arrow_factors, region_schur_inv, schur_diagonal
from .reduced import ReducedData, RegionSum, build_reduced, expand_J, finalize_reduced, reduce_J
from .weights import compute_weights


@dataclasses.dataclass(frozen=True)
class Scene:
    """One solve's input state on the MAC grid (the reference's Houdini
    input fields, exec/HDK_PolyStokes.C:235-314).

    Optional ``surface_weights`` / ``collision_weights`` (3 face tensors
    each) override the face liquid / fluid weights, floored at MINWEIGHT
    where positive (Solver.cpp:183-237).  ``density`` is carried as in the
    JAX package, where ``step`` does not read it either."""

    surface_sdf: torch.Tensor  # (nx,ny,nz) liquid SDF at centers, <0 inside
    collision_sdf: torch.Tensor  # (nx,ny,nz) solid SDF at centers, <0 inside
    velocity: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # face arrays
    collision_velocity: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    viscosity: torch.Tensor  # (nx,ny,nz) dynamic viscosity at centers
    dt: torch.Tensor  # 0-d timestep
    surface_weights: Optional[tuple] = None
    collision_weights: Optional[tuple] = None
    density: Optional[torch.Tensor] = None


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
# The packed Schur operator (ApplyPressureStressMatrix.h:102-179)
# ---------------------------------------------------------------------------

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
    red_packed = torch.stack([_face_to_slot(m.to(dtype), a) for a, m in enumerate(reduced_face_masks(cls))], dim=0).contiguous()
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


def make_apply_packed(grid: Grid, cls: Classification, asm: Assembled, params: SolverParams, R: int):
    """The kernel apply on packed [7, nx, ny, nz] vectors: moments kernel
    -> region algebra -> expand kernel -> reduced-apply kernel (which
    recomputes s rather than storing it); the uniform solve runs the
    uniform-apply kernel alone."""
    if not params.do_reduced_regions:
        coeffs = pack_coeffs(asm)
        return lambda xp: apply_uniform_packed(xp, coeffs)
    coeffs = pack_coeffs(asm, cls)
    T = params.tile_size
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, R)

    def apply_packed(xp):
        up = expand_packed(algebra(moments_packed(xp, coeffs, T)), red_packed, T)
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
        coeffs = pack_coeffs(asm)

        def apply_dot_uniform(xp):
            out, pap = apply_uniform_pap_packed(xp, coeffs)
            return out, torch.sum(pap)

        return apply_dot_uniform
    coeffs = pack_coeffs(asm, cls)
    T = params.tile_size
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, R)
    fuse_expand = _fuse_expand_ok(params)

    def apply_dot(xp):
        out_grid, mom, pap_grid = grid_mom_pap_packed(xp, coeffs, T)
        v = algebra(mom)
        pap = torch.sum(pap_grid) - torch.sum(mom * v)
        if defer_finish and fuse_expand:
            return (out_grid, v), pap
        up = expand_packed(v, red_packed, T)
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
    ``out`` (x', r') names the tensors the kernel writes x' and r' to."""
    if not params.fuse_update:
        return None
    if params.preconditioner == PreconditionerType.CELL_ARROW:
        fstack, kind = pack_arrow_factors(factors), "arrow"
    elif params.preconditioner == PreconditionerType.DIAGONAL:
        fstack, kind = factors["inv_packed"], "diag"
    elif params.preconditioner == PreconditionerType.IDENTITY:
        fstack, kind = None, "none"
    else:
        return None
    coeffs = pack_coeffs(asm, cls) if params.do_reduced_regions else None
    fuse_expand = _fuse_expand_ok(params)
    T = params.tile_size

    def fused(x, r, p, ap, alpha, out=None):
        if isinstance(ap, tuple):
            og, tail = ap
            if fuse_expand:
                return exp_finish_update_packed(x, r, p, alpha, coeffs, og, tail, T, factors=fstack, kind=kind, out=out)
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
    T = params.tile_size
    coeffs = pack_coeffs(asm, cls)
    algebra, red_packed = _region_algebra_packed(grid, cls, asm, params, asm.binv.shape[0], matrix=factors["sinv"])

    def solve_region(rp):
        y = solve_arrow(rp)
        up = expand_packed(algebra(moments_packed(y, coeffs, T)), red_packed, T)
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


def _build_krylov_system(grid: Grid, cls, asm, scene: Scene, params: SolverParams, initial_guess=None, pfac=None):
    """(apply_K, apply_dot, fused_update, precond, b_K, x0_K) on the packed
    layout: the unsharded, undeflated branch of the JAX package's
    ``_build_krylov_system``; ``apply_dot`` is the fused apply with
    <p, A p> under ``fuse_pap``, else None; ``fused_update`` the fused CG
    update under ``fuse_update`` with a pointwise preconditioner, else
    None.  ``initial_guess`` (a PTau) seeds the solve, else zero; ``pfac``
    (``precond_factors_packed``) skips the factors, which
    ``solve_chunked`` computes once."""
    R = effective_max_regions(grid, params)
    b_K = pack_ptau(build_rhs(grid, cls, asm, params, R))
    apply_K = make_apply_packed(grid, cls, asm, params, R)
    if pfac is None:
        pfac = precond_factors_packed(grid, cls, asm, params)
    fused_update = make_fused_update(params, pfac, cls, asm)
    apply_dot = (make_apply_packed_pap(grid, cls, asm, params, R, defer_finish=_defer_finish(params, fused_update))
                 if params.fuse_pap else None)
    precond = make_preconditioner_packed(grid, cls, asm, params, pfac)
    x0_K = torch.zeros_like(b_K) if initial_guess is None else pack_ptau(initial_guess).to(b_K.dtype)
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
    """Pre-flight of the packed layout: raises ValueError when the scene
    has active DOFs on the dropped index-0 planes (the unpacked apply that
    the JAX package falls back to is not ported); else returns params."""
    n = boundary_activity(grid, scene, params)
    if n:
        raise ValueError(
            f"scene has {n} active DOFs on the domain-boundary index-0 planes, "
            "which the packed layout drops"
        )
    return params


def _write_back(grid: Grid, scene: Scene, params: SolverParams, cls: Classification, asm: Assembled,
                res: krylov.KrylovResult):
    """Unpack, recover, write back, the boundary fail-safe,
    ``keep_non_converged`` and the stats: the tail of ``step`` and
    ``solve_chunked``."""
    R = effective_max_regions(grid, params)
    x = unpack_ptau(res.x)
    v, w = recover_velocity(grid, cls, asm, x, params, R)
    new_vel, valid = apply_solution_to_velocity(grid, cls, asm, scene, v, w, params)

    # fail safe on the packed layout invariant: liquid touching the domain
    # box puts active DOFs on the dropped index-0 planes, so the solve is
    # reported as failed instead of returning wrong physics
    boundary_active = _boundary_active(cls)
    converged = bool(res.converged) and boundary_active == 0
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


def _chunk_init(grid: Grid, scene: Scene, params: SolverParams, cls, asm, initial_guess=None, pfac=None):
    """(carry, loop): the initial PCG carry and the ``krylov.PCGLoop`` that
    holds the Krylov system, whose CUDA graph every segment replays (JAX's
    ``_chunk_init`` returns the carry and rebuilds the system inside each
    jitted segment)."""
    apply_K, apply_dot, fused_update, precond, b_K, x0_K = _build_krylov_system(grid, cls, asm, scene, params,
                                                                                 initial_guess, pfac)
    loop = krylov.PCGLoop(apply_K, precond, tol=params.tolerance, max_iters=params.max_iterations, apply_dot=apply_dot,
                          fused_update=fused_update)
    return krylov.pcg_init(apply_K, b_K, x0_K, precond), loop


def _chunk_segment(loop: krylov.PCGLoop, carry: krylov.PCGCarry, segment_iters: int) -> krylov.PCGCarry:
    """At most ``segment_iters`` more iterations of the loop from carry."""
    return loop.segment(carry, segment_iters)


def _chunk_finalize(grid: Grid, scene: Scene, params: SolverParams, cls, asm, carry: krylov.PCGCarry, passes: int = 0):
    """(new_velocity, valid_masks, stats) from the final carry; ``passes``
    is the loop passes launched, reported as ``loop_passes``."""
    return _write_back(grid, scene, params, cls, asm, krylov.pcg_result(carry, passes))


def step(grid: Grid, scene: Scene, params: SolverParams, initial_guess=None):
    """One Stokes solve.  Returns (new_velocity, valid_masks, stats).
    ``initial_guess`` (optional PTau) seeds the Krylov solve, as in the JAX
    package.  The packed kernels need ``tile_size`` to divide every
    resolution."""
    cls, asm = _setup(grid, scene, params)
    if not params.do_solve:
        x0_K = _build_krylov_system(grid, cls, asm, scene, params, initial_guess)[-1]
        res = krylov.KrylovResult(x=x0_K, iterations=0, error=0.0, converged=True, applies=0, passes=0)
        return _write_back(grid, scene, params, cls, asm, res)
    carry, loop = _chunk_init(grid, scene, params, cls, asm, initial_guess)
    return _chunk_finalize(grid, scene, params, cls, asm, loop.segment(carry), loop.passes)


def solve_chunked(grid: Grid, scene: Scene, params: SolverParams, segment_iters: int = 500, max_seconds: float = None,
                  callback=None, state_path: str = None, resume: bool = False, initial_guess=None):
    """One Stokes solve as a host loop over CG segments of at most
    ``segment_iters`` iterations, the Krylov state held on the device
    between them, as the JAX package's ``solve_chunked`` (without its
    ``mesh``).  It restores the reference's interrupt semantics (opInterrupt
    polling, Classifier.cpp:73-74): Ctrl-C between segments returns the
    partial result under ``keep_non_converged``.

      * max_seconds: stop after the segment in which this much wall-clock
        has passed (partial result)
      * callback(stats_dict) -> truthy to request a stop
      * state_path + resume: persist the PCG carry after each segment
        (``np.savez``, keys leaf0..leaf6 = x, r, p, rsold, k, rre, done, as
        the JAX package writes them) and resume a killed run from it (same
        scene and params)

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
    _v("setup...")
    cls, asm = _setup(grid, scene, params)
    _v("precond factors...")
    pfac = precond_factors_packed(grid, cls, asm, params)
    _v("chunk init...")
    carry, loop = _chunk_init(grid, scene, params, cls, asm, initial_guess, pfac)
    _v("first segment...")
    if resume and state_path and os.path.exists(state_path):
        with np.load(state_path) as d:
            carry = krylov.PCGCarry(*(torch.as_tensor(d[f"leaf{i}"]).to(device=t.device, dtype=t.dtype)
                                      for i, t in enumerate(carry)))

    interrupted = False
    try:
        while True:
            carry = _chunk_segment(loop, carry, segment_iters)
            k, done, rre = int(carry.k), bool(carry.done), float(carry.rre)
            _v(f"segment done: k={k} rre={rre:.3e} done={done}")
            if state_path:
                np.savez(state_path, **{f"leaf{i}": t.cpu().numpy() for i, t in enumerate(carry)})
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
    return new_vel, valid, stats
