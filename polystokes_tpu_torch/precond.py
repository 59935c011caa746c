"""The DIAGONAL, CELL_ARROW and REGION_ARROW preconditioners
(``polystokes_tpu.precond``): their factors, which the packed path
(``solver.precond_factors_packed``) packs for its kernels, and their
solves on (p, tau) vectors, which the unpacked path runs
(``make_preconditioner``).  DIAGONAL is Jacobi on |diag(A)|
(``schur_diagonal``); IDENTITY needs no factors.

Per cell, the exact 4x4 restriction of -A to (p, tau_xx, tau_yy, tau_zz)
is the arrow matrix

    [ sum_a k_a   -k_x       -k_y       -k_z     ]
    [ -k_x         k_x + h    0          0       ]
    [ -k_y         0          k_y + h    0       ]
    [ -k_z         0          0          k_z + h ],

k_a = sum over the cell's two a-faces of coeff^2 * (dt McInv + q_red),
h = 0.5 uInv.  It inverts in closed form through the scalar Schur
complement s = sum_a k_a h / (k_a + h); edge stresses get scalar Jacobi.

REGION_ARROW adds the exact per-region boundary part of J^T BInv J to
the arrow block M0 (which then leaves the reduced quadratic form out) and
applies it through the Woodbury identity

    M^-1 r = y - M0^-1 U^T S^-1 U y,   y = M0^-1 r,   U = J chi F,

with the per-region capacitance S = B + U M0^-1 U^T (``region_schur_inv``).
"""
from __future__ import annotations

import torch

from .basis import monomial_matrix, monomials_xyz, n_monomials
from .classify import REDUCED
from .config import PreconditionerType, SolverParams
from .operators import (
    Assembled,
    PTau,
    coeff_fields,
    face_at_cell,
    forward_face_values,
    scatter_face_to_edge,
    transpose_from_faces,
)
from .reduced import Coupling, _face_monomials_general, _face_offset_grids, _use_tiled, block_broadcast


def _diag_quadratic_form(grid, cls, asm, params, a):
    """q_f = c_f^T BInv[r_f] c_f per face of axis a (0 off reduced faces),
    through the per-region [K, K] matrix G = A^T BInv A: per cube on the
    cube-major path, per face on the segmented one."""
    dtype = params.dtype
    reg = cls.face_region[a]
    red = (cls.face_labels[a] == REDUCED) & (reg >= 0)
    A = torch.as_tensor(monomial_matrix(a, params.basis), dtype=dtype, device=reg.device)
    G = torch.einsum("dk,rde,el->rkl", A, asm.binv, A)  # [R, K, K]
    K = n_monomials(params.basis)
    if _use_tiled(params):
        T = params.tile_size
        cs = tuple(-(-n // T) for n in cls.cell_labels.shape)
        roc = cls.region_of_cube
        safe_c = roc.clamp(0, G.shape[0] - 1).long()
        mono = monomials_xyz(*_face_offset_grids(cls, asm.com, a, params, T, cs), params.basis)

        def g_kl(k, l):
            return block_broadcast(torch.where(roc >= 0, G[safe_c, k, l], 0.0), (a,), T, cs, reg.shape)
    else:
        safe = reg.clamp(0, G.shape[0] - 1).long()
        mono = _face_monomials_general(cls, asm.com, a, params)

        def g_kl(k, l):
            return G[:, k, l][safe]
    q = torch.zeros(reg.shape, dtype=dtype, device=reg.device)
    for k in range(K):
        for l in range(k, K):
            q = q + (1.0 if k == l else 2.0) * g_kl(k, l) * mono[k] * mono[l]
    return torch.where(red, q, 0.0)


def _axis_cell_k_and_edge_diag(grid, cls, asm: Assembled, params: SolverParams, include_reduced_q: bool = True):
    """Per-axis cell coefficients k_a and the edge-stress diagonals (the
    halves of |diag(A)| without the uInv mass terms); the reduced quadratic
    form enters only when there are regions and ``include_reduced_q`` (off
    under REGION_ARROW, whose Woodbury block holds that term exactly)."""
    k = []
    te_d = [torch.zeros_like(asm.uinv_e[e]) for e in range(3)]
    for a in range(3):
        c_lo, c_hi, erow = coeff_fields(asm, a)
        wgt = asm.dt * asm.mc_inv[a]
        if params.do_reduced_regions and include_reduced_q:
            wgt = wgt + _diag_quadratic_form(grid, cls, asm, params, a)
        # the cell's lower face carries the c_hi coefficient, upper face c_lo
        k.append(face_at_cell(c_hi**2 * wgt, a, 0) + face_at_cell(c_lo**2 * wgt, a, 1))
        for e, (elo, ehi) in erow.items():
            te_d[e] = te_d[e] + scatter_face_to_edge(elo**2 * wgt, a, e, 0) + scatter_face_to_edge(ehi**2 * wgt, a, e, 1)
    return k, te_d


def schur_diagonal(grid, cls, asm: Assembled, params: SolverParams) -> PTau:
    """|diag(A)| as a PTau (positive on DOFs, zero elsewhere): the Jacobi
    diagonal of the DIAGONAL preconditioner."""
    k, te_d = _axis_cell_k_and_edge_diag(grid, cls, asm, params)
    tc = tuple(k[a] + 0.5 * asm.uinv_c for a in range(3))
    te = tuple(te_d[e] + 0.5 * asm.uinv_e[e] for e in range(3))
    return PTau(p=k[0] + k[1] + k[2], tc=tc, te=te)


def _safe_inv(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)


def cell_arrow_factors(grid, cls, asm: Assembled, params: SolverParams, include_reduced_q: bool = True):
    """The arrow-block inverse factors (k, inv_d, kd, inv_schur, te_inv)."""
    k, te_d = _axis_cell_k_and_edge_diag(grid, cls, asm, params, include_reduced_q)
    h = 0.5 * asm.uinv_c
    inv_d = [_safe_inv(k[a] + h) for a in range(3)]
    schur = sum(k[a] * h * inv_d[a] for a in range(3))
    inv_schur = _safe_inv(schur)
    kd = [k[a] * inv_d[a] for a in range(3)]
    te_inv = tuple(_safe_inv(te_d[e] + 0.5 * asm.uinv_e[e]) for e in range(3))
    return k, inv_d, kd, inv_schur, te_inv


def _arrow_solve_from(k, inv_d, kd, inv_schur, te_inv):
    """The arrow solve M0^-1 on PTau values, from ``cell_arrow_factors``."""

    def solve(r: PTau) -> PTau:
        z_p = (r.p + sum(kd[a] * r.tc[a] for a in range(3))) * inv_schur
        z_tc = tuple((r.tc[a] + k[a] * z_p) * inv_d[a] for a in range(3))
        z_te = tuple(r.te[e] * te_inv[e] for e in range(3))
        return PTau(p=z_p, tc=z_tc, te=z_te)

    return solve


def make_cell_arrow(grid, cls, asm: Assembled, params: SolverParams, include_reduced_q: bool = True):
    """The closed-form inverse of the per-cell arrow block on PTau values."""
    return _arrow_solve_from(*cell_arrow_factors(grid, cls, asm, params, include_reduced_q))


def region_schur_inv(grid, cls, asm: Assembled, params: SolverParams, R: int, arrow_solve):
    """inv(S), S_r = B_r + (U M0^-1 U^T)_rr per region, 0 on invalid regions.

    Column d of U M0^-1 U^T for every region at once is
    reduce_J(F M0^-1 F^T chi J^T e_d): the regions' stencil footprints are
    disjoint (the boundary separation of classify), so the capacitance is
    block-diagonal per region.  D probes, a Python loop over the full grid
    through one ``Coupling``; then C is symmetrised and S inverted by
    Cholesky, as ``finalize_reduced`` inverts B."""
    D = params.reduced_dof
    eye = torch.eye(D, dtype=params.dtype, device=asm.dt.device)
    J = Coupling(grid, cls, asm.com, params, R)
    cols = []
    for d in range(D):
        u = J.expand(eye[d].expand(R, D))  # chi J^T e_d
        s = forward_face_values(asm, arrow_solve(transpose_from_faces(asm, u)))  # F M0^-1 F^T
        cols.append(J.reduce(s))  # J chi
    C = torch.stack(cols, dim=-1)  # [R, D, D], column d from probe d
    C = 0.5 * (C + C.transpose(1, 2))
    valid = asm.region_valid[:, None, None]
    S = torch.where(valid, asm.mr / asm.dt + 2.0 * asm.vr + C, eye)
    return torch.where(valid, torch.cholesky_inverse(torch.linalg.cholesky(S)), 0.0)


def make_region_arrow(grid, cls, asm: Assembled, params: SolverParams):
    """REGION_ARROW on PTau values: the arrow block M0 without the reduced
    quadratic form, plus the exact per-region restriction of J^T BInv J
    through the Woodbury identity (module doc); the plain arrow solve
    without regions."""
    if not params.do_reduced_regions:
        return make_cell_arrow(grid, cls, asm, params)
    R = asm.binv.shape[0]
    arrow = make_cell_arrow(grid, cls, asm, params, include_reduced_q=False)
    sinv = region_schur_inv(grid, cls, asm, params, R, arrow)
    J = Coupling(grid, cls, asm.com, params, R)

    def solve(r: PTau) -> PTau:
        y = arrow(r)
        w = torch.einsum("rij,rj->ri", sinv, J.reduce(forward_face_values(asm, y)))  # S^-1 U y
        return y - arrow(transpose_from_faces(asm, J.expand(w)))

    return solve


def make_preconditioner(grid, cls, asm: Assembled, params: SolverParams):
    """The preconditioner's solve on PTau values (the unpacked path): None
    for IDENTITY, Jacobi on |diag(A)| for DIAGONAL, the arrow solves for
    CELL_ARROW and REGION_ARROW, the V-cycle of ``multigrid`` for
    MULTIGRID."""
    if params.preconditioner == PreconditionerType.IDENTITY:
        return None
    if params.preconditioner == PreconditionerType.CELL_ARROW:
        return make_cell_arrow(grid, cls, asm, params)
    if params.preconditioner == PreconditionerType.REGION_ARROW:
        return make_region_arrow(grid, cls, asm, params)
    if params.preconditioner == PreconditionerType.MULTIGRID:
        from .multigrid import make_multigrid

        return make_multigrid(grid, cls, asm, params)
    d = schur_diagonal(grid, cls, asm, params)
    inv = PTau(p=_safe_inv(d.p), tc=tuple(_safe_inv(t) for t in d.tc), te=tuple(_safe_inv(t) for t in d.te))

    def solve(r: PTau) -> PTau:
        return PTau(p=inv.p * r.p, tc=tuple(i * t for i, t in zip(inv.tc, r.tc)),
                    te=tuple(i * t for i, t in zip(inv.te, r.te)))

    return solve
