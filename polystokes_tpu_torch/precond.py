"""The CELL_ARROW preconditioner factors (``polystokes_tpu.precond``).

Per cell, the exact 4x4 restriction of -A to (p, tau_xx, tau_yy, tau_zz)
is the arrow matrix

    [ sum_a k_a   -k_x       -k_y       -k_z     ]
    [ -k_x         k_x + h    0          0       ]
    [ -k_y         0          k_y + h    0       ]
    [ -k_z         0          0          k_z + h ],

k_a = sum over the cell's two a-faces of coeff^2 * (dt McInv + q_red),
h = 0.5 uInv.  It inverts in closed form through the scalar Schur
complement s = sum_a k_a h / (k_a + h); edge stresses get scalar Jacobi.
"""
from __future__ import annotations

import torch

from .basis import monomial_matrix, monomials_xyz, n_monomials
from .classify import REDUCED
from .config import SolverParams
from .operators import Assembled, coeff_fields, face_at_cell, scatter_face_to_edge
from .reduced import _face_offset_grids, block_broadcast


def _diag_quadratic_form(grid, cls, asm, params, a):
    """q_f = c_f^T BInv[r_f] c_f per face of axis a (0 off reduced faces),
    through the per-region [K, K] matrix G = A^T BInv A, gathered per cube."""
    dtype = params.dtype
    reg = cls.face_region[a]
    red = (cls.face_labels[a] == REDUCED) & (reg >= 0)
    A = torch.as_tensor(monomial_matrix(a, params.basis), dtype=dtype, device=reg.device)
    G = torch.einsum("dk,rde,el->rkl", A, asm.binv, A)  # [R, K, K]
    K = n_monomials(params.basis)
    T = params.tile_size
    cs = tuple(-(-n // T) for n in cls.cell_labels.shape)
    roc = cls.region_of_cube
    safe_c = roc.clamp(0, G.shape[0] - 1).long()
    mono = monomials_xyz(*_face_offset_grids(cls, asm.com, a, params, T, cs), params.basis)
    q = torch.zeros(reg.shape, dtype=dtype, device=reg.device)
    for k in range(K):
        for l in range(k, K):
            gc = torch.where(roc >= 0, G[safe_c, k, l], 0.0)
            gkl = block_broadcast(gc, (a,), T, cs, reg.shape)
            scale = 1.0 if k == l else 2.0
            q = q + scale * gkl * mono[k] * mono[l]
    return torch.where(red, q, 0.0)


def _axis_cell_k_and_edge_diag(grid, cls, asm: Assembled, params: SolverParams):
    """Per-axis cell coefficients k_a and the edge-stress diagonals (the
    halves of |diag(A)| without the uInv mass terms); the reduced quadratic
    form enters only when there are regions."""
    k = []
    te_d = [torch.zeros_like(asm.uinv_e[e]) for e in range(3)]
    for a in range(3):
        c_lo, c_hi, erow = coeff_fields(asm, a)
        wgt = asm.dt * asm.mc_inv[a]
        if params.do_reduced_regions:
            wgt = wgt + _diag_quadratic_form(grid, cls, asm, params, a)
        # the cell's lower face carries the c_hi coefficient, upper face c_lo
        k.append(face_at_cell(c_hi**2 * wgt, a, 0) + face_at_cell(c_lo**2 * wgt, a, 1))
        for e, (elo, ehi) in erow.items():
            te_d[e] = te_d[e] + scatter_face_to_edge(elo**2 * wgt, a, e, 0) + scatter_face_to_edge(ehi**2 * wgt, a, e, 1)
    return k, te_d


def _safe_inv(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)


def cell_arrow_factors(grid, cls, asm: Assembled, params: SolverParams):
    """The arrow-block inverse factors (k, inv_d, kd, inv_schur, te_inv)."""
    k, te_d = _axis_cell_k_and_edge_diag(grid, cls, asm, params)
    h = 0.5 * asm.uinv_c
    inv_d = [_safe_inv(k[a] + h) for a in range(3)]
    schur = sum(k[a] * h * inv_d[a] for a in range(3))
    inv_schur = _safe_inv(schur)
    kd = [k[a] * inv_d[a] for a in range(3)]
    te_inv = tuple(_safe_inv(te_d[e] + 0.5 * asm.uinv_e[e]) for e in range(3))
    return k, inv_d, kd, inv_schur, te_inv
