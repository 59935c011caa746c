"""The geometric multigrid preconditioner (``PreconditionerType.MULTIGRID``)
for the pressure-stress Schur system, the counterpart of
``polystokes_tpu.multigrid``.

The Schur operator's grid part is a variable-coefficient div-grad over the
7 (p, tau) fields whose coefficients are the gated weight fields
(``operators``), dense and regular, so it coarsens geometrically:

  * smoother      Chebyshev acceleration of the CELL_ARROW block solve
                  (the ``precond`` arrow algebra, built per level from
                  that level's fields)
  * transfers     cells (p, tc): piecewise-constant P, R = (1/8) P^T
                  (8-child average); node lattices (face/edge axes):
                  linear P, R = (1/2) P^T per axis ([1/4, 1/2, 1/4])
  * coarse ops    rediscretization with restricted coefficient fields and
                  dt_l = 2^l dt, which reproduces the Galerkin scaling of
                  both the conductance part and the uInv mass part for
                  piecewise-constant interpolation
  * reduced term  J^T BInv J is left out of the level operators (a
                  rank-26-per-region coupling, not a grid stencil); its
                  per-face diagonal is folded into the finest smoother

The V(1,1) cycle with pre-smoothing from zero and matching post-smoothing
is a fixed symmetric positive definite operator, so plain PCG (the
reference's convergence semantics) stays valid.  Plain torch on the
level fields, run by the unpacked path (``solver._use_packed`` sends
MULTIGRID unpacked, as the JAX package does); the spectral estimates stay
0-d tensors on the device, so the cycle has no host read and replays in
the CG loop's CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .config import SolverParams
from .grid import EDGE_OFFSET_AXES, pad_axis
from .operators import PTau, cell_at_face, edge_at_face, face_at_cell, forward_face_values, scatter_face_to_edge, \
    transpose_from_faces


def _scale(x: PTau, a) -> PTau:
    return PTau(p=a * x.p, tc=tuple(a * t for t in x.tc), te=tuple(a * t for t in x.te))


def _dot(x: PTau, y: PTau):
    """The JAX package's ``PTau.dot``: one sum per field, added in field order."""
    return sum(torch.sum(a * b) for a, b in zip(x.fields(), y.fields()))


# ---------------------------------------------------------------------------
# 1-D transfer primitives
# ---------------------------------------------------------------------------

def _cell_restrict_axis(x, axis):
    """Pairwise mean along a cell axis (PW-constant R contribution 1/2)."""
    n = x.shape[axis]
    nc = -(-n // 2)
    x = pad_axis(x, axis, 0, 2 * nc - n, 0.0)
    shape = list(x.shape)
    shape[axis] = nc
    shape.insert(axis + 1, 2)
    return x.reshape(shape).mean(dim=axis + 1)


def _cell_prolong_axis(x, axis, n_fine):
    """PW-constant prolongation (copy to both children)."""
    return torch.repeat_interleave(x, 2, dim=axis).narrow(axis, 0, n_fine)


def _node_restrict_axis(x, axis, nc_nodes):
    """Full weighting on a node lattice: coarse J = x[2J]/2 + (x[2J-1] +
    x[2J+1])/4  (= (1/2) P^T for linear P)."""
    n = x.shape[axis]
    need = 2 * (nc_nodes - 1) + 2  # max fine index touched is 2(nc-1)+1
    xp = pad_axis(x, axis, 1, max(0, need - n), 0.0)  # one ghost at the front for 2J-1

    def sl(start):
        s = [slice(None)] * x.ndim
        s[axis] = slice(start, start + 2 * nc_nodes, 2)
        return xp[tuple(s)].narrow(axis, 0, nc_nodes)

    return 0.5 * sl(1) + 0.25 * (sl(0) + sl(2))


def _node_prolong_axis(x, axis, n_fine_nodes):
    """Linear interpolation on a node lattice: fine 2J = coarse J,
    fine 2J+1 = (coarse J + coarse J+1)/2."""
    nc = x.shape[axis]
    hi = pad_axis(x, axis, 0, 1, 0.0).narrow(axis, 1, nc)
    odd = 0.5 * (x + hi)
    out = torch.stack([x, odd], dim=axis + 1)
    merged = list(out.shape)
    merged[axis] = 2 * nc
    merged.pop(axis + 1)
    return out.reshape(merged).narrow(axis, 0, n_fine_nodes)


def _restrict_family(x, node_axes, coarse_shape):
    for ax in range(3):
        if ax in node_axes:
            x = _node_restrict_axis(x, ax, coarse_shape[ax])
        else:
            x = _cell_restrict_axis(x, ax)
    return x


def _prolong_family(x, node_axes, fine_shape):
    for ax in range(3):
        if ax in node_axes:
            x = _node_prolong_axis(x, ax, fine_shape[ax])
        else:
            x = _cell_prolong_axis(x, ax, fine_shape[ax])
    return x


def _face_node_axes(a):
    return (a,)


def _edge_node_axes(e):
    return EDGE_OFFSET_AXES[e]


# ---------------------------------------------------------------------------
# Levels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Level:
    """One grid level's operator coefficients (duck-typed like Assembled
    for forward_face_values / transpose_from_faces)."""

    res: Tuple[int, int, int]
    dt: torch.Tensor
    clw_s: torch.Tensor
    elw_s: Tuple[torch.Tensor, ...]
    ffw: Tuple[torch.Tensor, ...]
    mc_inv: Tuple[torch.Tensor, ...]
    uinv_c: torch.Tensor
    uinv_e: Tuple[torch.Tensor, ...]


def _coarsen_level(lvl: Level) -> Level:
    res_c = tuple(-(-n // 2) for n in lvl.res)

    def face_shape_c(a):
        return tuple(res_c[i] + (1 if i == a else 0) for i in range(3))

    def edge_shape_c(e):
        p, q = EDGE_OFFSET_AXES[e]
        return tuple(res_c[i] + (1 if i in (p, q) else 0) for i in range(3))

    # clw_s carries 1/dx: clw'/dx' = mean(clw)/(2 dx)
    clw_s = 0.5 * _restrict_family(lvl.clw_s, (), res_c)
    elw_s = tuple(0.5 * _restrict_family(lvl.elw_s[e], _edge_node_axes(e), edge_shape_c(e)) for e in range(3))
    ffw = tuple(_restrict_family(lvl.ffw[a], _face_node_axes(a), face_shape_c(a)) for a in range(3))
    # mc_inv: restrict the mass, re-invert on the support
    mc_inv = []
    for a in range(3):
        m = torch.where(lvl.mc_inv[a] > 0, 1.0 / torch.where(lvl.mc_inv[a] > 0, lvl.mc_inv[a], 1.0), 0.0)
        mc = _restrict_family(m, _face_node_axes(a), face_shape_c(a))
        mc_inv.append(torch.where(mc > 1e-12, 1.0 / torch.where(mc > 1e-12, mc, 1.0), 0.0))
    uinv_c = _restrict_family(lvl.uinv_c, (), res_c)
    uinv_e = tuple(_restrict_family(lvl.uinv_e[e], _edge_node_axes(e), edge_shape_c(e)) for e in range(3))
    return Level(res=res_c, dt=2.0 * lvl.dt, clw_s=clw_s, elw_s=elw_s, ffw=ffw, mc_inv=tuple(mc_inv),
                 uinv_c=uinv_c, uinv_e=uinv_e)


def _pos_apply(lvl: Level, x: PTau) -> PTau:
    """(-A) at this level, reduced term excluded: dt [G Dt]^T McInv [G Dt]
    + (1/2) uInv mass."""
    s = forward_face_values(lvl, x)
    fv = [lvl.dt * lvl.mc_inv[a] * s[a] for a in range(3)]
    out = transpose_from_faces(lvl, fv)
    tc = tuple(out.tc[a] + 0.5 * lvl.uinv_c * x.tc[a] for a in range(3))
    te = tuple(out.te[e] + 0.5 * lvl.uinv_e[e] * x.te[e] for e in range(3))
    return PTau(p=out.p, tc=tc, te=te)


def _level_arrow(lvl: Level, q_faces=None):
    """Arrow-block smoother for this level (the precond.make_cell_arrow
    algebra on raw level fields).  ``q_faces`` optionally adds the
    reduced J^T BInv J per-face diagonal (finest level only)."""
    k = []
    te_d = [torch.zeros_like(lvl.uinv_e[e]) for e in range(3)]
    for a in range(3):
        c_lo = lvl.ffw[a] * cell_at_face(lvl.clw_s, a, 0)
        c_hi = lvl.ffw[a] * cell_at_face(lvl.clw_s, a, 1)
        wgt = lvl.dt * lvl.mc_inv[a]
        if q_faces is not None:
            wgt = wgt + q_faces[a]
        k.append(face_at_cell(c_hi**2 * wgt, a, 0) + face_at_cell(c_lo**2 * wgt, a, 1))
        for e in range(3):
            if e == a:
                continue
            elo = lvl.ffw[a] * edge_at_face(lvl.elw_s[e], a, e, 0)
            ehi = lvl.ffw[a] * edge_at_face(lvl.elw_s[e], a, e, 1)
            te_d[e] = te_d[e] + scatter_face_to_edge(elo**2 * wgt, a, e, 0) + scatter_face_to_edge(ehi**2 * wgt, a, e, 1)

    def inv(x):
        return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)

    h = 0.5 * lvl.uinv_c
    inv_d = [inv(k[a] + h) for a in range(3)]
    schur = sum(k[a] * h * inv_d[a] for a in range(3))
    inv_schur = inv(schur)
    kd = [k[a] * inv_d[a] for a in range(3)]
    te_inv = tuple(inv(te_d[e] + 0.5 * lvl.uinv_e[e]) for e in range(3))

    def solve(r: PTau) -> PTau:
        z_p = (r.p + sum(kd[a] * r.tc[a] for a in range(3))) * inv_schur
        z_tc = tuple((r.tc[a] + k[a] * z_p) * inv_d[a] for a in range(3))
        z_te = tuple(r.te[e] * te_inv[e] for e in range(3))
        return PTau(p=z_p, tc=z_tc, te=z_te)

    return solve


def _restrict_ptau(r: PTau, lvl_c: Level) -> PTau:
    res_c = lvl_c.res
    return PTau(
        p=_restrict_family(r.p, (), res_c),
        tc=tuple(_restrict_family(r.tc[a], (), res_c) for a in range(3)),
        te=tuple(_restrict_family(r.te[e], _edge_node_axes(e), lvl_c.uinv_e[e].shape) for e in range(3)),
    )


def _prolong_ptau(e_c: PTau, lvl_f: Level) -> PTau:
    res_f = lvl_f.res
    return PTau(
        p=_prolong_family(e_c.p, (), res_f),
        tc=tuple(_prolong_family(e_c.tc[a], (), res_f) for a in range(3)),
        te=tuple(_prolong_family(e_c.te[e], _edge_node_axes(e), lvl_f.uinv_e[e].shape) for e in range(3)),
    )


# ---------------------------------------------------------------------------
# The V-cycle
# ---------------------------------------------------------------------------

def _seed_ptau(lvl: Level, dtype) -> PTau:
    """Deterministic pseudo-random PTau for the power iteration, the JAX
    package's hash noise fract(sin(i 12.9898 + salt) 43758.5453) - 1/2 (no
    generator: the preconditioner depends on the level alone).  The 43758x
    gain makes the noise follow the last bits of ``sin``: in f32 it differs
    between the card and the CPU, and so does lambda_max slightly."""
    dev = lvl.clw_s.device

    def noise(shape, salt):
        n = shape[0] * shape[1] * shape[2]
        i = torch.arange(n, dtype=dtype, device=dev).reshape(shape)
        return torch.remainder(torch.sin(i * 12.9898 + salt) * 43758.5453, 1.0) - 0.5

    return PTau(
        p=noise(lvl.clw_s.shape, 1.0),
        tc=tuple(noise(lvl.clw_s.shape, 2.0 + a) for a in range(3)),
        te=tuple(noise(lvl.uinv_e[e].shape, 5.0 + e) for e in range(3)),
    )


def _estimate_lambda_max(lvl: Level, smooth, dtype, iters: int = 12):
    """Power iteration for rho(M^-1 A_l) (M = arrow blocks): a 0-d tensor
    on the level's device."""
    x = _seed_ptau(lvl, dtype)
    x = _scale(x, 1.0 / torch.sqrt(_dot(x, x)))
    lam = torch.ones((), dtype=dtype, device=lvl.clw_s.device)
    for _ in range(iters):
        y = smooth(_pos_apply(lvl, x))
        lam = torch.sqrt(_dot(y, y))
        x = _scale(y, 1.0 / torch.clamp(lam, min=1e-30))
    return lam


def _chebyshev_smoother(lvl: Level, smooth, lam_max, degree: int):
    """Fixed-degree Chebyshev acceleration of the arrow smoother on the
    interval [lam_max/4, 1.1 lam_max], the standard AMG smoothing window
    (it damps everything above a quarter of the top of the spectrum, which
    the coarse grid cannot see).  A fixed polynomial in M^-1 A_l applied
    symmetrically pre and post keeps the V-cycle SPD.  The coefficients
    are 0-d tensors from ``lam_max``."""
    b = 1.1 * lam_max
    a = lam_max / 4.0
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma = theta / delta
    coeffs = []  # (rho * rho_old, 2 rho / delta) of each step after the first
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        coeffs.append((rho * rho_old, 2.0 * rho / delta))
        rho_old = rho

    def apply_smooth(r: PTau) -> PTau:
        z = _scale(smooth(r), 1.0 / theta)
        d = z
        for c_d, c_s in coeffs:
            resid = r - _pos_apply(lvl, z)
            d = _scale(d, c_d) + _scale(smooth(resid), c_s)
            z = z + d
        return z

    return apply_smooth


def make_multigrid(grid, cls, asm, params: SolverParams):
    """Symmetric V-cycle with Chebyshev(arrow) smoothing as a fixed SPD
    preconditioner: z ~ (-A)^-1 r on PTau values.

    Plain damped block-Jacobi smoothing diverges here: the arrow blocks
    drop the cell-cell and (p, tc)-te couplings, so rho(M^-1 A) ~ 5-6 and
    any damping either amplifies (omega large) or barely smooths (omega
    small).  Chebyshev over [rho/4, 1.1 rho] (rho from a setup-time power
    iteration per level) handles the wide block spectrum."""
    dtype = params.dtype
    fine = Level(res=grid.res, dt=asm.dt, clw_s=asm.clw_s, elw_s=asm.elw_s, ffw=asm.ffw, mc_inv=asm.mc_inv,
                 uinv_c=asm.uinv_c, uinv_e=asm.uinv_e)
    levels = [fine]
    while min(levels[-1].res) > params.mg_coarsest and len(levels) < params.mg_levels:
        levels.append(_coarsen_level(levels[-1]))

    q_faces = None
    if params.do_reduced_regions:
        from .precond import _diag_quadratic_form

        q_faces = [_diag_quadratic_form(grid, cls, asm, params, a) for a in range(3)]
    arrows = [_level_arrow(levels[0], q_faces)] + [_level_arrow(lvl) for lvl in levels[1:]]
    smoothers = []
    for lvl, arrow in zip(levels, arrows):
        lam = _estimate_lambda_max(lvl, arrow, dtype)
        smoothers.append(_chebyshev_smoother(lvl, arrow, lam, params.mg_smooth_degree))

    def vcycle(ell: int, r: PTau) -> PTau:
        lvl = levels[ell]
        smooth = smoothers[ell]
        if ell == len(levels) - 1:
            # coarsest: a few extra Chebyshev sweeps stand in for a solve
            z = smooth(r)
            for _ in range(params.mg_coarse_iters - 1):
                z = z + smooth(r - _pos_apply(lvl, z))
            return z
        z = smooth(r)  # pre-smooth from zero
        rc = _restrict_ptau(r - _pos_apply(lvl, z), levels[ell + 1])
        z = z + _prolong_ptau(vcycle(ell + 1, rc), lvl)
        z = z + smooth(r - _pos_apply(lvl, z))  # post-smooth
        return z

    def solve(r: PTau) -> PTau:
        return vcycle(0, r)

    return solve
