"""Matrix-free variational Stokes operators on the MAC grid
(``polystokes_tpu.operators``): gated coefficient fields, the mass and
stress diagonals, and the forward / transpose stencil passes.

Stencil rules (ConstructMatrixBlocks.cpp:393-640):
  * G[face, cell]          = sign * faceFluidW * centerLiquidW / dx
  * Dt[face, cellstress_a] = -sign * faceFluidW * centerLiquidW / dx
  * Dt[face, edgestress]   = -sign * faceFluidW * edgeLiquidW / dx
  * Mc[face] = clamp(faceFluidW * faceLiquidW, MINWEIGHT^2, 1) * rho
  * uInv: centers invVisc * clamp(vw, 1e-2, 1), edges 2 invVisc vw,
    vw = clamp(fw, MINWEIGHT, 1) * lw
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .classify import Classification, is_active
from .config import MINWEIGHT, SolverParams
from .grid import Grid, pad_axis


# ---------------------------------------------------------------------------
# Shape-conversion views between families
# ---------------------------------------------------------------------------

def cell_at_face(cell_arr, axis, direction, fill=0.0):
    """Face-shaped view of a cell array: the cell on side ``direction``
    (0 = lower, at face index - 1; 1 = upper, at face index)."""
    n = cell_arr.shape[axis]
    return pad_axis(cell_arr, axis, 1, 1, fill).narrow(axis, direction, n + 1)


def face_at_cell(face_arr, axis, direction):
    """Cell-shaped view of a face array: the cell's lower (0) or upper (1) face."""
    return face_arr.narrow(axis, direction, face_arr.shape[axis] - 1)


def edge_at_face(edge_arr, face_axis, edge_axis, direction):
    """Face-shaped view of an edge array: edge = face + direction * e_t."""
    t = 3 - face_axis - edge_axis
    return edge_arr.narrow(t, direction, edge_arr.shape[t] - 1)


def scatter_face_to_edge(face_vals, face_axis, edge_axis, direction):
    """Edge-shaped accumulation view: value from face = edge - direction*e_t."""
    t = 3 - face_axis - edge_axis
    return pad_axis(face_vals, t, 1 if direction == 1 else 0, 0 if direction == 1 else 1, 0.0)


# ---------------------------------------------------------------------------
# Assembled operator state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PTau:
    """A (pressure, stress) vector, the solve variable."""

    p: torch.Tensor
    tc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # tau_xx/yy/zz
    te: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # tau_yz/xz/xy

    def __add__(self, o):
        return PTau(self.p + o.p, tuple(a + b for a, b in zip(self.tc, o.tc)), tuple(a + b for a, b in zip(self.te, o.te)))

    def __sub__(self, o):
        return PTau(self.p - o.p, tuple(a - b for a, b in zip(self.tc, o.tc)), tuple(a - b for a, b in zip(self.te, o.te)))

    def fields(self) -> tuple:
        """(p, tau_xx, tau_yy, tau_zz, tau_yz, tau_xz, tau_xy): the JAX
        package's pytree leaf order."""
        return (self.p,) + tuple(self.tc) + tuple(self.te)


def ravel_ptau(x: PTau) -> torch.Tensor:
    """PTau -> one flat vector: the seven fields in ``PTau.fields`` order,
    each whole (the edges at their own shapes, the index-0 planes kept), so
    the Krylov loop runs the unpacked path on one tensor as it runs the
    packed one."""
    return torch.cat([t.reshape(-1) for t in x.fields()])


def unravel_ptau(flat: torch.Tensor, grid: Grid) -> PTau:
    """The inverse of ``ravel_ptau`` on ``grid``'s shapes: views of ``flat``."""
    shapes = [grid.center_shape] * 4 + [grid.edge_shape(e) for e in range(3)]
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    parts = [t.view(s) for t, s in zip(torch.split(flat, sizes), shapes)]
    return PTau(p=parts[0], tc=tuple(parts[1:4]), te=tuple(parts[4:7]))


@dataclasses.dataclass(frozen=True)
class Assembled:
    """Everything the matrix-free apply needs; built once per step.

    Cell coefficient at face f, side d = ffw[a][f] * clw_s[cell_d(f)];
    edge coefficient = ffw[a][f] * elw_s[e][edge_d(f)]."""

    dt: torch.Tensor
    inv_dx: torch.Tensor
    clw_s: torch.Tensor
    elw_s: Tuple[torch.Tensor, ...]
    ffw: Tuple[torch.Tensor, ...]
    mc: Tuple[torch.Tensor, ...]
    mc_inv: Tuple[torch.Tensor, ...]
    uinv_c: torch.Tensor
    u_c: torch.Tensor
    uinv_e: Tuple[torch.Tensor, ...]
    u_e: Tuple[torch.Tensor, ...]
    b_v: Tuple[torch.Tensor, ...]
    old_v: Tuple[torch.Tensor, ...]
    rhs_solid: PTau
    com: torch.Tensor  # [R, 3] cell units
    binv: torch.Tensor  # [R, D, D] inv(Mr/dt + 2 Vr)
    mr: torch.Tensor
    vr: torch.Tensor
    best_fit: torch.Tensor  # [R, D]
    b_w: torch.Tensor  # [R, D] = Mr @ best_fit
    region_valid: torch.Tensor
    face_region: Tuple[torch.Tensor, ...]


def build_gated_weights(grid: Grid, cls: Classification, liquid_w, fluid_w, params: SolverParams):
    """(clw_s, elw_s, ffw): the gated weight factor fields."""
    dtype = params.dtype
    inv_dx = 1.0 / grid.dx
    clw_s = torch.where(is_active(cls.cell_labels), liquid_w["center"], 0.0).to(dtype) * inv_dx
    elw_s = tuple(
        torch.where(is_active(cls.edge_labels[e]), liquid_w[f"edge{e}"], 0.0).to(dtype) * inv_dx
        for e in range(3)
    )
    ffw = tuple(fluid_w[f"face{a}"].to(dtype) for a in range(3))
    return clw_s, elw_s, ffw


def coeff_fields(asm: Assembled, a: int):
    """Per-face stencil coefficients of axis ``a``: (c_lo, c_hi, {e: (elo, ehi)})."""
    c_lo = asm.ffw[a] * cell_at_face(asm.clw_s, a, 0)
    c_hi = asm.ffw[a] * cell_at_face(asm.clw_s, a, 1)
    erow = {}
    for e in range(3):
        if e != a:
            erow[e] = (asm.ffw[a] * edge_at_face(asm.elw_s[e], a, e, 0), asm.ffw[a] * edge_at_face(asm.elw_s[e], a, e, 1))
    return c_lo, c_hi, erow


def build_diagonals(grid: Grid, cls: Classification, liquid_w, fluid_w, viscosity_c, viscosity_e, params: SolverParams):
    """Mass and stress diagonals (ConstructMatrixBlocks.cpp:361-391, 650-867)."""
    dtype = params.dtype
    rho = params.effective_density
    mc, mc_inv = [], []
    for a in range(3):
        vol = fluid_w[f"face{a}"].to(dtype) * liquid_w[f"face{a}"].to(dtype)
        vol = torch.clamp(vol, MINWEIGHT * MINWEIGHT, 1.0)
        m = is_active(cls.face_labels[a]).to(dtype)
        mc.append(vol * rho * m)
        mc_inv.append(m / (vol * rho))

    inv_visc_c = torch.clamp(1.0 / viscosity_c.to(dtype), 0.0, 1e10)
    vw_c = torch.clamp(fluid_w["center"].to(dtype), MINWEIGHT, 1.0) * liquid_w["center"].to(dtype)
    mctr = is_active(cls.cell_labels).to(dtype)
    uinv_c = inv_visc_c * torch.clamp(vw_c, 1e-2, 1.0) * mctr
    u_c = viscosity_c.to(dtype) * torch.clamp(torch.where(vw_c > 0, 1.0 / torch.clamp(vw_c, min=1e-30), 1e2), 0.0, 1e2) * mctr

    uinv_e, u_e = [], []
    for e in range(3):
        inv_visc = torch.clamp(1.0 / viscosity_e[e].to(dtype), 0.0, 1e10)
        vw = torch.clamp(fluid_w[f"edge{e}"].to(dtype), MINWEIGHT, 1.0) * liquid_w[f"edge{e}"].to(dtype)
        m = is_active(cls.edge_labels[e]).to(dtype)
        uinv_e.append(2.0 * inv_visc * vw * m)
        u_e.append(0.5 * viscosity_e[e].to(dtype) * torch.clamp(torch.where(vw > 0, 1.0 / torch.clamp(vw, min=1e-30), 1e2), 0.0, 1e2) * m)
    return tuple(mc), tuple(mc_inv), uinv_c, u_c, tuple(uinv_e), tuple(u_e)


# ---------------------------------------------------------------------------
# Forward stencil s = (G p + Dt tau)[face] and its transpose
# ---------------------------------------------------------------------------

def forward_face_values(asm: Assembled, x: PTau):
    """s[face] = (G p + Dt tau)[face] on every face."""
    g = [asm.clw_s * (x.p - x.tc[a]) for a in range(3)]
    h = [asm.elw_s[e] * x.te[e] for e in range(3)]
    s = []
    for a in range(3):
        v = cell_at_face(g[a], a, 1) - cell_at_face(g[a], a, 0)
        for e in range(3):
            if e != a:
                v = v + edge_at_face(h[e], a, e, 0) - edge_at_face(h[e], a, e, 1)
        s.append(asm.ffw[a] * v)
    return s


def transpose_from_faces(asm: Assembled, f) -> PTau:
    """[G Dt]^T applied to face values ``f``; the face weight ffw
    multiplies again at the face (G^T carries G's face weight)."""
    p_out = torch.zeros_like(asm.clw_s)
    tc_out = []
    te_acc = [torch.zeros_like(asm.elw_s[e]) for e in range(3)]
    for a in range(3):
        w = asm.ffw[a] * f[a]
        d = face_at_cell(w, a, 0) - face_at_cell(w, a, 1)
        p_out = p_out + d
        tc_out.append(-asm.clw_s * d)
        for e in range(3):
            if e != a:
                te_acc[e] = te_acc[e] + scatter_face_to_edge(w, a, e, 0) - scatter_face_to_edge(w, a, e, 1)
    return PTau(p=asm.clw_s * p_out, tc=tuple(tc_out), te=tuple(asm.elw_s[e] * te_acc[e] for e in range(3)))
