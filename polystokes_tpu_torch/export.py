"""Operator / stats export and warm-start IO, the counterpart of
``polystokes_tpu.export``.

Parity with the reference's offline-verification tooling
(exportMatrices / exportComponentMatrices / exportStats / readInWarmStart,
exec/HDK_PolyStokesSolver.cpp:533-642): every component block can be
materialized as a scipy sparse matrix (host-side, vectorized — no loops)
and written as MatrixMarket ``.mtx`` or bundled ``.npz``.  The explicit
matrices are derived from the same coefficient fields the matrix-free
apply uses, so the export *is* the operator being solved.

The assembled state stays on its device (the card); ``_host`` brings each
field to the host, where the sparse algebra runs in numpy and scipy, as in
the JAX package.  The reduced faces' basis rows are computed on the
state's device and brought over once per axis.

DOF ordering (the JAX package's, so either package reads the other's
files): lexicographic per family; velocities stacked [vx|vy|vz]
(faceVelocityDOF), stresses stacked [txx|tyy|tzz|tyz|txz|txy] (stressDOF);
reduced DOFs are D consecutive rows per region.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch

from .basis import conversion_coefficients
from .classify import BOUNDARY, REDUCED, Classification, is_active
from .config import MINWEIGHT, SolverParams
from .grid import Grid, face_offsets
from .operators import PTau, coeff_fields
from .reduced import gather_com


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _number(mask: np.ndarray):
    idx = np.cumsum(mask.ravel()).reshape(mask.shape) - 1
    return np.where(mask, idx, -1), int(mask.sum())


class ExplicitOperators:
    """Host-side explicit sparse blocks built from an Assembled state.

    `weights`/`viscosity` (optional) are the raw (liquid_w, fluid_w) dicts
    and center viscosity — needed only for the reduced-stress diagonals
    uRed/uInvRed (the Assembled diagonals are active-masked, but the
    reference sums the *reduced* samples' values per region,
    ConstructMatrixBlocks.cpp:713-726, 824-867)."""

    def __init__(self, grid: Grid, cls: Classification, asm, params: SolverParams, weights=None, viscosity=None):
        self.weights = weights
        self.viscosity = viscosity
        self.grid = grid
        self.params = params
        self.D = params.reduced_dof
        cell_act = _host(is_active(cls.cell_labels))
        self.cell_idx, self.nP = _number(cell_act)
        self.face_idx, self.nF = [], []
        for a in range(3):
            ix, n = _number(_host(is_active(cls.face_labels[a])))
            self.face_idx.append(ix)
            self.nF.append(n)
        self.edge_idx, self.nE = [], []
        for e in range(3):
            ix, n = _number(_host(is_active(cls.edge_labels[e])))
            self.edge_idx.append(ix)
            self.nE.append(n)
        self.nV = sum(self.nF)
        self.nS = 3 * self.nP + sum(self.nE)
        self.R = int(asm.binv.shape[0])
        self.nW = self.R * self.D
        self.cls = cls
        self.asm = asm
        self._basis = {}

    # family offsets in the stacked layouts
    def _voff(self, a):
        return sum(self.nF[:a])

    def _soff_center(self, axis):
        return axis * self.nP

    def _soff_edge(self, e):
        return 3 * self.nP + sum(self.nE[:e])

    # ------------------------------------------------------------------
    def _cell_view(self, a, d):
        """Face-shaped cell index view on side d (0 lower, 1 upper)."""
        idx = np.pad(self.cell_idx, [(1, 1) if i == a else (0, 0) for i in range(3)], constant_values=-1)
        n = self.grid.res[a]
        sl = [slice(None)] * 3
        sl[a] = slice(d, d + n + 1)
        return idx[tuple(sl)]

    def _edge_view(self, a, e, d):
        t = 3 - a - e
        idx = self.edge_idx[e]
        n_t = idx.shape[t] - 1
        sl = [slice(None)] * 3
        sl[t] = slice(d, d + n_t)
        return idx[tuple(sl)]

    def G(self):
        return self._grad_like(stress=False, reduced=False)

    def JG(self):
        return self._grad_like(stress=False, reduced=True)

    def Dt(self):
        rows, cols, vals = [], [], []
        for r, c, v in (self._grad_like(stress=True, reduced=False, parts=True), self._edge_div(reduced=False, parts=True)):
            rows.append(r)
            cols.append(c)
            vals.append(v)
        return sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(self.nV, self.nS)).tocsr()

    def JDt(self):
        rows, cols, vals = [], [], []
        for r, c, v in (self._grad_like(stress=True, reduced=True, parts=True), self._edge_div(reduced=True, parts=True)):
            rows.append(r)
            cols.append(c)
            vals.append(v)
        return sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(self.nW, self.nS)).tocsr()

    def _reduced_faces(self, a):
        return _host(self.cls.face_labels[a]) == REDUCED

    def _face_basis(self, a):
        """Basis rows [n, D] of axis a's REDUCED faces, in the row-major
        order of ``_reduced_faces(a)`` (so ``C[ok[red]]`` is the JAX
        package's ``C[ok]`` for any ``ok`` within them), computed on the
        state's device at offsets from the faces' region COM, once."""
        if a not in self._basis:
            red = self.cls.face_labels[a] == REDUCED
            com = self.asm.com
            pos = red.nonzero().to(com.dtype) + torch.tensor(face_offsets(a), dtype=com.dtype, device=com.device)
            com_at = gather_com(com, self.cls.face_region[a][red])
            self._basis[a] = _host(conversion_coefficients(pos - com_at, a, self.params.basis))
        return self._basis[a]

    def _grad_like(self, stress: bool, reduced: bool, parts: bool = False):
        """G / JG and the center-stress part of Dt / JDt."""
        rows, cols, vals = [], [], []
        for a in range(3):
            c_lo_t, c_hi_t, _erow = coeff_fields(self.asm, a)
            c_lo, c_hi = _host(c_lo_t), _host(c_hi_t)
            if reduced:
                sel_face = self._reduced_faces(a)
                reg = _host(self.cls.face_region[a])
                C = self._face_basis(a)
            else:
                sel_face = _host(is_active(self.cls.face_labels[a]))
            for d, cf, sign in ((0, c_lo, -1.0), (1, c_hi, 1.0)):
                cv = self._cell_view(a, d)
                col = cv if not stress else np.where(cv >= 0, cv + self._soff_center(a), -1)
                ok = sel_face & (col >= 0) & (cf != 0)
                s = sign if not stress else -sign
                if not reduced:
                    rows.append(self.face_idx[a][ok] + self._voff(a))
                    cols.append(col[ok])
                    vals.append(s * cf[ok])
                else:
                    base = (reg[ok] * self.D)[:, None] + np.arange(self.D)[None, :]
                    rows.append(base.ravel())
                    cols.append(np.repeat(col[ok], self.D))
                    vals.append((s * cf[ok][:, None] * C[ok[sel_face]]).ravel())
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        vals = np.concatenate(vals)
        if parts:
            return rows, cols, vals
        nrow = self.nW if reduced else self.nV
        ncol = self.nP if not stress else self.nS
        return sp.coo_matrix((vals, (rows, cols)), shape=(nrow, ncol)).tocsr()

    def _edge_div(self, reduced: bool, parts: bool = False):
        rows, cols, vals = [], [], []
        for a in range(3):
            _clo, _chi, erow = coeff_fields(self.asm, a)
            if reduced:
                sel_face = self._reduced_faces(a)
                reg = _host(self.cls.face_region[a])
                C = self._face_basis(a)
            else:
                sel_face = _host(is_active(self.cls.face_labels[a]))
            for e in range(3):
                if e == a:
                    continue
                elo, ehi = erow[e]
                for d, cf, sign in ((0, _host(elo), 1.0), (1, _host(ehi), -1.0)):
                    ev = self._edge_view(a, e, d)
                    col = np.where(ev >= 0, ev + self._soff_edge(e), -1)
                    ok = sel_face & (col >= 0) & (cf != 0)
                    if not reduced:
                        rows.append(self.face_idx[a][ok] + self._voff(a))
                        cols.append(col[ok])
                        vals.append(sign * cf[ok])
                    else:
                        base = (reg[ok] * self.D)[:, None] + np.arange(self.D)[None, :]
                        rows.append(base.ravel())
                        cols.append(np.repeat(col[ok], self.D))
                        vals.append((sign * cf[ok][:, None] * C[ok[sel_face]]).ravel())
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        vals = np.concatenate(vals)
        if parts:
            return rows, cols, vals
        nrow = self.nW if reduced else self.nV
        return sp.coo_matrix((vals, (rows, cols)), shape=(nrow, self.nS)).tocsr()

    def _faces(self, fields):
        """Three face fields -> the stacked active-velocity vector."""
        return np.concatenate([_host(fields[a])[self.face_idx[a] >= 0] for a in range(3)])

    def _stresses(self, tc, te):
        """Center and edge stress fields -> the stacked stress vector."""
        return np.concatenate([_host(tc[a])[self.cell_idx >= 0] for a in range(3)]
                              + [_host(te[e])[self.edge_idx[e] >= 0] for e in range(3)])

    def Mc(self):
        return sp.diags(self._faces(self.asm.mc))

    def McInv(self):
        return sp.diags(self._faces(self.asm.mc_inv))

    def uInv(self):
        return sp.diags(self._stresses((self.asm.uinv_c,) * 3, self.asm.uinv_e))

    def u(self):
        return sp.diags(self._stresses((self.asm.u_c,) * 3, self.asm.u_e))

    def Mr(self):
        return sp.block_diag(list(_host(self.asm.mr))) if self.R else sp.csr_matrix((0, 0))

    def BInv(self):
        return sp.block_diag(list(_host(self.asm.binv))) if self.R else sp.csr_matrix((0, 0))

    # ------------------------------------------------------------------
    # Reduced ("internal") stress blocks for the
    # ALL_DOFS_EXPLICIT_INTERIOR_STRESS scheme: 6 aggregate stress DOFs
    # per region, layout [XX | YY | ZZ | YZ | XZ | XY] x R
    # (reducedStressDOF, HDK_PolyStokesSolver.h:607-624;
    #  nReducedStresses = 6 * regions, ConstructMatrixBlocks.cpp:20).
    # ------------------------------------------------------------------

    def _reduced_stress_diags(self):
        """(uRed_diag, uInvRed_diag) as [6R] vectors: the reference pushes
        one triplet per reduced cell (types XX/YY/ZZ) and per reduced-or-
        boundary edge (YZ/XZ/XY) onto the region's aggregate diagonal;
        setFromTriplets sums duplicates (ConstructMatrixBlocks.cpp:713-726,
        824-867)."""
        if self.weights is None or self.viscosity is None:
            raise ValueError("reduced stress blocks need ExplicitOperators(weights=(liquid_w, fluid_w), viscosity=...)")
        from .solver import edge_viscosity

        liquid_w, fluid_w = self.weights
        visc_c = _host(self.viscosity).astype(float)
        u_d = np.zeros(6 * self.R)
        uinv_d = np.zeros(6 * self.R)

        def seg_add(out, off, vals, regions, selm):
            np.add.at(out, off + regions[selm], vals[selm])

        # centers: vw = clamp(fw, MINWEIGHT, 1) * lw; uInv = invVisc*clamp(vw,1e-2,1);
        # u = visc*clamp(1/vw, 0, 1e2)
        vw_c = np.clip(_host(fluid_w["center"]).astype(float), MINWEIGHT, 1.0) * _host(liquid_w["center"]).astype(float)
        inv_visc = np.clip(1.0 / visc_c, 0.0, 1e10)
        uinv_c = inv_visc * np.clip(vw_c, 1e-2, 1.0)
        with np.errstate(divide="ignore"):
            u_c = visc_c * np.clip(np.where(vw_c > 0, 1.0 / np.maximum(vw_c, 1e-30), 1e2), 0.0, 1e2)
        cell_red = _host(self.cls.cell_labels) == REDUCED
        creg = _host(self.cls.cell_region)
        for a in range(3):
            seg_add(u_d, a * self.R, u_c, creg, cell_red & (creg >= 0))
            seg_add(uinv_d, a * self.R, uinv_c, creg, cell_red & (creg >= 0))
        # edges (label REDUCED or BOUNDARY both count as reduced,
        # HDK_PolyStokesSolver.h:708-716); the edge viscosity in float64 on
        # the host, as the JAX package's with x64
        for e in range(3):
            visc_e = edge_viscosity(torch.from_numpy(visc_c), e).numpy()
            vw = np.clip(_host(fluid_w[f"edge{e}"]).astype(float), MINWEIGHT, 1.0) * _host(liquid_w[f"edge{e}"]).astype(float)
            inv_ve = np.clip(1.0 / visc_e, 0.0, 1e10)
            uinv_e = 2.0 * inv_ve * vw
            u_e = 0.5 * visc_e * np.clip(np.where(vw > 0, 1.0 / np.maximum(vw, 1e-30), 1e2), 0.0, 1e2)
            el = _host(self.cls.edge_labels[e])
            ereg = _host(self.cls.edge_region[e])
            selm = ((el == REDUCED) | (el == BOUNDARY)) & (ereg >= 0)
            seg_add(u_d, (3 + e) * self.R, u_e, ereg, selm)
            seg_add(uinv_d, (3 + e) * self.R, uinv_e, ereg, selm)
        return u_d, uinv_d

    def uRed(self):
        return sp.diags(self._reduced_stress_diags()[0], shape=(6 * self.R, 6 * self.R))

    def uInvRed(self):
        return sp.diags(self._reduced_stress_diags()[1], shape=(6 * self.R, 6 * self.R))

    def JDtRed(self):
        """[R*D, 6R] internal-stress divergence: for each REDUCED face, the
        basis-weighted UNWEIGHTED stencil (+-1/dx, no liquid/fluid gating —
        ConstructMatrixBlocks.cpp:530-548 `contribution = -invDx *
        divergenceSign`) into the adjacent reduced cells' / edges'
        per-region aggregate stress DOFs."""
        inv_dx = 1.0 / self.grid.dx
        rows, cols, vals = [], [], []
        creg = _host(self.cls.cell_region)
        cell_red = _host(self.cls.cell_labels) == REDUCED
        for a in range(3):
            red = self._reduced_faces(a)
            freg = _host(self.cls.face_region[a])
            sel_face = red & (freg >= 0)
            C = self._face_basis(a)
            # cell targets (side d: 0 lower +1/dx, 1 upper -1/dx)
            red_pad = np.pad(cell_red & (creg >= 0), [(1, 1) if i == a else (0, 0) for i in range(3)])
            reg_pad = np.pad(creg, [(1, 1) if i == a else (0, 0) for i in range(3)], constant_values=-1)
            n = self.grid.res[a]
            for d, s in ((0, 1.0), (1, -1.0)):
                sl = [slice(None)] * 3
                sl[a] = slice(d, d + n + 1)
                cred = red_pad[tuple(sl)]
                creg_v = reg_pad[tuple(sl)]
                ok = sel_face & cred
                base = (freg[ok] * self.D)[:, None] + np.arange(self.D)[None, :]
                rows.append(base.ravel())
                cols.append(np.repeat(creg_v[ok] + a * self.R, self.D))
                vals.append((s * inv_dx * C[ok[red]]).ravel())
            # edge targets (side d: 0 -> +1/dx, 1 -> -1/dx, matching _edge_div)
            for e in range(3):
                if e == a:
                    continue
                el = _host(self.cls.edge_labels[e])
                ereg = _host(self.cls.edge_region[e])
                ered = ((el == REDUCED) | (el == BOUNDARY)) & (ereg >= 0)
                for d, s in ((0, 1.0), (1, -1.0)):
                    ev_red = self._edge_slice(ered, a, e, d)
                    ev_reg = self._edge_slice(ereg, a, e, d)
                    ok = sel_face & ev_red
                    base = (freg[ok] * self.D)[:, None] + np.arange(self.D)[None, :]
                    rows.append(base.ravel())
                    cols.append(np.repeat(ev_reg[ok] + (3 + e) * self.R, self.D))
                    vals.append((s * inv_dx * C[ok[red]]).ravel())
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.nW, 6 * self.R),
        ).tocsr()

    def _edge_slice(self, arr, a, e, d):
        t = 3 - a - e
        n_t = arr.shape[t] - 1
        sl = [slice(None)] * 3
        sl[t] = slice(d, d + n_t)
        return arr[tuple(sl)]

    def _valid_blocks(self, blocks):
        """[R, D, D] host blocks with identity in invalid region slots."""
        valid = _host(self.asm.region_valid)
        return np.where(valid[:, None, None], blocks, np.eye(self.D))

    def kkt_explicit_interior_stress_matrix(self):
        """ALL_DOFS_EXPLICIT_INTERIOR_STRESS system over
        [v_active | v_reduced | p | tau_active | tau_red(6R)]
        (assembleSystemExplicitInternalStresses, AssembleSystem.cpp:199-281):

          [ Mc/dt   0     G    Dt      0      ]
          [ 0       Mr    JG   JDt     JDtRed ]
          [ G^T     JG^T  0    0       0      ]
          [ Dt^T    JDt^T 0   -uInv/2  0      ]
          [ 0    JDtRed^T 0    0      -uRed/2 ]

        NOTE (literal parity): the reference stamps Mr with factor 1.0 —
        NOT invDt like the other schemes (AssembleSystem.cpp:235 vs :75) —
        and the reduced-stress diagonal uses uRed (not uInvRed)
        (AssembleSystem.cpp:248); both reproduced as-is.  Invalid region
        slots get identity Mr blocks / unit reduced-stress diagonals to
        keep the system nonsingular."""
        G, Dt, JG, JDt = self.G(), self.Dt(), self.JG(), self.JDt()
        JDtRed = self.JDtRed()
        u_d, _ = self._reduced_stress_diags()
        valid = _host(self.asm.region_valid)
        u_d = np.where(np.tile(valid, 6), np.where(u_d == 0, 1.0, u_d), 1.0)
        mr = self._valid_blocks(_host(self.asm.mr))
        Mr = sp.block_diag(list(mr)) if self.R else sp.csr_matrix((0, 0))
        Mc = self.Mc() / float(self.asm.dt)
        nR6 = 6 * self.R
        rows = [
            sp.hstack([Mc, sp.csr_matrix((self.nV, self.nW)), G, Dt, sp.csr_matrix((self.nV, nR6))]),
            sp.hstack([sp.csr_matrix((self.nW, self.nV)), Mr, JG, JDt, JDtRed]),
            sp.hstack([G.T, JG.T, sp.csr_matrix((self.nP, self.nP + self.nS + nR6))]),
            sp.hstack([Dt.T, JDt.T, sp.csr_matrix((self.nS, self.nP)), -0.5 * self.uInv(), sp.csr_matrix((self.nS, nR6))]),
            sp.hstack([sp.csr_matrix((nR6, self.nV)), JDtRed.T, sp.csr_matrix((nR6, self.nP + self.nS)), -0.5 * sp.diags(u_d)]),
        ]
        return sp.vstack(rows).tocsr()

    def kkt_explicit_interior_stress_rhs(self):
        """b for the explicit-interior-stress layout: the reduced-stress
        rows have zero RHS (AssembleSystem.cpp:254-264)."""
        return np.concatenate([self.kkt_rhs(), np.zeros(6 * self.R)])

    def vectors(self) -> Dict[str, np.ndarray]:
        rhs = self.asm.rhs_solid
        return dict(
            activeRHS=self._faces(self.asm.b_v),
            oldActiveVs=self._faces(self.asm.old_v),
            pressureRHS=_host(rhs.p)[self.cell_idx >= 0],
            stressRHS=self._stresses(rhs.tc, rhs.te),
            reducedRHS=_host(self.asm.b_w).ravel(),
        )

    def schur_matrix(self):
        """The explicit pressure-stress system (assembleSystemPressureStress,
        AssembleSystem.cpp:351-430)."""
        G, Dt, JG, JDt = self.G(), self.Dt(), self.JG(), self.JDt()
        McInv = self.McInv()
        BInv = self.BInv()
        dt = float(self.asm.dt)
        GD = sp.hstack([G, Dt]).tocsr()
        A = -dt * (GD.T @ McInv @ GD)
        if self.R:
            JGD = sp.hstack([JG, JDt]).tocsr()
            A = A - JGD.T @ BInv @ JGD
        zero_p = sp.diags(np.zeros(self.nP))
        A = A - 0.5 * sp.block_diag([zero_p, self.uInv()])
        return A.tocsr()

    def schur_operator(self):
        """``schur_matrix`` in factored form, a scipy LinearOperator that
        applies the exported blocks in turn:

            A x = -dt [G Dt]^T McInv [G Dt] x - [JG JDt]^T BInv [JG JDt] x
                  - 0.5 [0 | uInv] x.

        The product form holds no fill: ``schur_matrix`` stores each
        region's block [JG JDt]^T BInv [JG JDt] densely over every DOF next
        to the region's reduced faces, which outgrows the host's memory on
        the untiled tile-16 configuration from 64^3 on."""
        import scipy.sparse.linalg as spla

        GD = sp.hstack([self.G(), self.Dt()]).tocsr()
        GDt = GD.T.tocsr()
        mc_inv = self.McInv().diagonal()
        diag = -0.5 * np.concatenate([np.zeros(self.nP), self.uInv().diagonal()])
        dt = float(self.asm.dt)
        if self.R:
            JGD = sp.hstack([self.JG(), self.JDt()]).tocsr()
            JGDt, BInv = JGD.T.tocsr(), self.BInv().tocsr()

        def matvec(x):
            x = np.ravel(x)
            y = -dt * (GDt @ (mc_inv * (GD @ x))) + diag * x
            if self.R:
                y = y - JGDt @ (BInv @ (JGD @ x))
            return y

        n = self.nP + self.nS
        return spla.LinearOperator((n, n), matvec=matvec, rmatvec=matvec, dtype=np.result_type(GD.dtype, np.float64))

    def B(self):
        """Mr/dt + 2 Vr per region as block-diagonal sparse
        (assembleReducedCombinedBlock, AssembleBlocks.cpp:148-193).
        Invalid region slots get identity blocks so the KKT system stays
        nonsingular (their coefficients decouple to zero)."""
        out = self._valid_blocks(_host(self.asm.mr) / float(self.asm.dt) + 2.0 * _host(self.asm.vr))
        return sp.block_diag(list(out)) if self.R else sp.csr_matrix((0, 0))

    def kkt_matrix(self):
        """The full symmetric indefinite KKT system over
        [v_active | v_reduced | p | tau]  (assembleSystem,
        AssembleSystem.cpp:39-115):

          [ Mc/dt        0      G    Dt   ]
          [ 0      Mr/dt+2V     JG   JDt  ]
          [ G^T        JG^T     0    0    ]
          [ Dt^T       JDt^T    0  -uInv/2]
        """
        G, Dt, JG, JDt = self.G(), self.Dt(), self.JG(), self.JDt()
        Mc = self.Mc() / float(self.asm.dt)
        Bblk = self.B()
        rows = [
            sp.hstack([Mc, sp.csr_matrix((self.nV, self.nW)), G, Dt]),
            sp.hstack([sp.csr_matrix((self.nW, self.nV)), Bblk, JG, JDt]),
            sp.hstack([G.T, JG.T, sp.csr_matrix((self.nP, self.nP + self.nS))]),
            sp.hstack([Dt.T, JDt.T, sp.csr_matrix((self.nS, self.nP)), -0.5 * self.uInv()]),
        ]
        return sp.vstack(rows).tocsr()

    def kkt_rhs(self):
        """b for the KKT layout: [b_v/dt | b_w/dt | rhs_p | rhs_s]."""
        dt = float(self.asm.dt)
        v = self.vectors()
        return np.concatenate([
            v["activeRHS"] / dt,
            v["reducedRHS"] / dt,
            v["pressureRHS"],
            v["stressRHS"],
        ])

    def pressure_velocity_matrix(self):
        """The velocity-pressure system with stress eliminated
        (assembleSystemVelocityPressure, AssembleSystem.cpp:281-349):

          [ Mc/dt - V      -VJ^T            G  ]
          [ -JV^T     Mr/dt+2Vint - JVJ^T   JG ]
          [ G^T             JG^T            0  ]

        with V = Dt (-2u) Dt^T etc. (assembleVMatrices,
        AssembleBlocks.cpp:370-375)."""
        G, Dt, JG, JDt = self.G(), self.Dt(), self.JG(), self.JDt()
        u2 = -2.0 * self.u()
        V = (Dt @ u2 @ Dt.T).tocsr()
        VJt = (Dt @ u2 @ JDt.T).tocsr()
        JVJt = (JDt @ u2 @ JDt.T).tocsr()
        Mc = self.Mc() / float(self.asm.dt)
        Bblk = self.B()
        rows = [
            sp.hstack([Mc - V, -VJt, G]),
            sp.hstack([-VJt.T, Bblk - JVJt, JG]),
            sp.hstack([G.T, JG.T, sp.csr_matrix((self.nP, self.nP))]),
        ]
        return sp.vstack(rows).tocsr()

    def guess_vectors(self):
        """Warm-start guesses (constructGuessVectors, Solver.cpp:521-531):
        v from the old grid velocities, w from the best fit,
        p = -G^T v - JG^T w, tau = -2 uInv (-Dt^T v - JDt^T w)."""
        v = self.vectors()["oldActiveVs"]
        w = _host(self.asm.best_fit).ravel()
        G, Dt, JG, JDt = self.G(), self.Dt(), self.JG(), self.JDt()
        p = -(G.T @ v) - (JG.T @ w)
        uInv = self.uInv()
        tau = -2.0 * (uInv @ (-(Dt.T @ v) - (JDt.T @ w)))
        return v, w, p, tau


def solve_explicit(grid: Grid, cls: Classification, asm, params: SolverParams, scheme: str = "pressure_stress",
                   tol: float = None, maxiter: int = None, warm_start: bool = True, weights=None, viscosity=None,
                   preconditioner: str = None, method: str = "auto", callback=None, x0=None):
    """Host-side explicit solve — the analog of the reference's EIGEN
    SolverType (solveEigenCG, Solver.cpp:814-862): assemble the chosen
    scheme's sparse system and run scipy CG with the warm-start guess.

    `preconditioner` (None | 'gs_smoother' | 'eq14') applies the ports of
    the reference's disabled explicit preconditioners (precond_host.py);
    both target the [u | w | p] pressure_velocity layout.

    `callback(xk)` is forwarded to the scipy iterative solver (iteration
    counting — the reference prints its iteration count, Solver.cpp:608-619).
    `x0` overrides the initial guess with an explicit packed vector for the
    chosen scheme (readInWarmStart parity, Solver.cpp:621-642; see
    load_solution_guess).  Returns (x, ops, info) with x on the host."""
    import scipy.sparse.linalg as spla

    ops = ExplicitOperators(grid, cls, asm, params, weights=weights, viscosity=viscosity)
    tol = params.tolerance if tol is None else tol
    maxiter = params.max_iterations if maxiter is None else maxiter
    explicit_x0 = x0
    vg, wg, pg, tg = ops.guess_vectors() if warm_start else (None,) * 4

    M = None
    if preconditioner is not None:
        from . import precond_host

        if scheme != "pressure_velocity":
            raise ValueError("gs_smoother/eq14 precondition the [u|w|p] pressure_velocity layout")
        if preconditioner == "gs_smoother":
            M = precond_host.build_gs_smoother(ops).as_linear_operator()
        elif preconditioner == "eq14":
            M = precond_host.build_eq14(ops).as_linear_operator()
        else:
            raise ValueError(preconditioner)

    dt = float(asm.dt)
    if scheme == "pressure_stress":
        A = ops.schur_matrix()
        v = ops.vectors()
        McInv = ops.McInv()
        G, Dt, JG, JDt = ops.G(), ops.Dt(), ops.JG(), ops.JDt()
        BInv = ops.BInv()
        z = BInv @ v["reducedRHS"] / dt if ops.R else np.zeros(0)
        b1 = -(G.T @ (McInv @ v["activeRHS"])) + v["pressureRHS"]
        b2 = -(Dt.T @ (McInv @ v["activeRHS"])) + v["stressRHS"]
        if ops.R:
            b1 = b1 - JG.T @ z
            b2 = b2 - JDt.T @ z
        b = np.concatenate([b1, b2])
        x0 = np.concatenate([pg, tg]) if warm_start else None
    elif scheme == "all_dofs":
        A = ops.kkt_matrix()
        b = ops.kkt_rhs()
        x0 = np.concatenate([vg, wg, pg, tg]) if warm_start else None
    elif scheme == "pressure_velocity":
        A = ops.pressure_velocity_matrix()
        v = ops.vectors()
        b = np.concatenate([v["activeRHS"] / dt, v["reducedRHS"] / dt, np.zeros(ops.nP)])
        x0 = np.concatenate([vg, wg, pg]) if warm_start else None
    elif scheme == "all_dofs_explicit_interior_stress":
        A = ops.kkt_explicit_interior_stress_matrix()
        b = ops.kkt_explicit_interior_stress_rhs()
        x0 = np.concatenate([vg, wg, pg, tg, np.zeros(6 * ops.R)]) if warm_start else None
    else:
        raise ValueError(scheme)

    if method == "auto":
        # CG is only sound for the (negative-)definite pressure-stress Schur
        # system; the KKT / velocity-pressure layouts are symmetric
        # indefinite -> MINRES.  (The reference runs Eigen CG on all of
        # them, Solver.cpp:814-862 — which relies on luck for indefinite
        # layouts.)  A requested preconditioner forces the one solver that
        # admits an indefinite M (gmres) instead of silently dropping it.
        if M is not None:
            method = "gmres"
        else:
            method = "cg" if scheme == "pressure_stress" else "minres"
    elif M is not None and method not in ("gmres", "cg"):
        raise ValueError(f"method {method!r} cannot apply a preconditioner; use 'gmres' (or 'auto')")
    if explicit_x0 is not None:
        x0 = np.asarray(explicit_x0, dtype=np.float64)
        if x0.shape != b.shape:
            raise ValueError(f"x0 shape {x0.shape} != system size {b.shape}")
    if method == "direct":
        x = spla.spsolve(A.tocsc(), b)
        info = 0
    elif method == "minres":
        x, info = spla.minres(A, b, x0=x0, rtol=tol, maxiter=maxiter, callback=callback)
    elif method == "gmres":
        # the only scipy solver that admits an indefinite preconditioner
        # (the GS-smoother / Eq-14 ports are saddle-structured)
        x, info = spla.gmres(A, b, x0=x0, rtol=tol, maxiter=maxiter, M=M, callback=callback, callback_type="pr_norm")
    else:
        x, info = spla.cg(A, b, x0=x0, rtol=tol, maxiter=maxiter, M=M, callback=callback)
        if info != 0:
            x, info = spla.minres(A, b, x0=x, rtol=tol, maxiter=maxiter, callback=callback)
    return x, ops, info


def export_component_matrices(prefix: str, ops: ExplicitOperators, fmt: str = "npz"):
    """exportComponentMatrices parity (Solver.cpp:543-566).  fmt 'npz'
    bundles everything; fmt 'mtx' writes MatrixMarket files."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    mats = dict(
        Mc=ops.Mc(), McInv=ops.McInv(), u=ops.u(), uInv=ops.uInv(),
        G=ops.G(), Dt=ops.Dt(), JG=ops.JG(), JDt=ops.JDt(),
        Mr=ops.Mr(), Inv_Mr_plus_2JDtuDJ=ops.BInv(),
    )
    vecs = ops.vectors()
    if fmt == "mtx":
        from scipy.io import mmwrite

        for name, m in mats.items():
            mmwrite(prefix + f"Mat_{name}.mtx", m)
        for name, v in vecs.items():
            mmwrite(prefix + f"Vec_{name}.mtx", v.reshape(-1, 1))
    else:
        payload = {}
        for name, m in mats.items():
            m = m.tocoo()
            payload[f"{name}_row"] = m.row
            payload[f"{name}_col"] = m.col
            payload[f"{name}_val"] = m.data
            payload[f"{name}_shape"] = np.asarray(m.shape)
        for name, v in vecs.items():
            payload[f"Vec_{name}"] = v
        np.savez_compressed(prefix + "components.npz", **payload)


def export_grids(prefix: str, cls: Classification, liquid_w=None, fluid_w=None):
    """Dump every label/region/weight grid to one npz — the analog of the
    reference's printAllData point-cloud dumps (Solver.cpp:1031-1268)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    payload = {"cell_labels": _host(cls.cell_labels), "cell_region": _host(cls.cell_region)}
    for a in range(3):
        payload[f"face{a}_labels"] = _host(cls.face_labels[a])
        payload[f"face{a}_region"] = _host(cls.face_region[a])
    for e in range(3):
        payload[f"edge{e}_labels"] = _host(cls.edge_labels[e])
        payload[f"edge{e}_region"] = _host(cls.edge_region[e])
    for name, w in (("liquid", liquid_w), ("fluid", fluid_w)):
        if w is not None:
            for k, v in w.items():
                payload[f"{name}_{k}"] = _host(v)
    np.savez_compressed(prefix + "grids.npz", **payload)


def extract_residuals(grid: Grid, cls: Classification, asm, x: PTau, b: PTau, params: SolverParams, R: int) -> PTau:
    """r = b - A x on the (p, tau) fields — the analog of
    extractResiduals (Solver.cpp:864-918), returned as grid fields on the
    state's device."""
    from .solver import make_apply

    return b - make_apply(grid, cls, asm, params, R)(x)


def export_stats(prefix: str, stats: dict, from_device: bool = True):
    """exportStats parity (Solver.cpp:574-606) as JSON, the file the JAX
    package writes for the same stats.  Its device step's stats are 0-d
    arrays, which it writes as floats, booleans included; the port's are
    Python scalars, so with ``from_device`` (a step's stats) every number
    becomes a float as there.  Without it (the host solve's stats, Python
    scalars in both packages) numbers are written as given; tensors and
    numpy scalars are floats either way."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    device_like = (bool, int, float) if from_device else ()

    def value(v):
        if hasattr(v, "item") or isinstance(v, device_like):
            return float(v)
        return v

    with open(prefix + "stats.json", "w") as f:
        json.dump({k: value(v) for k, v in stats.items()}, f, indent=2)


def dofs_from_ptau(x: PTau, ops: ExplicitOperators):
    """(pressure, stress) vectors in the export's DOF order from a PTau."""
    return _host(x.p)[ops.cell_idx >= 0], ops._stresses(x.tc, x.te)


def ptau_from_dofs(p: np.ndarray, s: np.ndarray, ops: ExplicitOperators, dtype, device) -> PTau:
    """The inverse of ``dofs_from_ptau``: a PTau of ``dtype`` on ``device``,
    zero off the active DOFs."""
    def field(mask, vals):
        arr = np.zeros(mask.shape, np.float64)
        arr[mask] = vals
        return torch.as_tensor(arr, dtype=dtype, device=device)

    cell_m = ops.cell_idx >= 0
    tc, te, off = [], [], 0
    for _ in range(3):
        tc.append(field(cell_m, s[off:off + ops.nP]))
        off += ops.nP
    for e in range(3):
        te.append(field(ops.edge_idx[e] >= 0, s[off:off + ops.nE[e]]))
        off += ops.nE[e]
    return PTau(p=field(cell_m, p), tc=tuple(tc), te=tuple(te))


def export_solution(prefix: str, x: PTau, ops: ExplicitOperators):
    p, s = dofs_from_ptau(x, ops)
    np.savez_compressed(prefix + "solution.npz", pressure=p, stress=s)


def load_solution(prefix: str):
    """readInWarmStart analog (Solver.cpp:621-642)."""
    d = np.load(prefix + "solution.npz")
    return d["pressure"], d["stress"]


def load_solution_guess(prefix: str, ops: ExplicitOperators):
    """Load an exported solution as the packed pressure-stress initial
    guess (readInWarmStart -> solveWithGuess parity, Solver.cpp:621-642 +
    814-862).  Pass the result as solve_explicit(..., x0=...)."""
    p, s = load_solution(prefix)
    if p.shape[0] != ops.nP or s.shape[0] != ops.nS:
        raise ValueError(
            f"solution sizes ({p.shape[0]}, {s.shape[0]}) do not match the "
            f"current system ({ops.nP}, {ops.nS})"
        )
    return np.concatenate([p, s])


def solution_guess_ptau(prefix: str, ops: ExplicitOperators, dtype, device=None) -> PTau:
    """Load an exported solution back onto the grid as a PTau initial
    guess for the device step (step(..., initial_guess=...)), on
    ``device`` (default: the assembled state's, i.e. the scene's)."""
    p, s = load_solution(prefix)
    return ptau_from_dofs(p, s, ops, dtype, ops.asm.dt.device if device is None else device)
