"""Host-side ports of the reference's explicit-matrix preconditioners, the
counterpart of ``polystokes_tpu.precond_host`` (pure scipy, as there).

The reference implements (but leaves disabled behind the hardcoded
identity, exec/HDK_PolyStokesSolver_Preconditioners.cpp:4-9) two
preconditioners for the explicit velocity-pressure layout
[u_active | w_reduced | p]:

  * block Gauss-Seidel smoother (Preconditioner.cpp:30-158,
    constructPreconditionerGSsmoother, Preconditioners.cpp:11-29):
    three half-steps alternating a 16-sweep Gauss-Seidel solve on the
    uniform-velocity block (1/dt Mc - V) with an exact reduced solve
    z_w = BInv ((1/dt) Mr r_w + VJt^T z_u - JG z_p).

  * "Eq 14" block-triangular approximate inverse (Preconditioner.cpp:
    202-269, constructPreconditionerEq14, Preconditioners.cpp:43-95):
    M3inv @ M2inv @ M1inv with
      M1inv = [[I, 0], [-A1 DtildeInv, I]]
      M2inv = blkdiag(DtildeInv, -inv(diag(A1 DtildeInv A1^T)))
      M3inv = M1inv^T
    where A1 = [G^T JG^T] and Dtilde = blkdiag(Mc, Mr)/dt.

These operate on the host explicit path (the analog of the reference's
EIGEN solver type), so they live here as scipy operators usable from
export.solve_explicit.

Deviations from the reference (both kept from the JAX package):

  * the reference's solveGSsmoother returns an *uninitialized* z_p
    (``Vector z_p(n_ps)`` is never assigned, Preconditioner.cpp:64/85) —
    dead-code bug.  We return z_p = r_p (identity on the pressure block)
    so the operator is deterministic and nonsingular.
  * the reference's gaussSeidelIteration (util.h:86-99) sums the
    off-diagonal matrix VALUES alone — it never multiplies them by the
    current iterate — so it is not Gauss-Seidel (or any contraction) at
    all; the result depends only on the sparsity pattern.  Our
    gauss_seidel_iteration implements true forward GS sweeps
    x <- (D+L)^{-1}(rhs - U x), which is what the surrounding smoother
    code (Preconditioner.cpp:87-99) clearly intends.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .export import _host


def gauss_seidel_iteration(mat: sp.csr_matrix, rhs: np.ndarray, x0: np.ndarray, iters: int) -> np.ndarray:
    """Forward Gauss-Seidel sweeps (util.h:73-103 gaussSeidelIteration):
    x <- (D + L)^{-1} (rhs - U x), `iters` times."""
    mat = mat.tocsr()
    lower = sp.tril(mat, k=0).tocsr()
    upper = sp.triu(mat, k=1).tocsr()
    # guard empty diagonals so the triangular solve is well-posed
    d = lower.diagonal()
    if np.any(d == 0):
        lower = (lower + sp.diags(np.where(d == 0, 1.0, 0.0))).tocsr()
    x = x0.copy()
    for _ in range(iters):
        x = spla.spsolve_triangular(lower, rhs - upper @ x, lower=True)
    return x


class GSSmootherPreconditioner:
    """Preconditioner.cpp:53-158 for the [u | w | p] layout."""

    def __init__(self, Mc, Mr, Binv, V, G, VJt, JG, dt, sweeps: int = 16):
        self.Mc, self.Mr, self.Binv = Mc.tocsr(), Mr.tocsr(), Binv.tocsr()
        self.V, self.G, self.VJt, self.JG = V.tocsr(), G.tocsr(), VJt.tocsr(), JG.tocsr()
        self.dt = float(dt)
        self.sweeps = sweeps
        self.n_u = Mc.shape[0]
        self.n_w = Mr.shape[0]
        self.n_p = G.shape[1]
        self._uniform_mat = ((1.0 / self.dt) * self.Mc - self.V).tocsr()

    def _step_uniform(self, r_u, z_w, z_p):
        rhs = (1.0 / self.dt) * (self.Mc @ r_u) + self.VJt @ z_w - self.G @ z_p
        return gauss_seidel_iteration(self._uniform_mat, rhs, r_u, self.sweeps)

    def _step_reduced(self, r_w, z_u, z_p):
        return self.Binv @ ((1.0 / self.dt) * (self.Mr @ r_w) + self.VJt.T @ z_u - self.JG @ z_p)

    def solve(self, b: np.ndarray) -> np.ndarray:
        r_u = b[: self.n_u]
        r_w = b[self.n_u : self.n_u + self.n_w]
        r_p = b[self.n_u + self.n_w :]
        z_w = np.zeros(self.n_w)
        z_p = np.zeros(self.n_p)
        z_u = self._step_uniform(r_u, z_w, z_p)  # step 1
        z_w = self._step_reduced(r_w, z_u, z_p)  # step 2
        z_u = self._step_uniform(r_u, z_w, z_p)  # step 3
        return np.concatenate([z_u, z_w, r_p])

    def as_linear_operator(self):
        n = self.n_u + self.n_w + self.n_p
        return spla.LinearOperator((n, n), matvec=self.solve)


class Eq14Preconditioner:
    """Preconditioner.cpp:202-269 setupEq14Inv/solveEq14 for [u | w | p]."""

    def __init__(self, A1: sp.spmatrix, Dtilde: sp.spmatrix, DtildeInv: sp.spmatrix):
        A1 = A1.tocsr()
        DtildeInv = DtildeInv.tocsr()
        n = A1.shape[1]
        m = A1.shape[0]
        self.n, self.m = n, m
        ADinv = (A1 @ DtildeInv).tocsr()
        ADinvAt = (ADinv @ A1.T).tocsr()
        diag = ADinvAt.diagonal()
        diag = np.where(diag == 0, 1.0, diag)  # fillEmptyDiagonalEntries
        self.ADinv = ADinv
        self.DtildeInv = DtildeInv
        self.diag_inv = 1.0 / diag

    def solve(self, b: np.ndarray) -> np.ndarray:
        # M1inv: [x; y - ADinv x]
        x = b[: self.n]
        y = b[self.n :] - self.ADinv @ x
        # M2inv: [DtildeInv x; -diaginv y]
        x = self.DtildeInv @ x
        y = -self.diag_inv * y
        # M3inv = M1inv^T: [x - ADinv^T y; y]
        return np.concatenate([x - self.ADinv.T @ y, y])

    def as_linear_operator(self):
        N = self.n + self.m
        return spla.LinearOperator((N, N), matvec=self.solve)


def build_gs_smoother(ops) -> GSSmootherPreconditioner:
    """Assemble the smoother from an export.ExplicitOperators
    (constructPreconditionerGSsmoother, Preconditioners.cpp:11-29)."""
    G, Dt, JDt, JG = ops.G(), ops.Dt(), ops.JDt(), ops.JG()
    u2 = -2.0 * ops.u()
    V = (Dt @ u2 @ Dt.T).tocsr()
    VJt = (Dt @ u2 @ JDt.T).tocsr()
    return GSSmootherPreconditioner(ops.Mc(), ops.Mr(), ops.BInv(), V, G, VJt, JG, float(ops.asm.dt))


def build_eq14(ops) -> Eq14Preconditioner:
    """Assemble Eq-14 from an export.ExplicitOperators
    (constructPreconditionerEq14, Preconditioners.cpp:43-95):
    A1 = [G^T JG^T], Dtilde = blkdiag(Mc, Mr)/dt."""
    dt = float(ops.asm.dt)
    G, JG = ops.G(), ops.JG()
    A1 = sp.hstack([G.T, JG.T]).tocsr()
    Dtilde = sp.block_diag([ops.Mc() / dt, ops.Mr() / dt]).tocsr()
    McInv = ops.McInv()
    mr = _host(ops.asm.mr)
    valid = _host(ops.asm.region_valid)
    eye = np.eye(ops.D)
    mr_inv = np.linalg.inv(np.where(valid[:, None, None], mr, eye))
    mr_inv = np.where(valid[:, None, None], mr_inv, 0.0)
    MrInv = sp.block_diag(list(mr_inv)) if ops.R else sp.csr_matrix((0, 0))
    DtildeInv = sp.block_diag([dt * McInv, dt * MrInv]).tocsr()
    return Eq14Preconditioner(A1, Dtilde, DtildeInv)
