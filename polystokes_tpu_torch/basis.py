"""Divergence-free polynomial reduction bases (``polystokes_tpu.basis``).

``conversion_coefficients(offset, axis)`` is the coefficient row c with
``u_axis(x) = c . w`` for region coefficients w, ``offset = x - COM``, in
cell units.  The quadratic basis has 26 DOFs (exec/HDK_PolyStokesSolver.cpp:
2107-2149), the affine one 11 (:2153-2182).  Every row is a constant
combination ``A`` of the monomials ``[1, x, y, z, x^2, xy, xz, y^2, yz,
z^2]`` (``monomial_matrix``), which is what the kernels evaluate.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BasisOrder

QUADRATIC_DOF = 26
AFFINE_DOF = 11
QUADRATIC_MONOMIALS = 10
AFFINE_MONOMIALS = 4


def conversion_coefficients(offset: torch.Tensor, axis: int, basis: BasisOrder = BasisOrder.QUADRATIC, stack_axis: int = -1) -> torch.Tensor:
    """Basis row for a velocity sample at ``offset`` (..., 3)."""
    return conversion_coefficients_xyz(offset[..., 0], offset[..., 1], offset[..., 2], axis, basis, stack_axis)


def conversion_coefficients_xyz(x, y, z, axis: int, basis: BasisOrder = BasisOrder.QUADRATIC, stack_axis: int = -1) -> torch.Tensor:
    """``conversion_coefficients`` from separate coordinate tensors."""
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    if basis == BasisOrder.QUADRATIC:
        if axis == 0:
            cols = [one, zero, zero, x, y, z, x * x, x * y, x * z, y * y, y * z, z * z] + [zero] * 14
        elif axis == 1:
            cols = [zero, one, zero] + [zero] * 9 + [x, y, z, x * x, x * y, x * z, y * y, y * z, z * z] + [zero] * 5
        else:
            cols = [zero, zero, one,
                    -z, zero, zero,
                    -2.0 * x * z, -y * z, -0.5 * z * z,
                    zero, zero, zero,
                    zero, -z, zero,
                    zero, -x * z, zero,
                    -2.0 * y * z, -0.5 * z * z, zero,
                    x, y, x * x,
                    x * y, y * y]
    else:
        if axis == 0:
            cols = [one, zero, zero, x, y, z] + [zero] * 5
        elif axis == 1:
            cols = [zero, one, zero, zero, zero, zero, x, y, z, zero, zero]
        else:
            cols = [zero, zero, one, -z, zero, zero, zero, -z, zero, x, y]
    return torch.stack(cols, dim=stack_axis)


def monomials_xyz(x, y, z, basis: BasisOrder = BasisOrder.QUADRATIC):
    """The monomials spanning every basis row, in the kernels' order."""
    if basis == BasisOrder.QUADRATIC:
        return [torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z]
    return [torch.ones_like(x), x, y, z]


def n_monomials(basis: BasisOrder = BasisOrder.QUADRATIC) -> int:
    return QUADRATIC_MONOMIALS if basis == BasisOrder.QUADRATIC else AFFINE_MONOMIALS


def monomial_shift_matrix(cx, cy, cz, basis: BasisOrder = BasisOrder.QUADRATIC):
    """S with m_k(p - c) = sum_j S[.., k, j] m_j(p), batched over the
    shape of cx/cy/cz -> [.., K, K].  Turns the kernels' cube-origin
    moments into COM-relative ones."""
    zero = torch.zeros_like(cx)
    one = torch.ones_like(cx)

    def row(entries):
        return torch.stack(entries, dim=-1)

    if basis == BasisOrder.AFFINE:
        rows = [
            row([one, zero, zero, zero]),
            row([-cx, one, zero, zero]),
            row([-cy, zero, one, zero]),
            row([-cz, zero, zero, one]),
        ]
        return torch.stack(rows, dim=-2)
    rows = [
        row([one, zero, zero, zero, zero, zero, zero, zero, zero, zero]),
        row([-cx, one, zero, zero, zero, zero, zero, zero, zero, zero]),
        row([-cy, zero, one, zero, zero, zero, zero, zero, zero, zero]),
        row([-cz, zero, zero, one, zero, zero, zero, zero, zero, zero]),
        row([cx * cx, -2 * cx, zero, zero, one, zero, zero, zero, zero, zero]),
        row([cx * cy, -cy, -cx, zero, zero, one, zero, zero, zero, zero]),
        row([cx * cz, -cz, zero, -cx, zero, zero, one, zero, zero, zero]),
        row([cy * cy, zero, -2 * cy, zero, zero, zero, zero, one, zero, zero]),
        row([cy * cz, zero, -cz, -cy, zero, zero, zero, zero, one, zero]),
        row([cz * cz, zero, zero, -2 * cz, zero, zero, zero, zero, zero, one]),
    ]
    return torch.stack(rows, dim=-2)


def monomial_matrix(axis: int, basis: BasisOrder = BasisOrder.QUADRATIC) -> np.ndarray:
    """Constant [D, K] matrix A with
    conversion_coefficients(o, axis)[d] == sum_k A[d, k] m_k(o)."""
    if basis == BasisOrder.QUADRATIC:
        A = np.zeros((QUADRATIC_DOF, QUADRATIC_MONOMIALS))
        if axis == 0:
            A[0, 0] = 1.0
            for i in range(9):
                A[3 + i, 1 + i] = 1.0
        elif axis == 1:
            A[1, 0] = 1.0
            for i in range(9):
                A[12 + i, 1 + i] = 1.0
        else:
            A[2, 0] = 1.0
            A[3, 3] = -1.0
            A[6, 6] = -2.0
            A[7, 8] = -1.0
            A[8, 9] = -0.5
            A[13, 3] = -1.0
            A[16, 6] = -1.0
            A[18, 8] = -2.0
            A[19, 9] = -0.5
            A[21, 1] = 1.0
            A[22, 2] = 1.0
            A[23, 4] = 1.0
            A[24, 5] = 1.0
            A[25, 7] = 1.0
        return A
    A = np.zeros((AFFINE_DOF, AFFINE_MONOMIALS))
    if axis == 0:
        A[0, 0] = 1.0
        A[3, 1] = 1.0
        A[4, 2] = 1.0
        A[5, 3] = 1.0
    elif axis == 1:
        A[1, 0] = 1.0
        A[6, 1] = 1.0
        A[7, 2] = 1.0
        A[8, 3] = 1.0
    else:
        A[2, 0] = 1.0
        A[3, 3] = -1.0
        A[7, 3] = -1.0
        A[9, 1] = 1.0
        A[10, 2] = 1.0
    return A


def evaluate_velocity(offset: torch.Tensor, axis: int, w: torch.Tensor, basis: BasisOrder = BasisOrder.QUADRATIC) -> torch.Tensor:
    """u_axis at ``offset`` for region coefficients w (..., D)."""
    return torch.sum(conversion_coefficients(offset, axis, basis) * w, dim=-1)


def divergence(offset: torch.Tensor, w: torch.Tensor, basis: BasisOrder = BasisOrder.QUADRATIC) -> torch.Tensor:
    """Analytic divergence of the polynomial field at ``offset`` (for tests)."""
    x, y, z = offset[..., 0], offset[..., 1], offset[..., 2]
    if basis == BasisOrder.QUADRATIC:
        dvx_dx = w[..., 3] + 2 * w[..., 6] * x + w[..., 7] * y + w[..., 8] * z
        dvy_dy = w[..., 13] + w[..., 16] * x + 2 * w[..., 18] * y + w[..., 19] * z
        dvz_dz = (-w[..., 3] - 2 * w[..., 6] * x - w[..., 7] * y - w[..., 8] * z
                  - w[..., 13] - w[..., 16] * x - 2 * w[..., 18] * y - w[..., 19] * z)
    else:
        dvx_dx = w[..., 3]
        dvy_dy = w[..., 7]
        dvz_dz = -w[..., 3] - w[..., 7]
    return dvx_dx + dvy_dy + dvz_dz
