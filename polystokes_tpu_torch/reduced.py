"""Per-region polynomial reduction on the cube-major path of
``polystokes_tpu.reduced``: region COMs, the least-squares fit, the reduced
mass and interior-viscosity Galerkin matrices, and the J couplings.

Every tile cube holds at most one region (tiled regions are cubes; untiled
ones pass ``classify.enforce_one_region_per_cube``), so each per-region
sum is a per-cube reshape reduction followed by a fixed-order segmented
sum over the small [ncubes] array (``RegionSum``).  Faces of axis a at
natural index f > 0 belong to cube (f-1)//T along a (index 0 is dropped);
edges likewise along their two offset axes.

Every per-region matrix is a sum of w * m_k(p + d1) * m_l(p + d2) with
constant shifts d, so one per-region moment vector of the degree-4
product monomials per weight field (a "Gram") yields every shifted pair
through constant monomial shift matrices: sum w m(p+d1) m(p+d2)^T =
S(d1) G S(d2)^T (``_build_reduced_gram``).  Offsets are in cell units.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .basis import monomial_matrix, monomial_shift_matrix, monomials_xyz, n_monomials
from .classify import REDUCED, Classification, is_active
from .config import BasisOrder, SolverParams
from .grid import EDGE_OFFSET_AXES, Grid, axis_view, face_offsets, pad_axis, shift, unit
from .operators import face_at_cell


def _coord_axis(shape, a: int, dtype, device):
    c = torch.arange(shape[a], dtype=dtype, device=device).reshape(axis_view(shape, a))
    return c.expand(*shape)


def _const(arr, like):
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def _cube_dims(grid: Grid, T: int):
    return tuple(-(-n // T) for n in grid.res)


# ---------------------------------------------------------------------------
# Per-cube reductions
# ---------------------------------------------------------------------------

def _to_cube_multiple(arr, facelike_axes, T: int, cs):
    """Drop index 0 along ``facelike_axes``, zero-pad each axis to cs[i]*T."""
    x = arr
    for ax in facelike_axes:
        x = x.narrow(ax, 1, x.shape[ax] - 1)
    for i in range(3):
        x = pad_axis(x, i, 0, cs[i] * T - x.shape[i])
    return x


def block_sum(arr, facelike_axes, T: int, cs):
    """Per-cube sum -> [ncubes], one axis at a time (z first)."""
    x = _to_cube_multiple(arr, facelike_axes, T, cs)
    x = x.reshape(cs[0] * T, cs[1] * T, cs[2], T).sum(dim=3)
    x = x.reshape(cs[0] * T, cs[1], T, cs[2]).sum(dim=2)
    x = x.reshape(cs[0], T, cs[1], cs[2]).sum(dim=1)
    return x.reshape(-1)


def block_broadcast(vals, facelike_axes, T: int, cs, out_shape):
    """[ncubes] -> grid: each cube's value over its cells, with a zero
    plane re-inserted at index 0 along the facelike axes."""
    x = vals.reshape(cs[0], cs[1], cs[2])
    x = x[:, None, :, None, :, None].expand(cs[0], T, cs[1], T, cs[2], T).reshape(cs[0] * T, cs[1] * T, cs[2] * T)
    crop = list(out_shape)
    for ax in facelike_axes:
        crop[ax] -= 1
    x = x[: crop[0], : crop[1], : crop[2]]
    for ax in facelike_axes:
        x = pad_axis(x, ax, 1, 0)
    return x


class RegionSum:
    """Per-cube rows summed into their region slot: ``rsum(vals [ncubes,
    ...]) -> [R, ...]``, a gather through ``table`` and a sum over its
    fixed dimension.  No atomics (``index_add`` sums in another order on
    every run on the card) and no [R, ncubes] tensor; the table is built
    once, with host reads, so a CUDA graph replays the sum.  On the CPU the
    sum folds in cube order, which is the JAX package's ``segment_sum`` bit
    for bit; on the card it is one reduction over the table's columns (a
    floating ``cumsum`` is not deterministic there)."""

    def __init__(self, region_of_cube, R: int):
        nc = region_of_cube.shape[0]
        dev = region_of_cube.device
        seg = torch.where(region_of_cube >= 0, region_of_cube.long(), R)  # cubes without a region: segment R
        seg_sorted, order = torch.sort(seg, stable=True)  # by region, cube ids increasing within one
        counts = torch.bincount(seg, minlength=R + 1)
        m = max(int(counts[:R].max()), 1)
        rank = torch.arange(nc, device=dev) - (torch.cumsum(counts, 0) - counts)[seg_sorted]
        keep = seg_sorted < R
        # [R, m]: row r holds region r's cube ids in increasing order, padded
        # with nc (the appended zero row); m = 1 when tiled
        self.table = torch.full((R, m), nc, dtype=torch.int64, device=dev)
        self.table[seg_sorted[keep], rank[keep]] = order[keep]
        self.R = R

    def __call__(self, vals):
        flat = vals.reshape(vals.shape[0], -1)
        flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))], dim=0)
        per_region = flat.index_select(0, self.table.reshape(-1)).reshape(self.R, self.table.shape[1], -1)
        out = per_region.sum(dim=1) if per_region.is_cuda else per_region.cumsum(dim=1)[:, -1]
        return out.reshape((self.R,) + tuple(vals.shape[1:]))


class _Accumulator:
    """Per-region reductions through the cube map (cube-major path)."""

    def __init__(self, grid: Grid, cls: Classification, params: SolverParams, R: int):
        self.T = params.tile_size
        self.cs = _cube_dims(grid, self.T)
        self.roc = cls.region_of_cube
        self.rsum = RegionSum(cls.region_of_cube, R)

    def vec(self, vals, family):
        """vals [D, grid...] -> [R, D]."""
        fl = () if family == "cell" else EDGE_OFFSET_AXES[family[1]]
        cols = [block_sum(vals[d], fl, self.T, self.cs) for d in range(vals.shape[0])]
        return self.rsum(torch.stack(cols, dim=-1))


# ---------------------------------------------------------------------------
# Gram-form reduced setup
# ---------------------------------------------------------------------------

def _monomial_product_table(basis):
    """(idx [K, K], plist): the product-monomial exponent table."""
    if basis == BasisOrder.QUADRATIC:
        exps = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0),
                (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2)]
    else:
        exps = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]
    K = len(exps)
    table, plist = {}, []
    idx = np.zeros((K, K), np.int64)
    for j in range(K):
        for l in range(K):
            e = tuple(a + b for a, b in zip(exps[j], exps[l]))
            if e not in table:
                table[e] = len(plist)
                plist.append(e)
            idx[j, l] = table[e]
    return idx, plist


def _local_moment_matrix(T: int, plist) -> np.ndarray:
    """Constant [T^3, P] product monomials at centered in-cube coordinates
    j - (T-1)/2, in (x, y, z) row-major order."""
    loc = np.arange(T, dtype=np.float64) - (T - 1) / 2.0
    lx, ly, lz = loc[:, None, None], loc[None, :, None], loc[None, None, :]
    cols = [(lx ** e[0]) * (ly ** e[1]) * (lz ** e[2]) * np.ones((T, T, T)) for e in plist]
    return np.stack([c.reshape(-1) for c in cols], axis=-1)


def _cube_major(arr, facelike_axes, T: int, cs):
    """grid -> [ncubes, T^3] (cube order of region_of_cube)."""
    x = _to_cube_multiple(arr, facelike_axes, T, cs)
    x = x.reshape(cs[0], T, cs[1], T, cs[2], T).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(cs[0] * cs[1] * cs[2], T * T * T)


def _shift4_tables(plist):
    """(CO [P, P], EX [P, P, 3]) for m_e(l + d) = sum_k CO[e,k] d^EX[e,k] m_k(l)."""
    P = len(plist)
    CO = np.zeros((P, P))
    EX = np.zeros((P, P, 3), np.int64)
    pidx = {e: i for i, e in enumerate(plist)}
    for ei, e in enumerate(plist):
        for kx in range(e[0] + 1):
            for ky in range(e[1] + 1):
                for kz in range(e[2] + 1):
                    ki = pidx.get((kx, ky, kz))
                    if ki is None:
                        continue
                    CO[ei, ki] = math.comb(e[0], kx) * math.comb(e[1], ky) * math.comb(e[2], kz)
                    EX[ei, ki] = (e[0] - kx, e[1] - ky, e[2] - kz)
    return CO, EX


def _shift_moments(mom_local, d, CO, EX, max_pow: int):
    """Per-cube shift of product-monomial moments [nc, P] by d [nc, 3]."""
    dp = [torch.stack([d[:, i] ** p for p in range(max_pow + 1)], dim=-1) for i in range(3)]
    S = CO[None] * dp[0][:, EX[:, :, 0]] * dp[1][:, EX[:, :, 1]] * dp[2][:, EX[:, :, 2]]
    return torch.einsum("cek,ck->ce", S, mom_local)


def _const_shift(delta, basis, like):
    """[K, K] constant S with m(p + delta) = S m(p)."""
    c = [torch.tensor(-d, dtype=like.dtype, device=like.device) for d in delta]
    return monomial_shift_matrix(c[0], c[1], c[2], basis)


def _build_reduced_gram(grid, cls, com, velocity, viscosity_c, viscosity_e, params, R, acc):
    """(fitM, fitb, mr, vr) through per-weight Grams (module doc)."""
    dtype = params.dtype
    dev = com.device
    D = params.reduced_dof
    T, cs, roc = acc.T, acc.cs, acc.roc
    red_cell = cls.cell_labels == REDUCED
    idx_tab, plist = _monomial_product_table(params.basis)
    K = n_monomials(params.basis)
    max_pow = max(max(e) for e in plist)
    inv_dx2 = 1.0 / (grid.dx * grid.dx)
    rho = params.effective_density
    idx_tab_t = torch.as_tensor(idx_tab, device=dev)
    CO_np, EX_np = _shift4_tables(plist)
    CO = torch.as_tensor(CO_np, dtype=dtype, device=dev)
    EX = torch.as_tensor(EX_np, device=dev)

    nc = cs[0] * cs[1] * cs[2]
    ci = np.arange(nc)
    origins = np.stack([ci // (cs[1] * cs[2]), (ci // cs[2]) % cs[1], ci % cs[2]], axis=-1) * T
    com_c = com[roc.clamp(min=0).long()]
    d_cube = torch.as_tensor(origins + (T - 1) / 2.0, dtype=dtype, device=dev) - com_c.to(dtype)
    mloc = torch.as_tensor(_local_moment_matrix(T, plist), dtype=dtype, device=dev)

    def cube_moments(w, facelike):
        mom_local = _cube_major(w, facelike, T, cs) @ mloc  # [nc, P]
        offs = torch.tensor([1.0 if a in facelike else 0.0 for a in range(3)], dtype=dtype, device=dev)
        return _shift_moments(mom_local, d_cube + offs, CO, EX, max_pow)

    def gram_of(w, facelike=()):
        M = acc.rsum(cube_moments(w, facelike))  # [R, P]
        return M[:, idx_tab_t]  # [R, K, K]

    def moments1(g):
        return acc.rsum(cube_moments(g, ()))[:, :K]

    def quad(AS1, G, AS2):
        return torch.einsum("dk,rkl,el->rde", AS1, G, AS2)

    active_cell = is_active(cls.cell_labels)
    G_red = gram_of(red_cell.to(dtype))
    G_visc = gram_of(red_cell.to(dtype) * viscosity_c.to(dtype) * inv_dx2)

    fitM = torch.zeros((R, D, D), dtype=dtype, device=dev)
    fitb = torch.zeros((R, D), dtype=dtype, device=dev)
    mr = torch.zeros((R, D, D), dtype=dtype, device=dev)
    vr = torch.zeros((R, D, D), dtype=dtype, device=dev)
    for a in range(3):
        A = torch.as_tensor(monomial_matrix(a, params.basis), dtype=dtype, device=dev)
        d_lo = [0.0, 0.0, 0.0]
        d_lo[a] = -0.5
        d_hi = [0.0, 0.0, 0.0]
        d_hi[a] = 0.5
        AS_lo = A @ _const_shift(d_lo, params.basis, A)
        AS_hi = A @ _const_shift(d_hi, params.basis, A)
        w_lo = (red_cell & shift(active_cell, unit(a, -1), False)).to(dtype)
        w_hi = (red_cell & shift(active_cell, unit(a, 1), False)).to(dtype)
        G_lo = gram_of(w_lo)
        G_hi = gram_of(w_hi)
        fitM = fitM + quad(AS_lo, G_lo, AS_lo) + quad(AS_hi, G_hi, AS_hi)
        mr = mr + rho * (quad(AS_lo, G_red, AS_lo) + quad(AS_hi, G_hi, AS_hi))
        ASd = AS_hi - AS_lo
        vr = vr + quad(ASd, G_visc, ASd)
        u_lo = face_at_cell(velocity[a].to(dtype), a, 0)
        u_hi = face_at_cell(velocity[a].to(dtype), a, 1)
        fitb = fitb + moments1(w_lo * u_lo) @ AS_lo.T + moments1(w_hi * u_hi) @ AS_hi.T

    # edge shear terms: u = sum over the 4 surrounding faces of sigma_f c(f)
    for e in range(3):
        p_ax, q_ax = EDGE_OFFSET_AXES[e]
        Bsum = None
        for fa, other in ((p_ax, q_ax), (q_ax, p_ax)):
            d_up = list(face_offsets(fa))
            d_dn = list(d_up)
            d_dn[other] -= 1.0
            A_fa = torch.as_tensor(monomial_matrix(fa, params.basis), dtype=dtype, device=dev)
            Bterm = A_fa @ (_const_shift(d_dn, params.basis, A_fa) - _const_shift(d_up, params.basis, A_fa))
            Bsum = Bterm if Bsum is None else Bsum + Bterm
        w = (cls.edge_labels[e] == REDUCED).to(dtype) * 0.5 * viscosity_e[e].to(dtype) * inv_dx2
        vr = vr + quad(Bsum, gram_of(w, EDGE_OFFSET_AXES[e]), Bsum)
    return fitM, fitb, mr, vr


# ---------------------------------------------------------------------------
# Region geometry and reduced data
# ---------------------------------------------------------------------------

def center_of_masses(cls: Classification, R: int, dtype, acc: _Accumulator):
    """([R, 3] mean cell coordinate per region in cell units, [R] counts)."""
    m = (cls.cell_labels == REDUCED).to(dtype)
    shape = cls.cell_labels.shape
    vals = torch.stack([_coord_axis(shape, a, dtype, m.device) * m for a in range(3)] + [m], dim=0)
    sums = acc.vec(vals, "cell")
    counts = sums[:, 3]
    return sums[:, :3] / torch.clamp(counts, min=1.0)[:, None], counts


@dataclasses.dataclass(frozen=True)
class ReducedData:
    com: torch.Tensor  # [R, 3]
    cell_counts: torch.Tensor  # [R]
    mr: torch.Tensor  # [R, D, D] mass
    vr: torch.Tensor  # [R, D, D] interior viscosity
    binv: torch.Tensor  # [R, D, D] inv(Mr/dt + 2 Vr)
    best_fit: torch.Tensor  # [R, D]
    b_w: torch.Tensor  # [R, D] = Mr @ best_fit


def _eye_where_invalid(M, valid):
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.where(valid[:, None, None], M, eye)


def build_reduced(grid: Grid, cls: Classification, velocity, viscosity_c, viscosity_e, params: SolverParams, R: int) -> ReducedData:
    """COM, fit, mass and viscosity per region (Solver.cpp:1275-1909)."""
    dtype = params.dtype
    acc = _Accumulator(grid, cls, params, R)
    com, counts = center_of_masses(cls, R, dtype, acc)
    fitM, fitb, mr, vr = _build_reduced_gram(grid, cls, com, velocity, viscosity_c, viscosity_e, params, R, acc)
    valid = cls.region_valid
    L = torch.linalg.cholesky(_eye_where_invalid(fitM, valid))
    best_fit = torch.cholesky_solve(fitb[..., None], L)[..., 0]
    best_fit = torch.where(valid[:, None], best_fit, 0.0)
    return ReducedData(com=com, cell_counts=counts, mr=mr, vr=vr, binv=torch.zeros_like(mr),
                       best_fit=best_fit, b_w=torch.zeros_like(best_fit))


def finalize_reduced(rd: ReducedData, valid, dt, dtype, D):
    """B = Mr/dt + 2 Vr per region, inverted (AssembleBlocks.cpp:196-244)."""
    B = _eye_where_invalid(rd.mr / dt + 2.0 * rd.vr, valid)
    binv = torch.cholesky_inverse(torch.linalg.cholesky(B))
    binv = torch.where(valid[:, None, None], binv, 0.0)
    b_w = torch.einsum("rij,rj->ri", rd.mr, rd.best_fit)
    return dataclasses.replace(rd, binv=binv, b_w=b_w)


# ---------------------------------------------------------------------------
# J couplings (cube-major)
# ---------------------------------------------------------------------------

def _face_offset_grids(cls: Classification, com, axis: int, params: SolverParams, T: int, cs):
    """Face position minus the COM of the face's cube's region, per component."""
    dtype = params.dtype
    shape = cls.face_region[axis].shape
    off = face_offsets(axis)
    roc = cls.region_of_cube
    safe = roc.clamp(0, com.shape[0] - 1).long()
    out = []
    for i in range(3):
        com_i = torch.where(roc >= 0, com[safe, i], 0.0)
        com_grid = block_broadcast(com_i, (axis,), T, cs, shape)
        out.append(_coord_axis(shape, i, dtype, com.device) + off[i] - com_grid)
    return out


def _reduced_face(cls: Classification, a: int):
    return (cls.face_labels[a] == REDUCED) & (cls.face_region[a] >= 0)


def reduce_J_tiled(grid: Grid, cls: Classification, com, s_faces, params: SolverParams, R: int):
    """y = J x: per-cube moments of the reduced-masked face values s
    against the K monomials, combined with the constant A matrices, summed
    per region."""
    T = params.tile_size
    cs = _cube_dims(grid, T)
    y_cube = torch.zeros((cs[0] * cs[1] * cs[2], params.reduced_dof), dtype=params.dtype, device=com.device)
    for a in range(3):
        s = torch.where(_reduced_face(cls, a), s_faces[a], 0.0)
        mono = monomials_xyz(*_face_offset_grids(cls, com, a, params, T, cs), params.basis)
        mu = torch.stack([block_sum(s * m, (a,), T, cs) for m in mono], dim=-1)  # [nc, K]
        y_cube = y_cube + mu @ torch.as_tensor(monomial_matrix(a, params.basis), dtype=params.dtype, device=com.device).T
    return RegionSum(cls.region_of_cube, R)(y_cube)


def expand_J_tiled(grid: Grid, cls: Classification, com, w, params: SolverParams):
    """u = J^T w on reduced faces: v = w A per cube, u = sum_k v_k m_k."""
    T = params.tile_size
    cs = _cube_dims(grid, T)
    roc = cls.region_of_cube
    safe = roc.clamp(0, w.shape[0] - 1).long()
    w_cube = torch.where((roc >= 0)[:, None], w[safe], 0.0)
    out = []
    for a in range(3):
        v = w_cube @ torch.as_tensor(monomial_matrix(a, params.basis), dtype=params.dtype, device=w.device)
        fshape = cls.face_region[a].shape
        mono = monomials_xyz(*_face_offset_grids(cls, com, a, params, T, cs), params.basis)
        u_face = sum(block_broadcast(v[:, k], (a,), T, cs, fshape) * mono[k] for k in range(len(mono)))
        out.append(torch.where(_reduced_face(cls, a), u_face, 0.0))
    return out


def reduce_J(grid: Grid, cls: Classification, com, s_faces, params: SolverParams, R: int):
    """y = J x; the cube-major form (the segmented general form is not ported)."""
    return reduce_J_tiled(grid, cls, com, s_faces, params, R)


def expand_J(grid: Grid, cls: Classification, com, w, params: SolverParams):
    """u = J^T w rows on reduced faces; the cube-major form."""
    return expand_J_tiled(grid, cls, com, w, params)
