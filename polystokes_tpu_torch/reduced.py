"""Per-region polynomial reduction, as ``polystokes_tpu.reduced``: region
COMs, the least-squares fit, the reduced mass and interior-viscosity
Galerkin matrices, and the J couplings, on either of JAX's two paths
(``_use_tiled``):

* cube-major: every tile cube holds at most one region (tiled regions are
  cubes; untiled ones pass ``classify.enforce_one_region_per_cube`` under
  ``cube_regions``), so each per-region sum is a per-cube reshape
  reduction followed by a fixed-order segmented sum over the small
  [ncubes] array (``RegionSum``).  Faces of axis a at natural index f > 0
  belong to cube (f-1)//T along a (index 0 is dropped); edges likewise
  along their two offset axes.  Every per-region matrix is a sum of
  w * m_k(p + d1) * m_l(p + d2) with constant shifts d, so one per-region
  moment vector of the degree-4 product monomials per weight field (a
  "Gram") yields every shifted pair through constant monomial shift
  matrices: sum w m(p+d1) m(p+d2)^T = S(d1) G S(d2)^T
  (``_build_reduced_gram``).
* segmented (general region shapes: ``do_tile=False`` without
  ``cube_regions``, or tiles without padding slabs): per-sample sums
  grouped by region id (``SegmentSum``, JAX's ``segment_sum``).

Offsets are in cell units.
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


def _use_tiled(params: SolverParams) -> bool:
    """Whether the cube-major paths apply (JAX's rule): tiled with padding
    slabs, or untiled with ``cube_regions``, which keeps one region per
    tile cube.  Otherwise the sums are segmented by region id."""
    if params.do_tile:
        return params.tile_padding >= 1
    return params.cube_regions


# ---------------------------------------------------------------------------
# Segmented reductions (general region shapes)
# ---------------------------------------------------------------------------

class SegmentSum:
    """Sums grouped by segment id in a fixed order: ``ssum(vals [C, N]) ->
    [R, C]`` for ids [N] in [-1, R) (-1: no segment), the JAX package's
    ``segment_sum`` without atomics (``index_add_`` sums in another order
    on every run on the card, and CUDA's floating ``cumsum`` is not
    deterministic either).

    The order is built once, with host reads, so a CUDA graph replays the
    sum: a stable sort of the ids lays each segment's samples out from a
    block boundary, blocks of ``BLOCK`` samples are summed along one axis,
    and the block sums fold the same way, level by level, until every
    segment holds at most one block.  Each level is a gather and a
    reduction of fixed shape.  The sums are grouped, so they round
    otherwise than JAX's sequential scatter: the two agree to round-off,
    not bit for bit."""

    BLOCK = 256  # samples summed along one axis at each level

    def __init__(self, ids, R: int):
        dev = ids.device
        block = self.BLOCK
        seg = torch.where(ids.reshape(-1) >= 0, ids.reshape(-1).long(), R)
        seg_sorted, order = torch.sort(seg, stable=True)
        counts = torch.bincount(seg, minlength=R + 1)[:R]
        n = int(counts.sum())
        src, owner = order[:n], seg_sorted[:n]  # sample index and segment, segment-major
        self.R = R
        self.levels = []  # per level (gather index, mask): samples -> blocks of BLOCK
        while True:
            nb = (counts + block - 1) // block  # blocks per segment at this level
            first = torch.cumsum(nb, 0) - nb
            rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[owner]
            n_blocks = int(nb.sum())
            index = torch.zeros(n_blocks * block, dtype=torch.int64, device=dev)
            mask = torch.zeros(n_blocks * block, dtype=torch.bool, device=dev)
            pos = first[owner] * block + rank
            index[pos] = src
            mask[pos] = True
            self.levels.append((index, mask))
            if n == 0 or int(nb.max()) <= 1:
                break
            # the block sums are segment-major already: fold them next
            counts, n = nb, n_blocks
            src = torch.arange(n, device=dev)
            owner = torch.repeat_interleave(torch.arange(R, device=dev), nb)
        self.out_mask = nb > 0
        self.out_index = torch.where(self.out_mask, first, 0)

    def _gather(self, flat, index, mask):
        if flat.shape[1] == 0:
            return flat.new_zeros((flat.shape[0], index.shape[0]))
        return torch.where(mask, flat.index_select(1, index), 0.0)

    def _fold(self, flat, levels):
        """[C, n] samples (or block sums) -> [C, R] through ``levels``."""
        for index, mask in levels:
            flat = self._gather(flat, index, mask).reshape(flat.shape[0], -1, self.BLOCK).sum(dim=2)
        return self._gather(flat, self.out_index, self.out_mask)

    def __call__(self, vals):
        """vals [C, N] -> [R, C]."""
        return self._fold(vals.reshape(vals.shape[0], -1), self.levels).T

    def rank1(self, C1, C2, w):
        """[R, D1, D2] sums of w C1 C2^T for C1 [D1, N], C2 [D2, N], w [N]:
        the first level's block sums are one batched product, so no
        [samples, D1, D2] tensor is formed."""
        index, mask = self.levels[0]
        D1, D2 = C1.shape[0], C2.shape[0]
        wg = self._gather(w.reshape(1, -1), index, mask)
        g1 = (self._gather(C1.reshape(D1, -1), index, mask) * wg).reshape(D1, -1, self.BLOCK)
        g2 = self._gather(C2.reshape(D2, -1), index, mask).reshape(D2, -1, self.BLOCK)
        blocks = torch.bmm(g1.permute(1, 0, 2), g2.permute(1, 2, 0))  # [n_blocks, D1, D2]
        out = self._fold(blocks.reshape(blocks.shape[0], D1 * D2).T, self.levels[1:])
        return out.T.reshape(self.R, D1, D2)


def segment_sum_vec(vals_leading, ids, R: int):
    """vals [D, grid...] summed by ids [grid...] -> [R, D]."""
    return SegmentSum(ids, R)(vals_leading.reshape(vals_leading.shape[0], -1))


def segment_rank1(C1, C2, w, ids, R: int):
    """[R, D, D] accumulation of w * C1 C2^T grouped by ids (C1, C2:
    [D, grid...]), without a [samples, D, D] intermediate."""
    return SegmentSum(ids, R).rank1(C1.reshape(C1.shape[0], -1), C2.reshape(C2.shape[0], -1), w.reshape(-1))


# ---------------------------------------------------------------------------
# Per-cube reductions
# ---------------------------------------------------------------------------

def _to_cube_multiple(arr, facelike_axes, T: int, cs):
    """Drop index 0 along ``facelike_axes``, zero-pad each axis to cs[i]*T
    (the last three axes of ``arr``; leading axes are a batch)."""
    x = arr
    for ax in facelike_axes:
        x = x.narrow(ax - 3, 1, x.shape[ax - 3] - 1)
    for i in range(3):
        x = pad_axis(x, i - 3, 0, cs[i] * T - x.shape[i - 3])
    return x


def block_sum(arr, facelike_axes, T: int, cs):
    """Per-cube sum of the last three axes -> [..., ncubes], one axis at a
    time (z first)."""
    lead = arr.shape[:-3]
    x = _to_cube_multiple(arr, facelike_axes, T, cs)
    x = x.reshape(*lead, cs[0] * T, cs[1] * T, cs[2], T).sum(dim=-1)
    x = x.reshape(*lead, cs[0] * T, cs[1], T, cs[2]).sum(dim=-2)
    x = x.reshape(*lead, cs[0], T, cs[1], cs[2]).sum(dim=-3)
    return x.reshape(*lead, -1)


def block_broadcast(vals, facelike_axes, T: int, cs, out_shape):
    """[..., ncubes] -> [..., grid]: each cube's value over its cells, with
    a zero plane re-inserted at index 0 along the facelike axes."""
    lead = vals.shape[:-1]
    x = vals.reshape(*lead, cs[0], 1, cs[1], 1, cs[2], 1)
    x = x.expand(*lead, cs[0], T, cs[1], T, cs[2], T).reshape(*lead, cs[0] * T, cs[1] * T, cs[2] * T)
    crop = list(out_shape)
    for ax in facelike_axes:
        crop[ax] -= 1
    x = x[..., : crop[0], : crop[1], : crop[2]]
    for ax in facelike_axes:
        x = pad_axis(x, ax - 3, 1, 0)
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
    """Per-region reductions, cube-major or segmented (``_use_tiled``).
    Values use the leading-D layout [D, grid...]."""

    def __init__(self, grid: Grid, cls: Classification, params: SolverParams, R: int):
        self.cls, self.R = cls, R
        self.tiled = _use_tiled(params)
        if self.tiled:
            self.T = params.tile_size
            self.cs = _cube_dims(grid, self.T)
            self.roc = cls.region_of_cube
            self.rsum = RegionSum(cls.region_of_cube, R)
        self._ssum = {}

    def _segments(self, family) -> SegmentSum:
        """The reduced samples of ``family`` ("cell" or ("edge", e)) by region."""
        if family not in self._ssum:
            if family == "cell":
                ids = torch.where(self.cls.cell_labels == REDUCED, self.cls.cell_region, -1)
            else:
                e = family[1]
                ids = torch.where(self.cls.edge_labels[e] == REDUCED, self.cls.edge_region[e], -1)
            self._ssum[family] = SegmentSum(ids, self.R)
        return self._ssum[family]

    def vec(self, vals, family):
        """vals [D, grid...] -> [R, D]."""
        if self.tiled:
            fl = () if family == "cell" else EDGE_OFFSET_AXES[family[1]]
            cols = [block_sum(vals[d], fl, self.T, self.cs) for d in range(vals.shape[0])]
            return self.rsum(torch.stack(cols, dim=-1))
        return self._segments(family)(vals.reshape(vals.shape[0], -1))

    # the monomial forms of the segmented path (the cube-major setup goes
    # through the Grams instead): C = A m is formed whole, [D, grid]

    def rank1_mono(self, mono1, mono2, w, A1, A2, family):
        """[R, D, D] sums of w (A1 m1)(A2 m2)^T; mono1, mono2: lists of K
        [grid...] tensors, A1 [D, K1], A2 [D, K2]."""
        C1 = torch.einsum("dk,k...->d...", A1, torch.stack(mono1, dim=0))
        C2 = C1 if (mono2 is mono1 and A2 is A1) else torch.einsum("dk,k...->d...", A2, torch.stack(mono2, dim=0))
        D = C1.shape[0]
        return self._segments(family).rank1(C1.reshape(D, -1), C2.reshape(C2.shape[0], -1), w.reshape(-1))

    def vec_mono(self, mono, w, A, family):
        """[R, D] sums of w (A m)."""
        C = torch.einsum("dk,k...->d...", A, torch.stack(mono, dim=0))
        return self._segments(family)((C * w[None]).reshape(C.shape[0], -1))


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


def gather_com_xyz(com, region_ids):
    """Per-sample COM components (three [grid...] tensors, 0 off regions)."""
    safe = region_ids.clamp(0, com.shape[0] - 1).long()
    ok = region_ids >= 0
    return tuple(torch.where(ok, com[safe, i], 0.0) for i in range(3))


def gather_com(com, region_ids):
    """Per-sample COM [grid..., 3] (0 off regions)."""
    safe = region_ids.clamp(0, com.shape[0] - 1).long()
    return torch.where((region_ids >= 0)[..., None], com[safe], 0.0)


def _best_fit(fitM, fitb, valid):
    L = torch.linalg.cholesky(_eye_where_invalid(fitM, valid))
    return torch.where(valid[:, None], torch.cholesky_solve(fitb[..., None], L)[..., 0], 0.0)


def build_reduced(grid: Grid, cls: Classification, velocity, viscosity_c, viscosity_e, params: SolverParams, R: int) -> ReducedData:
    """COM, fit, mass and viscosity per region (Solver.cpp:1275-1909):
    through the Grams on the cube-major path, as rank-1 sums of the basis
    rows of each sample on the segmented one (JAX's general branch)."""
    dtype = params.dtype
    acc = _Accumulator(grid, cls, params, R)
    com, counts = center_of_masses(cls, R, dtype, acc)
    valid = cls.region_valid
    if acc.tiled:
        fitM, fitb, mr, vr = _build_reduced_gram(grid, cls, com, velocity, viscosity_c, viscosity_e, params, R, acc)
        best_fit = _best_fit(fitM, fitb, valid)
        return ReducedData(com=com, cell_counts=counts, mr=mr, vr=vr, binv=torch.zeros_like(mr),
                           best_fit=best_fit, b_w=torch.zeros_like(best_fit))

    dev = com.device
    D = params.reduced_dof
    red_cell = cls.cell_labels == REDUCED
    shape = cls.cell_labels.shape
    cx, cy, cz = gather_com_xyz(com, cls.cell_region)
    pos = [_coord_axis(shape, 0, dtype, dev) - cx, _coord_axis(shape, 1, dtype, dev) - cy,
           _coord_axis(shape, 2, dtype, dev) - cz]

    def cell_face_monomials(axis, side):
        """Monomials at every cell's lower (side 0) or upper face of ``axis``."""
        p = list(pos)
        p[axis] = p[axis] + (0.5 if side else -0.5)
        return monomials_xyz(p[0], p[1], p[2], params.basis)

    # least-squares fit (Solver.cpp:1331-1399): faces of reduced cells whose
    # across-cell neighbour is active; reduced mass (Solver.cpp:1406-1482):
    # the lower face always, the upper one where the neighbour is active
    fitM = torch.zeros((R, D, D), dtype=dtype, device=dev)
    fitb = torch.zeros((R, D), dtype=dtype, device=dev)
    mr = torch.zeros((R, D, D), dtype=dtype, device=dev)
    vr = torch.zeros((R, D, D), dtype=dtype, device=dev)
    rho = params.effective_density
    active_cell = is_active(cls.cell_labels)
    inv_dx2 = 1.0 / (grid.dx * grid.dx)
    w_visc = red_cell.to(dtype) * viscosity_c.to(dtype) * inv_dx2
    for a in range(3):
        A = torch.as_tensor(monomial_matrix(a, params.basis), dtype=dtype, device=dev)
        m_lo, m_hi = cell_face_monomials(a, 0), cell_face_monomials(a, 1)
        w_lo = (red_cell & shift(active_cell, unit(a, -1), False)).to(dtype)
        w_hi = (red_cell & shift(active_cell, unit(a, 1), False)).to(dtype)
        u_lo = face_at_cell(velocity[a].to(dtype), a, 0)
        u_hi = face_at_cell(velocity[a].to(dtype), a, 1)
        fitM = fitM + acc.rank1_mono(m_lo, m_lo, w_lo, A, A, "cell")
        fitM = fitM + acc.rank1_mono(m_hi, m_hi, w_hi, A, A, "cell")
        fitb = fitb + acc.vec_mono(m_lo, w_lo * u_lo, A, "cell")
        fitb = fitb + acc.vec_mono(m_hi, w_hi * u_hi, A, "cell")
        mr = mr + acc.rank1_mono(m_lo, m_lo, rho * red_cell.to(dtype), A, A, "cell")
        mr = mr + acc.rank1_mono(m_hi, m_hi, rho * w_hi, A, A, "cell")
        # interior viscosity, cell term: d = c_hi - c_lo = A (m_hi - m_lo)
        dm = [h - l for h, l in zip(m_hi, m_lo)]
        vr = vr + acc.rank1_mono(dm, dm, w_visc, A, A, "cell")

    # edge terms: 0.5 mu_e / dx^2 u u^T over reduced edges, u the signed sum
    # of the 4 surrounding faces' basis rows, [A_p | A_q] [dm_p; dm_q]
    for e in range(3):
        p_ax, q_ax = EDGE_OFFSET_AXES[e]
        eshape = cls.edge_labels[e].shape
        ex, ey, ez = gather_com_xyz(com, cls.edge_region[e])
        epos = [_coord_axis(eshape, 0, dtype, dev) - ex, _coord_axis(eshape, 1, dtype, dev) - ey,
                _coord_axis(eshape, 2, dtype, dev) - ez]
        mono_stack, A_parts = [], []
        for fa, other in ((p_ax, q_ax), (q_ax, p_ax)):
            off = face_offsets(fa)
            up = [epos[i] + off[i] for i in range(3)]
            dn = list(up)
            dn[other] = up[other] - 1.0
            m_up = monomials_xyz(up[0], up[1], up[2], params.basis)
            m_dn = monomials_xyz(dn[0], dn[1], dn[2], params.basis)
            mono_stack.extend([d_ - u_ for d_, u_ in zip(m_dn, m_up)])
            A_parts.append(monomial_matrix(fa, params.basis))
        A_stack = torch.as_tensor(np.concatenate(A_parts, axis=1), dtype=dtype, device=dev)
        w = (cls.edge_labels[e] == REDUCED).to(dtype) * 0.5 * viscosity_e[e].to(dtype) * inv_dx2
        vr = vr + acc.rank1_mono(mono_stack, mono_stack, w, A_stack, A_stack, ("edge", e))

    best_fit = _best_fit(fitM, fitb, valid)
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
# J couplings
# ---------------------------------------------------------------------------

def _face_offset_grids(cls: Classification, com, axis: int, params: SolverParams, T: int, cs):
    """Face position minus the COM of the face's cube's region, per component
    (the cube-major path)."""
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


def _face_monomials_general(cls: Classification, com, axis: int, params: SolverParams):
    """The K monomials at every face of ``axis`` about the COM of the
    face's own region (the segmented path)."""
    dtype = params.dtype
    shape = cls.face_region[axis].shape
    cxyz = gather_com_xyz(com, cls.face_region[axis])
    off = face_offsets(axis)
    return monomials_xyz(*[_coord_axis(shape, i, dtype, com.device) + off[i] - cxyz[i] for i in range(3)],
                         params.basis)


def _reduced_face(cls: Classification, a: int):
    return (cls.face_labels[a] == REDUCED) & (cls.face_region[a] >= 0)


class Coupling:
    """The J couplings of one classification and COM: ``reduce(s)`` is
    y = J x from the face values s = (G Dt) x, [R, D]; ``expand(w)`` the
    rows u = J^T w on reduced faces.  Monomial-factored as in the JAX
    package (C = A m: K monomials per face and a constant [D, K] matrix A
    per axis), cube-major or segmented as ``_use_tiled`` says.

    Everything that depends only on the classification (the reduced-face
    masks, the face monomials, the region sum's order) is built here,
    once, with host reads; ``reduce`` and ``expand`` then launch a fixed
    sequence of device ops, which a CUDA graph replays."""

    def __init__(self, grid: Grid, cls: Classification, com, params: SolverParams, R: int):
        dev = com.device
        self.tiled = _use_tiled(params)
        self.A = [torch.as_tensor(monomial_matrix(a, params.basis), dtype=params.dtype, device=dev) for a in range(3)]
        self.red = [_reduced_face(cls, a) for a in range(3)]
        self.shapes = [cls.face_region[a].shape for a in range(3)]
        if self.tiled:
            self.T = params.tile_size
            self.cs = _cube_dims(grid, self.T)
            self.mono = [torch.stack(monomials_xyz(*_face_offset_grids(cls, com, a, params, self.T, self.cs),
                                                   params.basis)) for a in range(3)]
            self.rsum = RegionSum(cls.region_of_cube, R)
            roc = cls.region_of_cube
            self.cube_region = roc.clamp(0, R - 1).long()
            self.cube_ok = (roc >= 0)[:, None]
        else:
            self.mono = [torch.stack(_face_monomials_general(cls, com, a, params)) for a in range(3)]
            self.ssum = [SegmentSum(torch.where(self.red[a], cls.face_region[a], -1), R) for a in range(3)]
            self.face_region = [cls.face_region[a].clamp(0, R - 1).long() for a in range(3)]

    def reduce(self, s_faces):
        """y = J x: the K moments of the reduced-masked s per axis (per
        cube, or per region), times A^T.  Cube-major, each moment is its
        own block sum, so that the packed path's setup (the right-hand
        side, recovery, REGION_ARROW's probes) rounds as it did before the
        segmented form."""
        y = None
        for a in range(3):
            s = torch.where(self.red[a], s_faces[a], 0.0)
            if self.tiled:
                mu = torch.stack([block_sum(s * m, (a,), self.T, self.cs) for m in self.mono[a]], dim=-1)  # [nc, K]
            else:
                mu = self.ssum[a]((s[None] * self.mono[a]).reshape(self.mono[a].shape[0], -1))  # [R, K]
            y = mu @ self.A[a].T if y is None else y + mu @ self.A[a].T
        return self.rsum(y) if self.tiled else y

    def expand(self, w):
        """u = J^T w on reduced faces: v = w A per region (per cube when
        cube-major), u = sum_k v_k m_k, summed over k in order."""
        out = []
        if self.tiled:
            w = torch.where(self.cube_ok, w[self.cube_region], 0.0)
        for a in range(3):
            v = (w @ self.A[a]).T  # [K, regions or cubes]
            if self.tiled:
                vk = block_broadcast(v, (a,), self.T, self.cs, self.shapes[a])
            else:
                vk = v[:, self.face_region[a]]
            terms = vk * self.mono[a]
            out.append(torch.where(self.red[a], sum(terms[k] for k in range(terms.shape[0])), 0.0))
        return out


def reduce_J(grid: Grid, cls: Classification, com, s_faces, params: SolverParams, R: int):
    """y = J x: basis-weighted reduced face values summed per region."""
    return Coupling(grid, cls, com, params, R).reduce(s_faces)


def expand_J(grid: Grid, cls: Classification, com, w, params: SolverParams):
    """u = J^T w rows on reduced faces (w [R, D])."""
    return Coupling(grid, cls, com, params, w.shape[0]).expand(w)


def viscosity_incl_boundary(grid: Grid, cls: Classification, com, viscosity_c, viscosity_e, params: SolverParams, R: int):
    """Incl-boundary reduced viscosity matrices [R, D, D], as the JAX
    package's: the reference's buildReducedViscosityMatrixSystems variant
    (Solver.cpp:1696-1909), used by no active scheme but part of the
    component surface.

    Unlike the interior-only sweep (gating on the *sample* being strictly
    inside a region), this sweeps reduced FACES: every cell/edge stress
    sample contributes the pairs of its adjacent faces that are reduced.
    The same rank-1 identity applies with per-face gating:

      V_r = sum_cells  (mu_c/dx^2)      u_c u_c^T,
            u_c = c(hi)*chi_hi - c(lo)*chi_lo
          + sum_edges 0.5 (mu_e/dx^2)   u_e u_e^T,
            u_e = sum_{4 faces} sigma_f c(f) * chi_f

    with chi_f = 1[face reduced] (the reference's adjacentInteriorIndex >=
    0 check) and the sample accumulated into the gated faces' region."""
    dtype = params.dtype
    dev = com.device
    D = params.reduced_dof
    inv_dx2 = 1.0 / (grid.dx * grid.dx)
    vr = torch.zeros((R, D, D), dtype=dtype, device=dev)

    def face_red(a):
        return ((cls.face_labels[a] == REDUCED) & (cls.face_region[a] >= 0)).to(dtype)

    def gated(chi, reg):
        return torch.where(chi > 0, reg.to(torch.int32), -1)

    # ---- cell-centered terms
    shape = cls.cell_labels.shape
    for a in range(3):
        A = torch.as_tensor(monomial_matrix(a, params.basis), dtype=dtype, device=dev)
        chi_lo, chi_hi = face_at_cell(face_red(a), a, 0), face_at_cell(face_red(a), a, 1)
        reg_lo, reg_hi = face_at_cell(cls.face_region[a], a, 0), face_at_cell(cls.face_region[a], a, 1)
        # region of the gated faces (they agree when both are reduced); the
        # offsets use its COM
        ids = torch.maximum(gated(chi_lo, reg_lo), gated(chi_hi, reg_hi))
        g = gather_com_xyz(com, ids)
        p = [_coord_axis(shape, i, dtype, dev) - g[i] for i in range(3)]
        p_lo, p_hi = list(p), list(p)
        p_lo[a], p_hi[a] = p[a] - 0.5, p[a] + 0.5
        m_lo = monomials_xyz(*p_lo, params.basis)
        m_hi = monomials_xyz(*p_hi, params.basis)
        dm = torch.stack([h * chi_hi - l * chi_lo for h, l in zip(m_hi, m_lo)], dim=0)
        w = viscosity_c.to(dtype) * inv_dx2 * (ids >= 0).to(dtype)
        C = torch.einsum("dk,k...->d...", A, dm)
        vr = vr + segment_rank1(C, C, w, ids, R)

    # ---- edge-centered terms
    for e in range(3):
        p_ax, q_ax = EDGE_OFFSET_AXES[e]
        eshape = cls.edge_labels[e].shape
        chi, regs = {}, {}
        for fa in (p_ax, q_ax):
            # faces of axis fa around edge g: d=1 -> face index g (the
            # "up"/at-edge position), d=0 -> face index g - e_t ("dn")
            t = 3 - fa - e
            for d in (0, 1):
                before, after = (1, 0) if d == 0 else (0, 1)
                chi[(fa, d)] = pad_axis(face_red(fa), t, before, after, 0)
                regs[(fa, d)] = pad_axis(cls.face_region[fa], t, before, after, -1)
        ids = torch.full(eshape, -1, dtype=torch.int32, device=dev)
        for key, c in chi.items():
            ids = torch.maximum(ids, gated(c, regs[key]))
        g = gather_com_xyz(com, ids)
        pos = [_coord_axis(eshape, i, dtype, dev) - g[i] for i in range(3)]
        mono_stack, A_parts = [], []
        for fa, other in ((p_ax, q_ax), (q_ax, p_ax)):
            off = face_offsets(fa)
            up = [pos[i] + off[i] for i in range(3)]
            dn = list(up)
            dn[other] = up[other] - 1.0
            m_up = monomials_xyz(*up, params.basis)
            m_dn = monomials_xyz(*dn, params.basis)
            mono_stack.extend([d_ * chi[(fa, 0)] - u_ * chi[(fa, 1)] for d_, u_ in zip(m_dn, m_up)])
            A_parts.append(monomial_matrix(fa, params.basis))
        A_stack = torch.as_tensor(np.concatenate(A_parts, axis=1), dtype=dtype, device=dev)
        w = 0.5 * viscosity_e[e].to(dtype) * inv_dx2 * (ids >= 0).to(dtype)
        C = torch.einsum("dk,k...->d...", A_stack, torch.stack(mono_stack, dim=0))
        vr = vr + segment_rank1(C, C, w, ids, R)
    return vr
