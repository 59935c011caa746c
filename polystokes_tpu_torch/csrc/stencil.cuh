// Device functions shared by the packed-apply kernels (packed_apply.cu,
// fused_apply.cu, transpose_apply.cu, update_apply.cu): zero-filled loads in
// the packed slot layout, the forward stencil s_a, the face values w_a the
// transpose spreads, the transpose itself, the region polynomial over the
// quadratic monomials (along a row and at a slot), the pointwise
// preconditioners and thread-block sums.
//
// Packed layout (see polystokes_tpu_torch/packed_apply.py): every field is
// a channel of a contiguous [C, nx, ny, nz] array, z fastest.  Solve
// vector x: 0 p | 1-3 tau_aa | 4-6 tau_e.  Coefficients: 0 clw | 1-3 elw_e
// | 4-6 ffw_a | 7-9 dt*McInv_a | 10 0.5*uInv_c | 11-13 0.5*uInv_e | 14-16
// reduced-face masks.  Face a slot i is natural face i + e_a, edge e slot j
// is natural edge j + e_p + e_q: the index-0 planes are dropped, which is
// exact while no face or edge on them is active.
//
// Out-of-range neighbours read as 0.  That is the zero halo the TPU
// kernels pad on x and y and the zero fill of their z shifts
// (polystokes_tpu/pallas_apply.py _pad_halo, _shift_z), so no padded
// copy of any array is made here.
#pragma once

#include <cuda_runtime.h>

namespace ps {

constexpr int kThreads = 256;  // threads per block of every kernel

enum : int {
  C_CLW = 0,
  C_ELW = 1,
  C_FFW = 4,
  C_DTMCINV = 7,
  C_UINV2C = 10,
  C_UINV2E = 11,
  C_RED = 14,
};

// quadratic monomials [1, x, y, z, x^2, xy, xz, y^2, yz, z^2]
constexpr int K = 10;

struct Dims {
  int nx, ny, nz;
  long long plane;  // nx * ny * nz, the channel stride

  __device__ __forceinline__ bool inside(int i, int j, int k) const {
    return i >= 0 && j >= 0 && k >= 0 && i < nx && j < ny && k < nz;
  }
  __device__ __forceinline__ long long at(int i, int j, int k) const {
    return ((long long)i * ny + j) * nz + k;
  }
};

// g_a = clw * (p - tau_aa) at (i, j, k)
template <typename T>
__device__ __forceinline__ T cell_g(const T* __restrict__ x, const T* __restrict__ c, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const long long q = d.at(i, j, k);
  return __ldg(c + C_CLW * d.plane + q) * (__ldg(x + q) - __ldg(x + (1 + a) * d.plane + q));
}

// h_e = elw_e * tau_e at (i, j, k)
template <typename T>
__device__ __forceinline__ T edge_h(const T* __restrict__ x, const T* __restrict__ c, int e, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const long long q = d.at(i, j, k);
  return __ldg(c + (C_ELW + e) * d.plane + q) * __ldg(x + (4 + e) * d.plane + q);
}

// s_a = ffw_a * (g_a[q + e_a] - g_a[q] + sum_{e != a} (h_e[q - e_t] - h_e[q])),
// t = 3 - a - e: _forward_s of polystokes_tpu/pallas_apply.py in slot space.
template <typename T>
__device__ __forceinline__ T forward_s(const T* __restrict__ x, const T* __restrict__ c, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const int ia = i + (a == 0), ja = j + (a == 1), ka = k + (a == 2);
  const T g0 = cell_g(x, c, a, i, j, k, d);
  T v = cell_g(x, c, a, ia, ja, ka, d) - g0;
  for (int e = 0; e < 3; ++e) {
    if (e == a) continue;
    const int t = 3 - a - e;
    const T hm = edge_h(x, c, e, i - (t == 0), j - (t == 1), k - (t == 2), d);
    v = v + hm - edge_h(x, c, e, i, j, k, d);
  }
  return __ldg(c + (C_FFW + a) * d.plane + d.at(i, j, k)) * v;
}

// The face value the transpose spreads: w_a = ffw_a * (-dtMcInv_a * s_a - u_a)
// from s_a and u_a at slot q.  The transpose carries its own ffw factor (G^T
// has G's face weight, polystokes_tpu/operators.py transpose_from_faces).
template <typename T>
__device__ __forceinline__ T w_from_s_u(const T* __restrict__ c, int a, long long q, const Dims& d, T s, T u) {
  const T f = -__ldg(c + (C_DTMCINV + a) * d.plane + q) * s - u;
  return __ldg(c + (C_FFW + a) * d.plane + q) * f;
}

// w_a with s_a read from a stored forward pass (combine_kernel); 0 outside
// the grid.
template <typename T>
__device__ __forceinline__ T face_w_stored(const T* __restrict__ c, const T* __restrict__ s, const T* __restrict__ u, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const long long q = d.at(i, j, k);
  return w_from_s_u(c, a, q, d, __ldg(s + a * d.plane + q), __ldg(u + a * d.plane + q));
}

// The grid branch's face value w_a = ffw_a * (-dtMcInv_a * s_a): w_from_s_u
// without u.
template <typename T>
__device__ __forceinline__ T grid_w_from_s(const T* __restrict__ c, int a, long long q, const Dims& d, T s) {
  return __ldg(c + (C_FFW + a) * d.plane + q) * (-__ldg(c + (C_DTMCINV + a) * d.plane + q) * s);
}

// The face value w_a = ffw_a * (sign * u_a) of u alone (_transpose_contrib
// of polystokes_tpu/pallas_apply.py, its own ffw factor kept: dropping it is
// wrong at solid-cut faces).  sign -1: the apply's reduced branch -u
// (finish); +1: the REGION_ARROW solve's transpose of u (transpose_u).
template <typename T>
__device__ __forceinline__ T face_w_u(const T* __restrict__ c, const T* __restrict__ u, T sign, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const long long q = d.at(i, j, k);
  return __ldg(c + (C_FFW + a) * d.plane + q) * (sign * __ldg(u + a * d.plane + q));
}

// The 7 outputs of the transpose [G Dt]^T at slot (i, j, k), without mass
// terms: w0[a] is w_a at the slot and wf(a, i, j, k) w_a anywhere (0
// outside the grid).  With t = 3 - a - e:
//   o[0]   = clw sum_a (w_a[q - e_a] - w_a[q])
//   o[1+a] = -clw (w_a[q - e_a] - w_a[q])
//   o[4+e] = elw_e sum_{a != e} (w_a[q + e_t] - w_a[q])
template <typename T, typename WF>
__device__ __forceinline__ void transpose_contrib(const T* __restrict__ c, int i, int j, int k, const Dims& d, const T w0[3], const WF& wf, T o[7]) {
  const long long q = d.at(i, j, k);
  const T clw = __ldg(c + C_CLW * d.plane + q);
  T p_acc = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T dd = wf(a, i - (a == 0), j - (a == 1), k - (a == 2)) - w0[a];
    p_acc = (a == 0) ? dd : p_acc + dd;
    o[1 + a] = -clw * dd;
  }
  o[0] = clw * p_acc;
  // edge e collects w_a(q + e_t) - w_a(q) over its two offset axes a
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int pa = (e == 0) ? 1 : 0, qa = (e == 2) ? 1 : 2;
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int a = s == 0 ? pa : qa;
      const int t = 3 - a - e;
      const T dv = wf(a, i + (t == 0), j + (t == 1), k + (t == 2)) - w0[a];
      acc = (s == 0) ? dv : acc + dv;
    }
    o[4 + e] = __ldg(c + (C_ELW + e) * d.plane + q) * acc;
  }
}

// The uInv mass terms: o[1+a] -= 0.5 uInv_c x[1+a], o[4+e] -= 0.5 uInv_e x[4+e].
template <typename T>
__device__ __forceinline__ void sub_mass_terms(const T* __restrict__ x, const T* __restrict__ c, long long q, const Dims& d, T o[7]) {
  const T uinv2c = __ldg(c + C_UINV2C * d.plane + q);
#pragma unroll
  for (int a = 0; a < 3; ++a) o[1 + a] = o[1 + a] - uinv2c * __ldg(x + (1 + a) * d.plane + q);
#pragma unroll
  for (int e = 0; e < 3; ++e) o[4 + e] = o[4 + e] - __ldg(c + (C_UINV2E + e) * d.plane + q) * __ldg(x + (4 + e) * d.plane + q);
}

// The region polynomial sum_m v_m m_m(px, py, pz) of one cube and axis
// along a row of fixed (px, py), cube-local face positions: A + B pz + C
// pz^2, evaluated by Horner.  vc points at v[c0, c1, aK, c2] of the [cs0,
// cs1, 3K, cs2] coefficients, whose monomials lie cs2 apart.
template <typename T>
struct RowPoly {
  T a, b, c;
  __device__ __forceinline__ T at(T pz) const { return a + pz * (b + pz * c); }
};

template <typename T>
__device__ __forceinline__ RowPoly<T> row_poly(const T* __restrict__ vc, int cs2, T px, T py) {
  T m[K];
#pragma unroll
  for (int n = 0; n < K; ++n) m[n] = __ldg(vc + (long long)n * cs2);
  return {m[0] + m[1] * px + m[2] * py + m[4] * (px * px) + m[5] * (px * py) + m[7] * (py * py),
          m[3] + m[6] * px + m[8] * py, m[9]};
}

// The region polynomial on face a at slot (i, j, k): u_a = chi_a sum_m
// v[cube, aK + m] m_m(p - origin), in the slot's own cube (expand_packed of
// polystokes_tpu/pallas_apply.py), p cube-local with +0.5 on the face axis.
// v is [cs0, cs1, 3K, cs2]; red the [3, nx, ny, nz] reduced-face masks.  0
// off the reduced faces and outside the grid, where v is not read.
template <typename T>
__device__ __forceinline__ T expand_at(const T* __restrict__ v, const T* __restrict__ red, int a, int i, int j, int k, int tile, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const T chi = __ldg(red + a * d.plane + d.at(i, j, k));
  if (chi == T(0)) return T(0);
  const int cs1 = d.ny / tile, cs2 = d.nz / tile;
  const int c0 = i / tile, c1 = j / tile, c2 = k / tile;
  const T* vc = v + ((long long)(c0 * cs1 + c1) * (3 * K) + a * K) * cs2 + c2;
  const RowPoly<T> poly = row_poly(vc, cs2, T(i - c0 * tile) + (a == 0 ? T(0.5) : T(0)),
                                   T(j - c1 * tile) + (a == 1 ? T(0.5) : T(0)));
  return poly.at(T(k - c2 * tile) + (a == 2 ? T(0.5) : T(0))) * chi;
}

// The reduced branch's face value w_a = ffw_a * (-u_a) with u_a expanded
// from v in place: face_w_u(c, u, -1, ...) without the stored u.  Each
// neighbour evaluates the polynomial of its own cube, so a stencil that
// crosses a cube face needs no window decomposition.
template <typename T>
__device__ __forceinline__ T face_w_v(const T* __restrict__ c, const T* __restrict__ v, int a, int i, int j, int k, int tile, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const T u = expand_at(v, c + C_RED * d.plane, a, i, j, k, tile, d);
  return __ldg(c + (C_FFW + a) * d.plane + d.at(i, j, k)) * (-u);
}

// The pointwise packed preconditioners z = M^-1 r at slot q: KIND_NONE the
// identity, KIND_DIAG the Jacobi inverse (f: [7, nx, ny, nz]), KIND_ARROW
// the closed-form CELL_ARROW inverse (f: the [13, nx, ny, nz] stack of
// pack_arrow_factors, channels 0-2 kd, 3 inv_schur, 4-6 k, 7-9 inv_d,
// 10-12 te_inv).  One copy of the arrow formula for every update kernel
// (_make_cg_update_kernel of polystokes_tpu/pallas_apply.py).
enum : int { KIND_NONE = 0, KIND_DIAG = 1, KIND_ARROW = 2 };
enum : int { ARROW_KD = 0, ARROW_SCHUR = 3, ARROW_K = 4, ARROW_INVD = 7, ARROW_TEINV = 10 };

template <typename T, int KIND>
__device__ __forceinline__ void precond_z(const T* __restrict__ f, long long q, const Dims& d, const T r[7], T z[7]) {
  if constexpr (KIND == KIND_NONE) {
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) z[ch] = r[ch];
  } else if constexpr (KIND == KIND_DIAG) {
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) z[ch] = __ldg(f + ch * d.plane + q) * r[ch];
  } else {
    T s = __ldg(f + ARROW_KD * d.plane + q) * r[1];
#pragma unroll
    for (int a = 1; a < 3; ++a) s = s + __ldg(f + (ARROW_KD + a) * d.plane + q) * r[1 + a];
    const T zp = (r[0] + s) * __ldg(f + ARROW_SCHUR * d.plane + q);
    z[0] = zp;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      z[1 + a] = (r[1 + a] + __ldg(f + (ARROW_K + a) * d.plane + q) * zp) * __ldg(f + (ARROW_INVD + a) * d.plane + q);
#pragma unroll
    for (int e = 0; e < 3; ++e) z[4 + e] = r[4 + e] * __ldg(f + (ARROW_TEINV + e) * d.plane + q);
  }
}

// Sums each of the N per-thread values acc[m] over the threads of a block
// of at most kThreads in x and y, tid = threadIdx.x + threadIdx.y *
// blockDim.x (warp shuffles, then the warps' rows in order; a last warp
// may be partial).  Every thread of the block must call it.  Returns the
// shared array of the N totals, which every thread may read.  A fixed
// order: no atomics.
template <typename T, int N>
__device__ __forceinline__ const T* block_sums(const T (&acc)[N]) {
  __shared__ T part[kThreads / 32][N];
  __shared__ T total[N];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthreads + 31) >> 5;
  const int live = min(32, nthreads - 32 * warp);
  const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    T v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_down_sync(mask, v, off);
      if (lane + off < live) v += o;
    }
    if (lane == 0) part[warp][m] = v;
  }
  __syncthreads();
  for (int m = tid; m < N; m += nthreads) {
    T v = T(0);
    for (int w = 0; w < nwarps; ++w) v += part[w][m];
    total[m] = v;
  }
  __syncthreads();
  return total;
}

// block_sums over a one-dimensional block: thread m < N returns the
// block's total of value m, the others 0.
template <typename T, int N>
__device__ __forceinline__ T block_sum(const T (&acc)[N]) {
  const T* total = block_sums(acc);
  return threadIdx.x < N ? total[threadIdx.x] : T(0);
}

// N consecutive values of one 16-byte (or smaller) aligned access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

inline Dims dims(int nx, int ny, int nz) { return Dims{nx, ny, nz, (long long)nx * ny * nz}; }

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace ps
