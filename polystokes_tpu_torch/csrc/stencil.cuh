// Device functions shared by the packed-apply kernels (packed_apply.cu,
// fused_apply.cu): zero-filled loads in the packed slot layout, the
// forward stencil s_a, the face values w_a the transpose spreads, the
// transpose itself, the quadratic monomials and a thread-block sum.
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

// The face value the transpose spreads: w_a = ffw_a * (-dtMcInv_a * s_a - u_a).
// The transpose carries its own ffw factor (G^T has G's face weight,
// polystokes_tpu/operators.py transpose_from_faces); 0 outside the grid.
template <typename T>
__device__ __forceinline__ T face_w(const T* __restrict__ x, const T* __restrict__ c, const T* __restrict__ u, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const long long q = d.at(i, j, k);
  const T s = forward_s(x, c, a, i, j, k, d);
  const T f = -__ldg(c + (C_DTMCINV + a) * d.plane + q) * s - __ldg(u + a * d.plane + q);
  return __ldg(c + (C_FFW + a) * d.plane + q) * f;
}

// The grid branch's face value w_a = ffw_a * (-dtMcInv_a * s_a): face_w
// without u, from s_a at the slot.
template <typename T>
__device__ __forceinline__ T grid_w_from_s(const T* __restrict__ c, int a, long long q, const Dims& d, T s) {
  return __ldg(c + (C_FFW + a) * d.plane + q) * (-__ldg(c + (C_DTMCINV + a) * d.plane + q) * s);
}

template <typename T>
__device__ __forceinline__ T face_w_grid(const T* __restrict__ x, const T* __restrict__ c, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  return grid_w_from_s(c, a, d.at(i, j, k), d, forward_s(x, c, a, i, j, k, d));
}

// The reduced branch's face value w_a = ffw_a * (-u_a) (_transpose_contrib
// of polystokes_tpu/pallas_apply.py on w = -u, its own ffw factor kept:
// dropping it is wrong at solid-cut faces).
template <typename T>
__device__ __forceinline__ T face_w_u(const T* __restrict__ c, const T* __restrict__ u, int a, int i, int j, int k, const Dims& d) {
  if (!d.inside(i, j, k)) return T(0);
  const long long q = d.at(i, j, k);
  return __ldg(c + (C_FFW + a) * d.plane + q) * -__ldg(u + a * d.plane + q);
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

template <typename T>
__device__ __forceinline__ void monomials(T px, T py, T pz, T m[K]) {
  m[0] = T(1);
  m[1] = px;
  m[2] = py;
  m[3] = pz;
  m[4] = px * px;
  m[5] = px * py;
  m[6] = px * pz;
  m[7] = py * py;
  m[8] = py * pz;
  m[9] = pz * pz;
}

// Sums each of the N per-thread values acc[m] over the thread block (warp
// shuffles, then one shared-memory row per warp); thread m < N returns the
// block's total of value m, the others 0.  A fixed order: no atomics.
template <typename T, int N>
__device__ __forceinline__ T block_sum(const T (&acc)[N]) {
  __shared__ T part[kThreads / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    T v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][m] = v;
  }
  __syncthreads();
  T v = T(0);
  if (threadIdx.x < N) {
    for (int w = 0; w < kThreads / 32; ++w) v += part[w][threadIdx.x];
  }
  return v;
}

inline Dims dims(int nx, int ny, int nz) { return Dims{nx, ny, nz, (long long)nx * ny * nz}; }

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace ps
