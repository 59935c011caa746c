// The expand kernel of the reduced apply, by hand for Hopper (sm_90a).  It
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() through a plain C entry point (loaded with ctypes by
// polystokes_tpu_torch/packed_apply.py).  The moments and the reduced A x,
// the other two kernels of the unfused apply, march the plane window of
// fused_apply.cu (WINDOW_MOM, WINDOW_REDUCED).
//
// expand_kernel replaces expand_packed (_make_expand_kernel).  Evaluates
//   the region polynomials on reduced faces, u_a = chi_a sum_k v[cube, aK+k]
//   m_k(p - origin).  Bound: memory, an elementwise pass (3 channels read,
//   3 written; the small v array stays in cache).  Design: a 3-D grid over
//   (z runs, rows y, planes x), so a thread's indices come from blockIdx
//   and threadIdx without a 64-bit division; each thread takes a run of
//   VEC consecutive z slots in one cube (16-byte loads of chi and stores
//   of u, chosen by packed_apply.py expand_plan, one slot where nz, the tile
//   or the alignment forbid), for all three axes.  Per axis it loads the
//   cube's K coefficients once and folds them into A + B z + C z^2 along
//   the row (stencil.cuh row_poly, which expand_at and so
//   exp_finish_update_kernel evaluate at one slot); a run with no reduced
//   face loads no coefficient.  Templated on K: 10 for the quadratic basis,
//   4 for the affine one (A + B z, 12 coefficients a cube instead of 30),
//   and on C, the masks' storage type: T, or bf16 under coeff_bf16, whose
//   VEC masks of a run are VEC * 2 bytes (8 in f32, 4 in f64) read as one
//   access aligned to that width (checked at launch beside u's 16 bytes).
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace ps {

template <typename T, int VEC, int K, typename C>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const T* __restrict__ v, const C* __restrict__ red, T* __restrict__ u, Dims d, int tile) {
  // thread: VEC consecutive z slots k0.. of row (i, j), all in one cube
  // (VEC divides tile); every axis
  const int k0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int j = blockIdx.y * blockDim.y + threadIdx.y, i = blockIdx.z;
  if (k0 >= d.nz || j >= d.ny) return;
  const int cs1 = d.ny / tile, cs2 = d.nz / tile;
  const int c0 = i / tile, c1 = j / tile, c2 = k0 / tile;
  const long long q = d.at(i, j, k0);
  // v[c0, c1, a*K + m, c2]
  const T* vc = v + (long long)(c0 * cs1 + c1) * (3 * K) * cs2 + c2;
  using V = Vec<T, VEC>;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const Vec<C, VEC> stored = *reinterpret_cast<const Vec<C, VEC>*>(red + a * d.plane + q);
    V chi;
#pragma unroll
    for (int s = 0; s < VEC; ++s) chi.v[s] = to_t<T>(stored.v[s]);
    bool any = false;
#pragma unroll
    for (int s = 0; s < VEC; ++s) any = any || chi.v[s] != T(0);
    V res;
    if (!any) {
#pragma unroll
      for (int s = 0; s < VEC; ++s) res.v[s] = T(0);
    } else {
      // p cube-local, +0.5 on the face axis
      const RowPoly<T, K> poly = row_poly<T, K>(vc + a * K * cs2, cs2, T(i - c0 * tile) + (a == 0 ? T(0.5) : T(0)),
                                                T(j - c1 * tile) + (a == 1 ? T(0.5) : T(0)));
      const T pz0 = T(k0 - c2 * tile) + (a == 2 ? T(0.5) : T(0));
#pragma unroll
      for (int s = 0; s < VEC; ++s) res.v[s] = chi.v[s] == T(0) ? T(0) : poly.at(pz0 + T(s)) * chi.v[s];
    }
    *reinterpret_cast<V*>(u + a * d.plane + q) = res;
  }
}

// VEC slots a thread of the vector path: 16 bytes
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T, int K, typename C>
int expand(const T* v, const C* red, T* u, int nx, int ny, int nz, int tile, int vec, int bx, int by, cudaStream_t stream) {
  if ((vec != 1 && vec != kVec<T>) || nz % vec || tile % vec || bx < 1 || by < 1 || bx * by > kThreads ||
      (vec > 1 && (reinterpret_cast<uintptr_t>(red) % (sizeof(C) * vec) || reinterpret_cast<uintptr_t>(u) % 16)))
    return (int)cudaErrorInvalidValue;
  const int nzv = nz / vec;
  const dim3 grid((unsigned)((nzv + bx - 1) / bx), (unsigned)((ny + by - 1) / by), (unsigned)nx);
  const Dims d = dims(nx, ny, nz);
  if (vec == 1)
    expand_kernel<T, 1, K, C><<<grid, dim3(bx, by), 0, stream>>>(v, red, u, d, tile);
  else
    expand_kernel<T, kVec<T>, K, C><<<grid, dim3(bx, by), 0, stream>>>(v, red, u, d, tile);
  return (int)cudaGetLastError();
}

}  // namespace ps

extern "C" {

// ps_expand_k10_* (the quadratic basis) and ps_expand_k4_* (the affine
// one), the masks stored in T or (suffix _bf16) in bf16
#define PS_EXPAND(K, TAG, T, C) \
  int ps_expand_k##K##_##TAG(const T* v, const C* red, T* u, int nx, int ny, int nz, int tile, int vec, int bx, int by, \
                             cudaStream_t s) { \
    return ps::expand<T, K, C>(v, red, u, nx, ny, nz, tile, vec, bx, by, s); \
  }
PS_EXPAND(10, f32, float, float)
PS_EXPAND(10, f64, double, double)
PS_EXPAND(4, f32, float, float)
PS_EXPAND(4, f64, double, double)
PS_EXPAND(10, f32_bf16, float, ps::bf16)
PS_EXPAND(10, f64_bf16, double, ps::bf16)
PS_EXPAND(4, f32_bf16, float, ps::bf16)
PS_EXPAND(4, f64_bf16, double, ps::bf16)
#undef PS_EXPAND

}  // extern "C"
