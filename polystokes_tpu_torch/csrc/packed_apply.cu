// The three packed-apply kernels of the reduced Stokes operator, by hand
// for Hopper (sm_90a).  Each launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() through a plain C entry point
// (loaded with ctypes by polystokes_tpu_torch/packed_apply.py).
//
// moments_kernel replaces moments_packed (_make_moments_kernel, _forward_s,
//   _mom_block in polystokes_tpu/pallas_apply.py).  Per-cube monomial
//   moments, about the cube origin, of the reduced-masked forward values
//   s_a.  Bound: memory; it reads 17 channels once (about 143 MB at 128^3
//   in f32).  Design: one thread block per cube, each thread walks slots of
//   the cube with z fastest (coalesced), keeps the 3K sums in registers and
//   the block reduces them by warp shuffles and shared memory.  Nothing
//   crosses blocks, so there are no atomics and the result does not depend
//   on the order the blocks run in; this takes the place of the TPU's
//   partial-cube accumulation across sequential grid steps.
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
//   cube's 10 coefficients once and folds them into A + B z + C z^2 along
//   the row (stencil.cuh row_poly, which expand_at and so
//   exp_finish_update_kernel evaluate at one slot); a run with no reduced
//   face loads no coefficient.
//
// apply_reduced_kernel replaces apply_reduced_packed (_apply_reduced_kernel,
//   _transpose_out).  The full reduced A x given the expanded u: 7 outputs
//   per slot from w_a = ffw_a (-dtMcInv_a s_a - u_a) at the slot and at
//   one-slot neighbours (stencil.cuh transpose_contrib).  Bound: memory at
//   the roofline (24 channels read, 7 written, about 260 MB at 128^3), but
//   this first version recomputes w at the neighbours straight from global
//   memory: 12 w evaluations per slot, each reading some 17 values, served
//   mostly by L1/L2.  Staging w for a tile plus a one-slot halo in shared
//   memory is the known next step.
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace ps {

template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, const T* __restrict__ c, T* __restrict__ mom, Dims d, int tile) {
  const int cs1 = d.ny / tile, cs2 = d.nz / tile;
  const int cube = blockIdx.x;
  const int c0 = cube / (cs1 * cs2), c1 = (cube / cs2) % cs1, c2 = cube % cs2;
  const int n = tile * tile * tile;

  T acc[3 * K];
#pragma unroll
  for (int m = 0; m < 3 * K; ++m) acc[m] = T(0);

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int li = idx / (tile * tile), lj = (idx / tile) % tile, lk = idx % tile;
    const int i = c0 * tile + li, j = c1 * tile + lj, k = c2 * tile + lk;
    const long long q = d.at(i, j, k);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T chi = __ldg(c + (C_RED + a) * d.plane + q);
      if (chi == T(0)) continue;
      const T sm = forward_s(x, c, a, i, j, k, d) * chi;
      // cube-local face position: +0.5 on the face axis
      T mono[K];
      monomials(T(li) + (a == 0 ? T(0.5) : T(0)), T(lj) + (a == 1 ? T(0.5) : T(0)),
                T(lk) + (a == 2 ? T(0.5) : T(0)), mono);
#pragma unroll
      for (int m = 0; m < K; ++m) acc[a * K + m] += sm * mono[m];
    }
  }

  const T total = block_sum(acc);
  // mom[c0, c1, a*K + k, c2]
  if (threadIdx.x < 3 * K) mom[((long long)(c0 * cs1 + c1) * (3 * K) + threadIdx.x) * cs2 + c2] = total;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const T* __restrict__ v, const T* __restrict__ red, T* __restrict__ u, Dims d, int tile) {
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
    const V chi = *reinterpret_cast<const V*>(red + a * d.plane + q);
    bool any = false;
#pragma unroll
    for (int s = 0; s < VEC; ++s) any = any || chi.v[s] != T(0);
    V res;
    if (!any) {
#pragma unroll
      for (int s = 0; s < VEC; ++s) res.v[s] = T(0);
    } else {
      // p cube-local, +0.5 on the face axis
      const RowPoly<T> poly = row_poly(vc + a * K * cs2, cs2, T(i - c0 * tile) + (a == 0 ? T(0.5) : T(0)),
                                       T(j - c1 * tile) + (a == 1 ? T(0.5) : T(0)));
      const T pz0 = T(k0 - c2 * tile) + (a == 2 ? T(0.5) : T(0));
#pragma unroll
      for (int s = 0; s < VEC; ++s) res.v[s] = chi.v[s] == T(0) ? T(0) : poly.at(pz0 + T(s)) * chi.v[s];
    }
    *reinterpret_cast<V*>(u + a * d.plane + q) = res;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_reduced_kernel(const T* __restrict__ x, const T* __restrict__ c, const T* __restrict__ u, T* __restrict__ out, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d.plane) return;
  const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));

  auto wf = [&](int a, int ii, int jj, int kk) { return face_w(x, c, u, a, ii, jj, kk, d); };
  T w0[3], o[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
  transpose_contrib(c, i, j, k, d, w0, wf, o);
  sub_mass_terms(x, c, q, d, o);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) out[ch * d.plane + q] = o[ch];
}

template <typename T>
int moments(const T* x, const T* c, T* mom, int nx, int ny, int nz, int tile, cudaStream_t stream) {
  const unsigned ncubes = (unsigned)((nx / tile) * (ny / tile) * (nz / tile));
  moments_kernel<T><<<ncubes, kThreads, 0, stream>>>(x, c, mom, dims(nx, ny, nz), tile);
  return (int)cudaGetLastError();
}

// VEC slots a thread of the vector path: 16 bytes
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
int expand(const T* v, const T* red, T* u, int nx, int ny, int nz, int tile, int vec, int bx, int by, cudaStream_t stream) {
  if ((vec != 1 && vec != kVec<T>) || nz % vec || tile % vec || bx < 1 || by < 1 || bx * by > kThreads ||
      (vec > 1 && (reinterpret_cast<uintptr_t>(red) | reinterpret_cast<uintptr_t>(u)) % 16))
    return (int)cudaErrorInvalidValue;
  const int nzv = nz / vec;
  const dim3 grid((unsigned)((nzv + bx - 1) / bx), (unsigned)((ny + by - 1) / by), (unsigned)nx);
  const Dims d = dims(nx, ny, nz);
  if (vec == 1)
    expand_kernel<T, 1><<<grid, dim3(bx, by), 0, stream>>>(v, red, u, d, tile);
  else
    expand_kernel<T, kVec<T>><<<grid, dim3(bx, by), 0, stream>>>(v, red, u, d, tile);
  return (int)cudaGetLastError();
}

template <typename T>
int apply_reduced(const T* x, const T* c, const T* u, T* out, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  apply_reduced_kernel<T><<<blocks_for(d.plane), kThreads, 0, stream>>>(x, c, u, out, d);
  return (int)cudaGetLastError();
}

}  // namespace ps

extern "C" {

int ps_moments_f32(const float* x, const float* c, float* mom, int nx, int ny, int nz, int tile, cudaStream_t s) {
  return ps::moments(x, c, mom, nx, ny, nz, tile, s);
}
int ps_moments_f64(const double* x, const double* c, double* mom, int nx, int ny, int nz, int tile, cudaStream_t s) {
  return ps::moments(x, c, mom, nx, ny, nz, tile, s);
}
int ps_expand_f32(const float* v, const float* red, float* u, int nx, int ny, int nz, int tile, int vec, int bx, int by,
                  cudaStream_t s) {
  return ps::expand(v, red, u, nx, ny, nz, tile, vec, bx, by, s);
}
int ps_expand_f64(const double* v, const double* red, double* u, int nx, int ny, int nz, int tile, int vec, int bx, int by,
                  cudaStream_t s) {
  return ps::expand(v, red, u, nx, ny, nz, tile, vec, bx, by, s);
}
int ps_apply_reduced_f32(const float* x, const float* c, const float* u, float* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::apply_reduced(x, c, u, out, nx, ny, nz, s);
}
int ps_apply_reduced_f64(const double* x, const double* c, const double* u, double* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::apply_reduced(x, c, u, out, nx, ny, nz, s);
}

}  // extern "C"
