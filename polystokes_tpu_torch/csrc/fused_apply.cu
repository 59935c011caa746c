// The four kernels of the fused apply (fuse_pap) and of the uniform apply,
// by hand for Hopper (sm_90a).  Like packed_apply.cu: each launches on the
// caller's stream, allocates nothing and returns cudaGetLastError()
// through a plain C entry point (loaded with ctypes by
// polystokes_tpu_torch/packed_apply.py).  Bounds are HBM bytes at 128^3 in
// f32 (8.39 MB per channel) over 3.35 TB/s; the arithmetic, some 200-300
// flops per slot, is two orders of magnitude below the memory time.
//
// grid_mom_pap_kernel replaces grid_mom_pap_packed (_make_grid_mom_kernel,
//   _forward_s, _transpose_out, _mom_block in polystokes_tpu/pallas_apply.py).
//   In one pass: the grid branch of A x with its mass terms (apply_reduced
//   with u = 0), the per-cube origin moments of the reduced-masked s, and
//   one partial of <x, out_grid> per cube.  Bound: 24 channels read, 7
//   written, about 260 MB, 0.078 ms.  Design: one thread block per cube, as
//   moments_kernel; threads walk the cube's slots z fastest, compute s_a
//   once per slot for both the moments and w at the slot, recompute w at
//   the one-slot neighbours from global memory (L1/L2), and the block sums
//   the 30 moments and the pAp partial (stencil.cuh block_sum).  No
//   atomics: the result does not depend on block order, and the partials
//   are summed outside, as JAX sums its block partials.
//
// finish_kernel replaces finish_packed (_finish_kernel, _transpose_contrib).
//   out = out_grid + [G Dt]^T (-u): the reduced branch, no mass terms (they
//   are in out_grid).  Bound: 17 channels read (c[:7], out_grid, u), 7
//   written, about 201 MB, 0.060 ms.  Design: one thread per slot; w_a =
//   ffw_a (-u_a) at the slot and its neighbours, with the transpose's own
//   ffw factor.  Writes a new array, as JAX does.
//
// apply_uniform_kernel replaces apply_uniform_packed (_apply_kernel_uniform)
//   and, with PAP, apply_uniform_pap_packed (_grid_uniform_pap_kernel).  The
//   uniform A x (apply_reduced without u), and with PAP one partial of
//   <x, A x> per thread block.  Reads channels 0-13 only, so the 14-channel
//   uniform stack and the 17-channel one both work.  Bound: 21 channels
//   read, 7 written, about 235 MB, 0.070 ms.  Design: one thread per slot,
//   the apply_reduced_kernel structure.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace ps {

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_mom_pap_kernel(const T* __restrict__ x, const T* __restrict__ c, T* __restrict__ out, T* __restrict__ mom,
                    T* __restrict__ partials, Dims d, int tile) {
  const int cs1 = d.ny / tile, cs2 = d.nz / tile;
  const int cube = blockIdx.x;
  const int c0 = cube / (cs1 * cs2), c1 = (cube / cs2) % cs1, c2 = cube % cs2;
  const int n = tile * tile * tile;
  auto wf = [&](int a, int ii, int jj, int kk) { return face_w_grid(x, c, a, ii, jj, kk, d); };

  // acc[a*K + m]: moments; acc[3K]: the <x, out_grid> partial
  T acc[3 * K + 1];
#pragma unroll
  for (int m = 0; m < 3 * K + 1; ++m) acc[m] = T(0);

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int li = idx / (tile * tile), lj = (idx / tile) % tile, lk = idx % tile;
    const int i = c0 * tile + li, j = c1 * tile + lj, k = c2 * tile + lk;
    const long long q = d.at(i, j, k);
    T w0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T s = forward_s(x, c, a, i, j, k, d);
      w0[a] = grid_w_from_s(c, a, q, d, s);
      const T chi = __ldg(c + (C_RED + a) * d.plane + q);
      if (chi == T(0)) continue;
      const T sm = s * chi;
      // cube-local face position: +0.5 on the face axis
      T mono[K];
      monomials(T(li) + (a == 0 ? T(0.5) : T(0)), T(lj) + (a == 1 ? T(0.5) : T(0)),
                T(lk) + (a == 2 ? T(0.5) : T(0)), mono);
#pragma unroll
      for (int m = 0; m < K; ++m) acc[a * K + m] += sm * mono[m];
    }
    T o[7];
    transpose_contrib(c, i, j, k, d, w0, wf, o);
    sub_mass_terms(x, c, q, d, o);
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) {
      out[ch * d.plane + q] = o[ch];
      acc[3 * K] += __ldg(x + ch * d.plane + q) * o[ch];
    }
  }

  const T total = block_sum(acc);
  // mom[c0, c1, a*K + k, c2]; partials[cube]
  if (threadIdx.x < 3 * K) mom[((long long)(c0 * cs1 + c1) * (3 * K) + threadIdx.x) * cs2 + c2] = total;
  if (threadIdx.x == 3 * K) partials[cube] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const T* __restrict__ c, const T* __restrict__ out_grid, const T* __restrict__ u, T* __restrict__ out, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d.plane) return;
  const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));

  auto wf = [&](int a, int ii, int jj, int kk) { return face_w_u(c, u, a, ii, jj, kk, d); };
  T w0[3], o[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
  transpose_contrib(c, i, j, k, d, w0, wf, o);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) out[ch * d.plane + q] = __ldg(out_grid + ch * d.plane + q) + o[ch];
}

template <typename T, bool PAP>
__global__ void __launch_bounds__(kThreads)
apply_uniform_kernel(const T* __restrict__ x, const T* __restrict__ c, T* __restrict__ out, T* __restrict__ partials, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T dot[1] = {T(0)};
  if (q < d.plane) {
    const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));
    auto wf = [&](int a, int ii, int jj, int kk) { return face_w_grid(x, c, a, ii, jj, kk, d); };
    T w0[3], o[7];
#pragma unroll
    for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
    transpose_contrib(c, i, j, k, d, w0, wf, o);
    sub_mass_terms(x, c, q, d, o);
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) {
      out[ch * d.plane + q] = o[ch];
      if constexpr (PAP) dot[0] += __ldg(x + ch * d.plane + q) * o[ch];
    }
  }
  if constexpr (PAP) {
    // every thread of the block reaches the sum, in range or not
    const T total = block_sum(dot);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
  }
}

template <typename T>
int grid_mom_pap(const T* x, const T* c, T* out, T* mom, T* partials, int nx, int ny, int nz, int tile, cudaStream_t stream) {
  const unsigned ncubes = (unsigned)((nx / tile) * (ny / tile) * (nz / tile));
  grid_mom_pap_kernel<T><<<ncubes, kThreads, 0, stream>>>(x, c, out, mom, partials, dims(nx, ny, nz), tile);
  return (int)cudaGetLastError();
}

template <typename T>
int finish(const T* c, const T* out_grid, const T* u, T* out, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  finish_kernel<T><<<blocks_for(d.plane), kThreads, 0, stream>>>(c, out_grid, u, out, d);
  return (int)cudaGetLastError();
}

template <typename T, bool PAP>
int apply_uniform(const T* x, const T* c, T* out, T* partials, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  apply_uniform_kernel<T, PAP><<<blocks_for(d.plane), kThreads, 0, stream>>>(x, c, out, partials, d);
  return (int)cudaGetLastError();
}

}  // namespace ps

extern "C" {

int ps_grid_mom_pap_f32(const float* x, const float* c, float* out, float* mom, float* partials, int nx, int ny, int nz, int tile, cudaStream_t s) {
  return ps::grid_mom_pap(x, c, out, mom, partials, nx, ny, nz, tile, s);
}
int ps_grid_mom_pap_f64(const double* x, const double* c, double* out, double* mom, double* partials, int nx, int ny, int nz, int tile, cudaStream_t s) {
  return ps::grid_mom_pap(x, c, out, mom, partials, nx, ny, nz, tile, s);
}
int ps_finish_f32(const float* c, const float* out_grid, const float* u, float* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::finish(c, out_grid, u, out, nx, ny, nz, s);
}
int ps_finish_f64(const double* c, const double* out_grid, const double* u, double* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::finish(c, out_grid, u, out, nx, ny, nz, s);
}
int ps_apply_uniform_f32(const float* x, const float* c, float* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::apply_uniform<float, false>(x, c, out, nullptr, nx, ny, nz, s);
}
int ps_apply_uniform_f64(const double* x, const double* c, double* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::apply_uniform<double, false>(x, c, out, nullptr, nx, ny, nz, s);
}
int ps_apply_uniform_pap_f32(const float* x, const float* c, float* out, float* partials, int nx, int ny, int nz, cudaStream_t s) {
  return ps::apply_uniform<float, true>(x, c, out, partials, nx, ny, nz, s);
}
int ps_apply_uniform_pap_f64(const double* x, const double* c, double* out, double* partials, int nx, int ny, int nz, cudaStream_t s) {
  return ps::apply_uniform<double, true>(x, c, out, partials, nx, ny, nz, s);
}

}  // extern "C"
