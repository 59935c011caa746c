// The transpose [G Dt]^T of face values u alone, and the forward and combine
// halves of the reduced apply, by hand for Hopper (sm_90a).  Like
// packed_apply.cu: each launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() through a plain C entry point (loaded with
// ctypes by polystokes_tpu_torch/packed_apply.py).  Bounds are HBM bytes at
// 128^3 in f32 (8.39 MB per channel) over 3.35 TB/s; the arithmetic, 40-90
// flops per slot, is far below the memory time.  Each reads only channels
// 0-13 of the coefficient stack, so the 14- and 17-channel stacks both work.
//
// transpose_u_kernel replaces transpose_u_packed (_transpose_u_kernel,
//   _transpose_contrib in polystokes_tpu/pallas_apply.py).  out = [G Dt]^T u:
//   +u (finish_kernel spreads -u), no mass terms, no grid branch: the
//   transpose leg of the REGION_ARROW solve, once per CG iteration.  Bound:
//   10 channels read (c[:7], u), 7 written, about 143 MB, 0.043 ms.  Design:
//   finish_kernel's, one thread per slot; w_a = ffw_a u_a at the slot and its
//   neighbours, with the transpose's own ffw factor.
//
// forward_s_kernel replaces forward_s_packed (_forward_kernel, _forward_s).
//   s = [G Dt] x on the faces of all three axes.  Bound: 14 channels read
//   (x, c[:7]), 3 written, about 143 MB, 0.043 ms.  Design: one thread per
//   slot, stencil.cuh forward_s for each axis.
//
// combine_kernel replaces combine_packed (_combine_kernel, _transpose_out).
//   The second half of apply_reduced from a stored s: w_a = ffw_a
//   (-dtMcInv_a s_a - u_a) at the slot and its neighbours, the transpose and
//   the mass terms.  Bound: 26 channels read (x[1:7], c[:14], s, u), 7
//   written, about 277 MB, 0.083 ms.  Design: one thread per slot;
//   combine(x, forward_s(x), u) agrees with apply_reduced(x, u), a plane
//   window in fused_apply.cu, to round-off.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace ps {

template <typename T>
__global__ void __launch_bounds__(kThreads)
transpose_u_kernel(const T* __restrict__ c, const T* __restrict__ u, T* __restrict__ out, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d.plane) return;
  const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));

  auto wf = [&](int a, int ii, int jj, int kk) { return face_w_u(c, u, T(1), a, ii, jj, kk, d); };
  T w0[3], o[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
  transpose_contrib(c, i, j, k, d, w0, wf, o);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) out[ch * d.plane + q] = o[ch];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
forward_s_kernel(const T* __restrict__ x, const T* __restrict__ c, T* __restrict__ s, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d.plane) return;
  const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));
#pragma unroll
  for (int a = 0; a < 3; ++a) s[a * d.plane + q] = forward_s(x, c, a, i, j, k, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ x, const T* __restrict__ c, const T* __restrict__ s, const T* __restrict__ u,
               T* __restrict__ out, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d.plane) return;
  const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));

  auto wf = [&](int a, int ii, int jj, int kk) { return face_w_stored(c, s, u, a, ii, jj, kk, d); };
  T w0[3], o[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
  transpose_contrib(c, i, j, k, d, w0, wf, o);
  sub_mass_terms(x, c, q, d, o);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) out[ch * d.plane + q] = o[ch];
}

template <typename T>
int transpose_u(const T* c, const T* u, T* out, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  transpose_u_kernel<T><<<blocks_for(d.plane), kThreads, 0, stream>>>(c, u, out, d);
  return (int)cudaGetLastError();
}

template <typename T>
int forward_s_pass(const T* x, const T* c, T* s, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  forward_s_kernel<T><<<blocks_for(d.plane), kThreads, 0, stream>>>(x, c, s, d);
  return (int)cudaGetLastError();
}

template <typename T>
int combine(const T* x, const T* c, const T* s, const T* u, T* out, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  combine_kernel<T><<<blocks_for(d.plane), kThreads, 0, stream>>>(x, c, s, u, out, d);
  return (int)cudaGetLastError();
}

}  // namespace ps

extern "C" {

int ps_transpose_u_f32(const float* c, const float* u, float* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::transpose_u(c, u, out, nx, ny, nz, s);
}
int ps_transpose_u_f64(const double* c, const double* u, double* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::transpose_u(c, u, out, nx, ny, nz, s);
}
int ps_forward_s_f32(const float* x, const float* c, float* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::forward_s_pass(x, c, out, nx, ny, nz, s);
}
int ps_forward_s_f64(const double* x, const double* c, double* out, int nx, int ny, int nz, cudaStream_t s) {
  return ps::forward_s_pass(x, c, out, nx, ny, nz, s);
}
int ps_combine_f32(const float* x, const float* c, const float* sv, const float* u, float* out, int nx, int ny, int nz,
                   cudaStream_t s) {
  return ps::combine(x, c, sv, u, out, nx, ny, nz, s);
}
int ps_combine_f64(const double* x, const double* c, const double* sv, const double* u, double* out, int nx, int ny,
                   int nz, cudaStream_t s) {
  return ps::combine(x, c, sv, u, out, nx, ny, nz, s);
}

}  // extern "C"
