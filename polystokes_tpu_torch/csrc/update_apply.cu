// The fused CG update of fuse_update, by hand for Hopper (sm_90a): one pass
// that takes A p (stored, or finished in place from the fused apply's
// output), updates x and r, applies the pointwise preconditioner and emits
// the three loop dots.  Like packed_apply.cu: each launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() through a plain C
// entry point (loaded with ctypes by polystokes_tpu_torch/packed_apply.py).
// Every kernel is templated on the preconditioner kind (stencil.cuh
// precond_z: KIND_NONE, KIND_DIAG, KIND_ARROW) and reads alpha from a
// one-element device array, so the CG loop never brings alpha to the host.
// The three dots <r', r'>, <x', x'>, <r', z> are summed per thread block
// (stencil.cuh block_sum) into partials [3, blocks], which the wrapper sums
// with torch.sum: a fixed order, no atomics, so two runs are bit-equal.
// Bounds are HBM bytes at 128^3 in f32 (8.39 MB per channel) over 3.35
// TB/s; the arithmetic is far below the memory time.
//
// cg_update_kernel replaces cg_update_packed (_make_cg_update_kernel in
//   polystokes_tpu/pallas_apply.py).  x' = x + alpha p, r' = r - alpha Ap,
//   z = M^-1 r' and the dots, from a stored Ap: the uniform path and the
//   reduced path without fuse_pap.  Bound: x, r, p, Ap (28 channels) and
//   the factors (13 arrow, 7 diag, 0 none) read, x', r', z (21) written:
//   62 / 56 / 49 channels, 0.155 / 0.140 / 0.123 ms.  Design: one thread per
//   slot.
//
// finish_update_kernel replaces finish_update_packed
//   (_make_finish_update_kernel).  Ap = out_grid + [G Dt]^T(-u) at the slot
//   (finish_kernel's stencil, stencil.cuh face_w_u with sign -1), then the
//   update of cg_update_kernel: Ap never reaches device memory.  Bound:
//   c[:7], out_grid, u, x, r, p and the factors read, 21 channels written:
//   72 (arrow) channels, 0.180 ms.  Design: one thread per slot.
//
// exp_finish_update_kernel replaces exp_finish_update_packed
//   (_make_exp_finish_update_kernel, _expand_u_window, _axis_segments).
//   finish_update with the expand of the region polynomials in place: w_a =
//   ffw_a (-u_a) at the slot and its six transpose neighbours, each u_a
//   evaluated from the small v [cs0, cs1, 3K, cs2] in the neighbour's own
//   cube (stencil.cuh face_w_v / expand_at, the polynomial expand_kernel
//   evaluates along a row in packed_apply.cu).  The TPU kernel cut its halo window into segments that each
//   lie in one cube; a thread that indexes the cube of every point it reads
//   needs no such decomposition.  u never reaches device memory.  Bound:
//   c[:7], the masks c[14:17], out_grid, x, r, p and the factors read, 21
//   channels written: 72 (arrow) channels and v, 0.180 ms.  Design: one
//   thread per slot; v stays in L1/L2.
#include <cuda_runtime.h>

#include <type_traits>

#include "stencil.cuh"

namespace ps {

// The update at slot q given Ap there: x' = x + alpha p, r' = r - alpha Ap,
// z = M^-1 r', written out; the three dots add to acc.
template <typename T, int KIND>
__device__ __forceinline__ void update_slot(T alpha, const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p,
                                            const T ap[7], const T* __restrict__ f, T* __restrict__ xo, T* __restrict__ ro,
                                            T* __restrict__ zo, long long q, const Dims& d, T acc[3]) {
  T xs[7], rs[7], zs[7];
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) {
    xs[ch] = __ldg(x + ch * d.plane + q) + alpha * __ldg(p + ch * d.plane + q);
    rs[ch] = __ldg(r + ch * d.plane + q) - alpha * ap[ch];
  }
  precond_z<T, KIND>(f, q, d, rs, zs);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) {
    xo[ch * d.plane + q] = xs[ch];
    ro[ch * d.plane + q] = rs[ch];
    zo[ch * d.plane + q] = zs[ch];
    acc[0] += rs[ch] * rs[ch];
    acc[1] += xs[ch] * xs[ch];
    acc[2] += rs[ch] * zs[ch];
  }
}

// Ap = out_grid + [G Dt]^T(w) at (i, j, k), w_a anywhere from wf.
template <typename T, typename WF>
__device__ __forceinline__ void finished_ap(const T* __restrict__ c, const T* __restrict__ og, int i, int j, int k, const Dims& d,
                                            const WF& wf, T ap[7]) {
  const long long q = d.at(i, j, k);
  T w0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
  transpose_contrib(c, i, j, k, d, w0, wf, ap);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) ap[ch] = __ldg(og + ch * d.plane + q) + ap[ch];
}

// Every thread of the block reaches the sum, in range or not; partials is
// [3, gridDim.x].
template <typename T>
__device__ __forceinline__ void store_partials(const T (&acc)[3], T* __restrict__ partials) {
  const T total = block_sum(acc);
  if (threadIdx.x < 3) partials[threadIdx.x * gridDim.x + blockIdx.x] = total;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const T* __restrict__ alpha, const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ ap, const T* __restrict__ f, T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo,
                 T* __restrict__ partials, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T acc[3] = {T(0), T(0), T(0)};
  if (q < d.plane) {
    T apq[7];
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) apq[ch] = __ldg(ap + ch * d.plane + q);
    update_slot<T, KIND>(__ldg(alpha), x, r, p, apq, f, xo, ro, zo, q, d, acc);
  }
  store_partials(acc, partials);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
finish_update_kernel(const T* __restrict__ alpha, const T* __restrict__ c, const T* __restrict__ og, const T* __restrict__ u,
                     const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ f,
                     T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo, T* __restrict__ partials, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T acc[3] = {T(0), T(0), T(0)};
  if (q < d.plane) {
    const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));
    auto wf = [&](int a, int ii, int jj, int kk) { return face_w_u(c, u, T(-1), a, ii, jj, kk, d); };
    T ap[7];
    finished_ap(c, og, i, j, k, d, wf, ap);
    update_slot<T, KIND>(__ldg(alpha), x, r, p, ap, f, xo, ro, zo, q, d, acc);
  }
  store_partials(acc, partials);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
exp_finish_update_kernel(const T* __restrict__ alpha, const T* __restrict__ c, const T* __restrict__ v, const T* __restrict__ og,
                         const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ f,
                         T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo, T* __restrict__ partials, Dims d, int tile) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T acc[3] = {T(0), T(0), T(0)};
  if (q < d.plane) {
    const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));
    auto wf = [&](int a, int ii, int jj, int kk) { return face_w_v(c, v, a, ii, jj, kk, tile, d); };
    T ap[7];
    finished_ap(c, og, i, j, k, d, wf, ap);
    update_slot<T, KIND>(__ldg(alpha), x, r, p, ap, f, xo, ro, zo, q, d, acc);
  }
  store_partials(acc, partials);
}

// kind (0 none, 1 diag, 2 arrow) -> launch(std::integral_constant<int, kind>),
// the kernel instantiated for that preconditioner; then the launch's error
template <typename L>
int launch_for_kind(int kind, const L& launch) {
  switch (kind) {
    case KIND_NONE: launch(std::integral_constant<int, KIND_NONE>{}); break;
    case KIND_DIAG: launch(std::integral_constant<int, KIND_DIAG>{}); break;
    case KIND_ARROW: launch(std::integral_constant<int, KIND_ARROW>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int cg_update(const T* alpha, const T* x, const T* r, const T* p, const T* ap, const T* f, T* xo, T* ro, T* zo, T* partials,
              int nx, int ny, int nz, int kind, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  return launch_for_kind(kind, [&](auto kd) {
    cg_update_kernel<T, decltype(kd)::value><<<blocks_for(d.plane), kThreads, 0, stream>>>(alpha, x, r, p, ap, f, xo, ro, zo, partials, d);
  });
}

template <typename T>
int finish_update(const T* alpha, const T* c, const T* og, const T* u, const T* x, const T* r, const T* p, const T* f, T* xo, T* ro,
                  T* zo, T* partials, int nx, int ny, int nz, int kind, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  return launch_for_kind(kind, [&](auto kd) {
    finish_update_kernel<T, decltype(kd)::value><<<blocks_for(d.plane), kThreads, 0, stream>>>(alpha, c, og, u, x, r, p, f, xo, ro, zo,
                                                                                               partials, d);
  });
}

template <typename T>
int exp_finish_update(const T* alpha, const T* c, const T* v, const T* og, const T* x, const T* r, const T* p, const T* f, T* xo,
                      T* ro, T* zo, T* partials, int nx, int ny, int nz, int tile, int kind, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  return launch_for_kind(kind, [&](auto kd) {
    exp_finish_update_kernel<T, decltype(kd)::value><<<blocks_for(d.plane), kThreads, 0, stream>>>(alpha, c, v, og, x, r, p, f, xo, ro,
                                                                                                   zo, partials, d, tile);
  });
}

}  // namespace ps

extern "C" {

int ps_cg_update_f32(const float* alpha, const float* x, const float* r, const float* p, const float* ap, const float* f, float* xo,
                     float* ro, float* zo, float* partials, int nx, int ny, int nz, int kind, cudaStream_t s) {
  return ps::cg_update(alpha, x, r, p, ap, f, xo, ro, zo, partials, nx, ny, nz, kind, s);
}
int ps_cg_update_f64(const double* alpha, const double* x, const double* r, const double* p, const double* ap, const double* f,
                     double* xo, double* ro, double* zo, double* partials, int nx, int ny, int nz, int kind, cudaStream_t s) {
  return ps::cg_update(alpha, x, r, p, ap, f, xo, ro, zo, partials, nx, ny, nz, kind, s);
}
int ps_finish_update_f32(const float* alpha, const float* c, const float* og, const float* u, const float* x, const float* r,
                         const float* p, const float* f, float* xo, float* ro, float* zo, float* partials, int nx, int ny, int nz,
                         int kind, cudaStream_t s) {
  return ps::finish_update(alpha, c, og, u, x, r, p, f, xo, ro, zo, partials, nx, ny, nz, kind, s);
}
int ps_finish_update_f64(const double* alpha, const double* c, const double* og, const double* u, const double* x, const double* r,
                         const double* p, const double* f, double* xo, double* ro, double* zo, double* partials, int nx, int ny,
                         int nz, int kind, cudaStream_t s) {
  return ps::finish_update(alpha, c, og, u, x, r, p, f, xo, ro, zo, partials, nx, ny, nz, kind, s);
}
int ps_exp_finish_update_f32(const float* alpha, const float* c, const float* v, const float* og, const float* x, const float* r,
                             const float* p, const float* f, float* xo, float* ro, float* zo, float* partials, int nx, int ny,
                             int nz, int tile, int kind, cudaStream_t s) {
  return ps::exp_finish_update(alpha, c, v, og, x, r, p, f, xo, ro, zo, partials, nx, ny, nz, tile, kind, s);
}
int ps_exp_finish_update_f64(const double* alpha, const double* c, const double* v, const double* og, const double* x,
                             const double* r, const double* p, const double* f, double* xo, double* ro, double* zo, double* partials,
                             int nx, int ny, int nz, int tile, int kind, cudaStream_t s) {
  return ps::exp_finish_update(alpha, c, v, og, x, r, p, f, xo, ro, zo, partials, nx, ny, nz, tile, kind, s);
}

}  // extern "C"
