// The plane-window kernels of the packed apply and the finish of the
// fused apply, by hand for Hopper (sm_90a).  Like packed_apply.cu: each
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() through a plain C entry point (loaded with ctypes by
// polystokes_tpu_torch/packed_apply.py).  Bounds are HBM bytes at 128^3 in
// f32 (8.39 MB per channel) over 3.35 TB/s; the arithmetic, some 100-300
// flops per slot, is two orders of magnitude below the memory time.
//
// plane_window_kernel<T, MODE> is five kernels on one march:
//   WINDOW_GRID_MOM replaces grid_mom_pap_packed (_make_grid_mom_kernel,
//   _forward_s, _transpose_out, _mom_block in polystokes_tpu/pallas_apply.py):
//   in one pass the grid branch of A x with its mass terms (apply_reduced
//   with u = 0), the per-cube origin moments of the reduced-masked s, and
//   one partial of <x, out_grid> per cube.  Bound: 24 channels read, 7
//   written, about 260 MB, 0.078 ms.
//   WINDOW_MOM replaces moments_packed (_make_moments_kernel): the moments
//   alone, on WINDOW_GRID_MOM's cube columns and with its arithmetic and
//   sum order, so the two give bit-equal moments at one column.  It stages
//   g and h only: no w, no out.  Bound: 17 channels read, about 143 MB,
//   0.043 ms.
//   WINDOW_REDUCED replaces apply_reduced_packed (_apply_reduced_kernel,
//   _transpose_out): the reduced A x given the expanded u, the uniform march
//   with w_a = ffw_a (-dtMcInv_a s_a - u_a), u read at the slot and at the
//   ring slots whose w a neighbour reads.  Reads channels 0-13 of the
//   17-channel stack.  Bound: 24 channels read, 7 written, about 260 MB,
//   0.078 ms.
//   WINDOW_UNIFORM replaces apply_uniform_packed (_apply_kernel_uniform) and
//   WINDOW_UNIFORM_PAP apply_uniform_pap_packed (_grid_uniform_pap_kernel):
//   the uniform A x (apply_reduced without u), with PAP one partial of
//   <x, A x> per block.  Reads channels 0-13 only, so the 14-channel uniform
//   stack and the 17-channel one both work.  Bound: 21 channels read, 7
//   written, about 235 MB, 0.070 ms.
//   Design: a plane window in shared memory.  A block of bz x by threads
//   owns a by x bz column in (y, z) and marches along x over a run of
//   planes: the moment modes a column of one cube over its T planes
//   (packed_apply.py grid_mom_plan: the whole T x T plane, one block per
//   cube, up to T 16), the apply modes a column over a run of L planes
//   (uniform_plan: 4 x 64 over 32 planes at 128^3), with a grid that
//   ceil-divides the resolution: a thread whose slot lies outside the grid
//   stages zeros, writes nothing and reaches every barrier, and the last run
//   is clipped at nx.  Each step stages, over the column and its one-slot
//   ring in y and z, g_a = clw (p - tau_aa) and h_e = elw_e tau_e of plane
//   m + 2 (each input read once, coalesced), turns g, h of planes m - 1 ..
//   m + 1 into s_a and w_a of plane m (the thread's slot, and the ring
//   slots where a neighbour reads w), and writes out of plane m - 2 through
//   transpose_contrib, whose 9 neighbour w come from shared memory through
//   a functor.  A step reads only planes that earlier steps wrote, so one
//   barrier a step suffices, and its ring work is assigned to threads
//   before the march, so a step is one block of code whose global loads
//   are all in flight together (the kernel is held by load latency more
//   than by bytes).  The 3-D grid gives each thread its (j, k) without
//   index division.  The moments keep 9 sums per thread (chi s px^e, e =
//   0..2, per axis): a thread's y and z are fixed over the march, so its 30
//   moments are formed once at the end and block_sums adds them in a fixed
//   order.  The moment modes are templated on K, the monomials of the basis
//   (stencil.cuh): the affine basis (K = 4) keeps 6 sums (e = 0, 1) and
//   forms 12 moments a cube at stride 3K = 12, with the same arithmetic and
//   sum order for the moments it shares with K = 10.  Where a cube needs
//   several blocks (T above 16), each writes its own moments (and
//   partial) and the wrapper sums them over a leading dimension; the
//   uniform partials are one per block, summed by the caller.  No atomics: the result does not depend on block order.  The
//   window (46 656 B at T 16 in f32, 57 024 B for the 4 x 64 column, 31 104
//   B for WINDOW_MOM's g, h at T 16, twice that in f64) may exceed the 48 KB
//   a block gets by default: the launch then opts in to more
//   (window_opt_in).  WINDOW_MOM in f32, with 9 sums and no w a thread,
//   asks for 4 blocks per SM (64 registers a thread), so the 512 cubes of
//   128^3 at T 16 are one wave on 132 SMs; the others for 2.
//
// The bf16-storage forms (coeff_bf16, pack_coeffs storage_dtype in
//   polystokes_tpu/pallas_apply.py): every kernel here also exists with the
//   stack in bf16 (template argument C), its values converted to T as they
//   are loaded (stencil.cuh ldc).  The window keeps g, h and w, products of
//   a coefficient and x, in T: staging them in C would round them, and the
//   window's bytes, so the blocks per SM of the launch bounds above (4 for
//   WINDOW_MOM in f32, 64 registers, no spill with either stack), stay
//   those of the f32 form.  Bounds fall with the coefficient channels at 2
//   bytes: grid_mom_pap 90 bytes a slot against 124 (0.056 ms at 128^3),
//   moments 48 against 68, apply_reduced 96 against 124, the uniform
//   kernels 84 against 112, finish 82 against 96.
//
// The halo forms (hx = HALO_X, stencil.cuh HaloDims): WINDOW_MOM, WINDOW_REDUCED
//   and WINDOW_UNIFORM also run on an x-slab of a sharded apply whose inputs
//   (x, the stack and, for WINDOW_REDUCED, u) carry hx planes from the
//   neighbouring slabs on each side: moments_packed on the exchanged slab,
//   apply_reduced_packed(up_prepadded=True) and
//   apply_uniform_packed(prepadded=True) of polystokes_tpu/pallas_apply.py
//   (polystokes_tpu/parallel/shard_apply.py).  The march is the same: a
//   run's first and last planes stage g, h and w from the halo planes where
//   the forms without a halo stage zeros, and w on the planes -1 and nx is
//   computed where it is 0 without a halo.  The outputs cover the slab's nx
//   planes.  The kernel loads the planes -1 .. nx of its inputs: out on
//   plane i reads w_0 on i - 1 and i and w_1, w_2 on i and i + 1, and s on
//   plane p reads g on p and p + 1 (g_0) and h on p - 1 and p, so every
//   read lies on i - 1 .. i + 1 (the moments: s on the slab's planes).
//   One halo plane a side suffices; the second of HALO_X = 2 (JAX's depth,
//   kept for the exchange) is never read.  With hx = 0 a kernel reads and
//   computes what it does without a halo.  Bound: the same channels, the
//   inputs over nx + 2 planes.
//
// finish_kernel replaces finish_packed (_finish_kernel, _transpose_contrib).
//   out = out_grid + [G Dt]^T (-u): the reduced branch, no mass terms (they
//   are in out_grid).  Bound: 17 channels read (c[:7], out_grid, u), 7
//   written, about 201 MB, 0.060 ms.  Design: one thread per slot; w_a =
//   ffw_a (-u_a) at the slot and its neighbours, with the transpose's own
//   ffw factor.  Writes a new array, as JAX does.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace ps {

// What a plane-window kernel computes: grid_mom_pap's grid branch of A x,
// moments and per-cube partials; the uniform A x alone or with one
// <x, A x> partial per block; the reduced A x given u; the moments alone.
// packed_apply.py _WINDOW_KERNELS maps each kernel's name to its MODE.
enum : int { WINDOW_GRID_MOM = 0, WINDOW_UNIFORM = 1, WINDOW_UNIFORM_PAP = 2, WINDOW_REDUCED = 3, WINDOW_MOM = 4 };

// The window of plane_window_kernel on the block's by x bz column and its
// one-slot ring in (y, z): a ring of 4 planes of g_a, h_e (6 values) and,
// but for WINDOW_MOM, of 4 planes of w_a (3 values).
inline int window_bytes(int mode, int by, int bz, int itemsize) {
  return 4 * (6 + (mode == WINDOW_MOM ? 0 : 3)) * (by + 2) * (bz + 2) * itemsize;
}

// Two blocks of 256 threads per SM: at most 128 registers a thread, which
// the step's loads, all in flight together, need; WINDOW_MOM in f32,
// without w and out, four (64 registers, no spill; f64 spills at 64 and
// keeps two).
// K: the basis's monomials, read by the moment modes only (the apply modes
// exist for K = 10 alone).
// C: the coefficient stack's storage type (T, or bf16 under coeff_bf16),
// converted to T as it is loaded; the window holds g, h and w, products in
// T, so its size and the blocks per SM do not depend on C.
template <typename T, int MODE, int K = K_QUADRATIC, typename C = T>
__global__ void __launch_bounds__(kThreads, MODE == WINDOW_MOM && sizeof(T) == 4 ? 4 : 2)
plane_window_kernel(const T* __restrict__ x, const C* __restrict__ c, const T* __restrict__ u, T* __restrict__ out,
                    T* __restrict__ mom, T* __restrict__ partials, HaloDims d, int run) {
  // MOM: the moments, on columns of one cube; OUT: A x, through w
  constexpr bool MOM = MODE == WINDOW_GRID_MOM || MODE == WINDOW_MOM;
  constexpr bool OUT = MODE != WINDOW_MOM;
  extern __shared__ __align__(16) unsigned char window_raw[];
  // block (bz, by) threads: column z0.., y0.. over planes x0 .. x_end - 1,
  // one thread per (j, k) of the column on every plane.  The moment modes:
  // the column lies in cube (c0, c1, c2) and the run is its tile planes;
  // the apply modes: runs of `run` planes, the last clipped at nx, and
  // columns that may pass ny and nz
  const int bz = blockDim.x, by = blockDim.y, nthreads = bz * by;
  const int tid = threadIdx.y * bz + threadIdx.x;
  const int z0 = blockIdx.x * bz, y0 = blockIdx.y * by, x0 = blockIdx.z * run;
  const int x_end = MOM ? x0 + run : min(x0 + run, d.nx);
  const int j = y0 + threadIdx.y, k = z0 + threadIdx.x;
  // a thread whose slot lies outside the grid stages zeros, writes nothing
  // and reaches every barrier
  const bool own_in = MOM || (j < d.ny && k < d.nz);
  // window slot of (j', k'): (j' - y0 + 1) * rz + k' - z0 + 1
  const int rz = bz + 2, ring = (by + 2) * rz;
  const int own = (threadIdx.y + 1) * rz + threadIdx.x + 1;
  // plane i (x0 - 1 <= i <= x_end + 1) sits in ring slot (i - x0 + 4) & 3:
  // gh [4][6][ring] holds g_0..2, h_0..2 and wv [4][3][ring] w_0..2 (not
  // in WINDOW_MOM's window)
  T* const gh = reinterpret_cast<T*>(window_raw);
  T* const wv = gh + 4 * 6 * ring;
  auto gh_of = [&](int i, int ch) { return gh + (((i - x0 + 4) & 3) * 6 + ch) * ring; };
  auto w_of = [&](int i, int a) { return wv + (((i - x0 + 4) & 3) * 3 + a) * ring; };

  // g_a = clw (p - tau_aa) and h_e = elw_e tau_e of plane i at window
  // slot (rj, rk); 0 outside the grid
  auto stage_gh_at = [&](int i, int rj, int rk) {
    const int jj = y0 - 1 + rj, kk = z0 - 1 + rk;
    const bool in = d.inside(i, jj, kk);
    const long long q = in ? d.at(i, jj, kk) : 0;
    const int r = rj * rz + rk;
    const T p = __ldg(x + q), clw = ldc<T>(c + C_CLW * d.plane + q);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T g = clw * (p - __ldg(x + (1 + a) * d.plane + q));
      gh_of(i, a)[r] = in ? g : T(0);
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const T h = ldc<T>(c + (C_ELW + e) * d.plane + q) * __ldg(x + (4 + e) * d.plane + q);
      gh_of(i, 3 + e)[r] = in ? h : T(0);
    }
  };
  // ring slot b of the window, 0 <= b < n_ring: rows y0 - 1 and y0 + by,
  // then columns z0 - 1 and z0 + bz
  const int n_ring = 2 * rz + 2 * by;
  auto ring_slot = [&](int b, int& rj, int& rk) {
    if (b < rz) rj = 0, rk = b;
    else if (b < 2 * rz) rj = by + 1, rk = b - rz;
    else if (b < 2 * rz + by) rj = 1 + b - 2 * rz, rk = 0;
    else rj = 1 + b - 2 * rz - by, rk = bz + 1;
  };
  // s_a / ffw_a of plane i at window slot r from the staged g, h (forward_s
  // in stencil.cuh, in its order): g_a at +e_a minus g_a, plus h_e at -e_t
  // minus h_e for e != a, t = 3 - a - e
  auto s_over_ffw = [&](int i, int a, int r) {
    const T* ga = gh_of(i, a);
    T v = (a == 0 ? gh_of(i + 1, 0)[r] : ga[r + (a == 1 ? rz : 1)]) - ga[r];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (e == a) continue;
      const int t = 3 - a - e;
      const T* he = gh_of(i, 3 + e);
      const T hm = t == 0 ? gh_of(i - 1, 3 + e)[r] : he[r - (t == 1 ? rz : 1)];
      v = v + hm - he[r];
    }
    return v;
  };

  // sm_p[a][e] = sum over the column of chi_a s_a px^e (e = 0, 1, 2; the
  // affine basis has no x^2, so e = 0, 1); the moments' y and z factors are
  // the thread's own, applied once at the end
  static_assert(K == K_QUADRATIC || K == K_AFFINE, "K is 10 (quadratic) or 4 (affine)");
  constexpr int NP = K == K_QUADRATIC ? 3 : 2;
  T sm_p[3][NP];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int e = 0; e < NP; ++e) sm_p[a][e] = T(0);
  T dot = T(0);

  // the face value w_a at slot q from s_a: the grid branch's, or with
  // WINDOW_REDUCED the full one with u_a at q (q is 0 outside the grid,
  // where w is 0 whatever u holds, so u is never read out of range)
  auto w_from_s = [&](int a, long long q, T s) {
    if constexpr (MODE == WINDOW_REDUCED) return w_from_s_u(c, a, q, d, s, __ldg(u + a * d.plane + q));
    else return grid_w_from_s(c, a, q, d, s);
  };

  // w_a of plane i at the thread's slot, every axis, and (the moment modes)
  // the moments of a plane of the cube.  On the halo planes x0 - 1 and x_end
  // only w_0 and w_1, w_2 are read (they may use a plane of g, h that was
  // not staged); a run clipped at nx has x_end = nx, whose g, h stage as 0.
  // WINDOW_MOM runs it on the cube's planes only and keeps no w.  With a
  // halo, w on the planes -1 and nx is the real one the neighbour's slab
  // has there; without, those planes are outside and w is 0.
  auto stage_w_own = [&](int i) {
    const bool in = i >= -d.hx && i < d.nx + d.hx && own_in;
    const long long q = in ? d.at(i, j, k) : 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T s = ldc<T>(c + (C_FFW + a) * d.plane + q) * s_over_ffw(i, a, own);
      if constexpr (OUT) {
        const T w = w_from_s(a, q, s);
        w_of(i, a)[own] = in ? w : T(0);
      }
      if constexpr (MOM) {
        const bool moment = i >= x0 && i < x_end;
        const T sm = moment ? s * ldc<T>(c + (C_RED + a) * d.plane + q) : T(0);
        const T px = T(i - x0) + (a == 0 ? T(0.5) : T(0));
        sm_p[a][0] += sm;
        sm_p[a][1] += sm * px;
        if constexpr (K == K_QUADRATIC) sm_p[a][2] += sm * (px * px);
      }
    }
  };
  // w of plane i at window slot (rj, rk) on axis a
  auto stage_w_at = [&](int i, int rj, int rk, int a) {
    const int jj = y0 - 1 + rj, kk = z0 - 1 + rk, r = rj * rz + rk;
    const bool in = d.inside(i, jj, kk);
    const long long q = in ? d.at(i, jj, kk) : 0;
    const T s = ldc<T>(c + (C_FFW + a) * d.plane + q) * s_over_ffw(i, a, r);
    const T w = w_from_s(a, q, s);
    w_of(i, a)[r] = in ? w : T(0);
  };
  // w is needed on the ring only where a neighbour reads it
  // (transpose_contrib: w_0 at j+1 and k+1, w_1 at j-1 and k+1, w_2 at j+1
  // and k-1): 3 (by + bz) tasks (slot, axis), task b here
  const int n_border = 3 * (by + bz);
  auto border_task = [&](int b, int& rj, int& rk, int& a) {
    if (b < bz) {  // row j = y0 - 1: w_1
      rj = 0, rk = 1 + b, a = 1;
    } else if (b < 3 * bz) {  // row j = y0 + by: w_0, w_2
      const int r = b - bz;
      rj = by + 1, rk = 1 + (r >> 1), a = (r & 1) ? 2 : 0;
    } else if (b < 3 * bz + by) {  // column k = z0 - 1: w_2
      rj = 1 + b - 3 * bz, rk = 0, a = 2;
    } else {  // column k = z0 + bz: w_0, w_1
      const int r = b - 3 * bz - by;
      rj = 1 + (r >> 1), rk = bz + 1, a = r & 1;
    }
  };
  // out, the mass terms and the <x, out> partial of plane i at the
  // thread's slot, from w on planes i - 1, i and i + 1
  auto write_out = [&](int i) {
    if (!own_in) return;
    const T* prev = w_of(i - 1, 0);
    const T* cur = w_of(i, 0);
    const T* next = w_of(i + 1, 0);
    const T w0[3] = {cur[own], cur[ring + own], cur[2 * ring + own]};
    auto wf = [&](int a, int ii, int jj, int kk) {
      const T* pl = ii < i ? prev : (ii > i ? next : cur);
      return pl[a * ring + own + (jj - j) * rz + (kk - k)];
    };
    T o[7];
    transpose_contrib(c, i, j, k, d, w0, wf, o);
    const long long q = d.at(i, j, k);
    sub_mass_terms(x, c, q, d, o);
#pragma unroll
    for (int ch = 0; ch < 7; ++ch) {
      out[ch * d.cells() + q] = o[ch];
      dot += __ldg(x + ch * d.plane + q) * o[ch];
    }
  };

  // Each thread's first ring slot of g, h (threads 0 .. n_ring - 1) and
  // first ring task of w (from the last thread down), fixed for the march;
  // a thread without one repeats its own slot (axis 0 for w) and stores the
  // same values again, so a step is one block of code whose loads are all
  // in flight together.  Small columns, with more ring work than threads,
  // loop over the rest.
  int g_rj = threadIdx.y + 1, g_rk = threadIdx.x + 1, w_rj = g_rj, w_rk = g_rk, w_a = 0;
  if (tid < n_ring) ring_slot(tid, g_rj, g_rk);
  if (nthreads - 1 - tid < n_border) border_task(nthreads - 1 - tid, w_rj, w_rk, w_a);

  // The march: step m stages g, h of plane m + 2, w of plane m (from g, h
  // of planes m - 1 .. m + 1, staged in earlier steps) and writes plane
  // m - 2 (from w of planes m - 3 .. m - 1), so every read in a step is of
  // a plane an earlier step wrote, and one barrier a step suffices; the
  // rings of 4 planes hold what a step reads apart from what it writes.
  // Steps x0 + 2 .. x_end - 2 run every stage; the first and last run the
  // stages that have a plane to work on.  WINDOW_MOM stages g, h the same
  // way and takes the moments of plane m, x0 <= m < x_end, in step m; it
  // ends with step x_end - 1.
  auto step = [&](int m, bool gh_on, bool w_on, bool ring_on, bool out_on) {
    if (gh_on) {
      stage_gh_at(m + 2, threadIdx.y + 1, threadIdx.x + 1);
      stage_gh_at(m + 2, g_rj, g_rk);
    }
    if (w_on) stage_w_own(m);
    if (ring_on) stage_w_at(m, w_rj, w_rk, w_a);
    if (out_on) write_out(m - 2);
    for (int b = tid + nthreads; gh_on && b < n_ring; b += nthreads) {
      int rj, rk;
      ring_slot(b, rj, rk);
      stage_gh_at(m + 2, rj, rk);
    }
    for (int b = nthreads - 1 - tid + nthreads; ring_on && b < n_border; b += nthreads) {
      int rj, rk, a;
      border_task(b, rj, rk, a);
      stage_w_at(m, rj, rk, a);
    }
    __syncthreads();
  };
  for (int i = x0 - 1; i <= x0; ++i) {  // g, h of planes x0 - 1 and x0
    stage_gh_at(i, threadIdx.y + 1, threadIdx.x + 1);
    for (int b = tid; b < n_ring; b += nthreads) {
      int rj, rk;
      ring_slot(b, rj, rk);
      stage_gh_at(i, rj, rk);
    }
  }
  __syncthreads();
  const int m_last = OUT ? x_end + 1 : x_end - 1;
  auto edge_step = [&](int m) {
    step(m, m + 2 <= x_end, OUT ? m <= x_end : m >= x0, OUT && m >= x0 && m < x_end, OUT && m - 2 >= x0);
  };
  for (int m = x0 - 1; m <= min(x0 + 1, m_last); ++m) edge_step(m);
  for (int m = x0 + 2; m <= x_end - 2; ++m) step(m, true, true, OUT, OUT);
  for (int m = max(x0 + 2, x_end - 1); m <= m_last; ++m) edge_step(m);

  if constexpr (MODE == WINDOW_UNIFORM_PAP) {
    // one partial per block, blocks in (run, y column, z column) order
    const T acc[1] = {dot};
    const T* total = block_sums(acc);
    if (tid == 0) partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total[0];
  }
  if constexpr (MOM) {
    // acc[a*K + m]: this thread's share of the moments, monomials
    // [1, x, y, z, x^2, xy, xz, y^2, yz, z^2] (K = 10) or [1, x, y, z]
    // (K = 4) at cube-local face positions (+0.5 on the face axis); acc[3K]
    // (grid_mom_pap): the <x, out_grid> partial
    constexpr int N = 3 * K + (MODE == WINDOW_GRID_MOM ? 1 : 0);
    const int tile = run, c0 = blockIdx.z, c1 = y0 / tile, c2 = z0 / tile;
    T acc[N];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T py = T(j - c1 * tile) + (a == 1 ? T(0.5) : T(0));
      const T pz = T(k - c2 * tile) + (a == 2 ? T(0.5) : T(0));
      const T s0 = sm_p[a][0], s1 = sm_p[a][1];
      T* m = acc + a * K;
      m[0] = s0;
      m[1] = s1;
      m[2] = py * s0;
      m[3] = pz * s0;
      if constexpr (K == K_QUADRATIC) {
        m[4] = sm_p[a][2];
        m[5] = py * s1;
        m[6] = pz * s1;
        m[7] = (py * py) * s0;
        m[8] = (py * pz) * s0;
        m[9] = (pz * pz) * s0;
      }
    }
    if constexpr (MODE == WINDOW_GRID_MOM) acc[3 * K] = dot;
    const T* total = block_sums(acc);

    // part (column) index of the block within its cube, and its slice of
    // mom [parts, cs0, cs1, 3K, cs2] and partials [parts, ncubes]
    const int cs0 = d.nx / tile, cs1 = d.ny / tile, cs2 = d.nz / tile;
    const int per_z = tile / bz;
    const int part = (blockIdx.y - c1 * (tile / by)) * per_z + (blockIdx.x - c2 * per_z);
    const long long ncubes = (long long)cs0 * cs1 * cs2;
    const long long cube = ((long long)c0 * cs1 + c1) * cs2 + c2;
    T* mom_part = mom + part * ncubes * (3 * K);
    for (int m = tid; m < N; m += nthreads) {
      if (m < 3 * K) mom_part[(((long long)c0 * cs1 + c1) * (3 * K) + m) * cs2 + c2] = total[m];
      else partials[part * ncubes + cube] = total[m];
    }
  }
}

template <typename T, typename C = T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const C* __restrict__ c, const T* __restrict__ out_grid, const T* __restrict__ u, T* __restrict__ out, Dims d) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= d.plane) return;
  const int k = (int)(q % d.nz), j = (int)((q / d.nz) % d.ny), i = (int)(q / ((long long)d.nz * d.ny));

  auto wf = [&](int a, int ii, int jj, int kk) { return face_w_u(c, u, T(-1), a, ii, jj, kk, d); };
  T w0[3], o[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = wf(a, i, j, k);
  transpose_contrib(c, i, j, k, d, w0, wf, o);
#pragma unroll
  for (int ch = 0; ch < 7; ++ch) out[ch * d.plane + q] = __ldg(out_grid + ch * d.plane + q) + o[ch];
}

// A window that, with block_sums' static arrays, passes the 48 KB of shared
// memory a block gets by default needs the kernel's opt-in, up to what the
// device allows (227 KB a block on the H100, room for every column of 256
// slots in f64); a window beyond that is refused here and the launch fails.
template <typename T, int MODE, int K = K_QUADRATIC, typename C = T>
cudaError_t window_opt_in(int bytes) {
  static const int static_bytes = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, plane_window_kernel<T, MODE, K, C>) == cudaSuccess ? (int)attr.sharedSizeBytes : 0;
  }();
  if (static_bytes + bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(plane_window_kernel<T, MODE, K, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One launch of plane_window_kernel: by x bz columns over runs of `run`
// planes (the moment modes: run = tile, and the column divides the cube;
// K monomials; the stack stored in C).  hx: the x-halo of x, c and u, which
// hold nx + 2 hx planes (the halo forms; 0 otherwise); the kernel gets
// pointers to their plane hx.
template <typename T, int MODE, int K = K_QUADRATIC, typename C = T>
int plane_window(const T* x, const C* c, const T* u, T* out, T* mom, T* partials, int nx, int ny, int nz, int run, int by,
                 int bz, int hx, cudaStream_t stream) {
  if (by < 1 || bz < 1 || by * bz > kThreads || run < 1 || hx < 0) return (int)cudaErrorInvalidValue;
  if ((MODE == WINDOW_GRID_MOM || MODE == WINDOW_MOM) && (run % by || run % bz)) return (int)cudaErrorInvalidValue;
  const int bytes = window_bytes(MODE, by, bz, (int)sizeof(T));
  const cudaError_t err = window_opt_in<T, MODE, K, C>(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((nz + bz - 1) / bz), (unsigned)((ny + by - 1) / by), (unsigned)((nx + run - 1) / run));
  const long long halo = (long long)hx * ny * nz;
  plane_window_kernel<T, MODE, K, C><<<grid, dim3(bz, by), bytes, stream>>>(
      x + halo, c + halo, u == nullptr ? nullptr : u + halo, out, mom, partials, halo_dims(nx, ny, nz, hx), run);
  return (int)cudaGetLastError();
}

// Thread blocks of plane_window_kernel resident on one SM at the column
// (by, bz), from the CUDA occupancy calculator; negative: a CUDA error.
template <typename T, int MODE, typename C = T>
int window_blocks_per_sm(int by, int bz) {
  const int bytes = window_bytes(MODE, by, bz, (int)sizeof(T));
  cudaError_t err = window_opt_in<T, MODE, K_QUADRATIC, C>(bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, plane_window_kernel<T, MODE, K_QUADRATIC, C>, by * bz, bytes);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, typename C>
int finish(const C* c, const T* out_grid, const T* u, T* out, int nx, int ny, int nz, cudaStream_t stream) {
  const Dims d = dims(nx, ny, nz);
  finish_kernel<T, C><<<blocks_for(d.plane), kThreads, 0, stream>>>(c, out_grid, u, out, d);
  return (int)cudaGetLastError();
}

}  // namespace ps

extern "C" {

// Every entry point exists for f32 and f64 compute (TAG) with the stack
// stored in the compute type (ps_<name>[_k<K>]_<TAG>) or in bf16
// (ps_<name>[_k<K>]_<TAG>_bf16, coeff_bf16); the moment modes for each
// basis: _k10_ (quadratic) and _k4_ (affine).  moments, apply_reduced and
// apply_uniform take hx, the x-halo of their inputs (0, or HALO_X in the
// halo forms); nx is the slab's, without it.
#define PS_MOMENT_MODES(K, TAG, T, C) \
  int ps_grid_mom_pap_k##K##_##TAG(const T* x, const C* c, T* out, T* mom, T* partials, int nx, int ny, int nz, int tile, \
                                   int by, int bz, cudaStream_t s) { \
    return ps::plane_window<T, ps::WINDOW_GRID_MOM, K, C>(x, c, nullptr, out, mom, partials, nx, ny, nz, tile, by, bz, 0, \
                                                          s); \
  } \
  int ps_moments_k##K##_##TAG(const T* x, const C* c, T* mom, int nx, int ny, int nz, int tile, int by, int bz, int hx, \
                              cudaStream_t s) { \
    return ps::plane_window<T, ps::WINDOW_MOM, K, C>(x, c, nullptr, nullptr, mom, nullptr, nx, ny, nz, tile, by, bz, hx, s); \
  }
#define PS_WINDOW_FORMS(TAG, T, C) \
  PS_MOMENT_MODES(10, TAG, T, C) \
  PS_MOMENT_MODES(4, TAG, T, C) \
  int ps_finish_##TAG(const C* c, const T* out_grid, const T* u, T* out, int nx, int ny, int nz, cudaStream_t s) { \
    return ps::finish(c, out_grid, u, out, nx, ny, nz, s); \
  } \
  int ps_apply_reduced_##TAG(const T* x, const C* c, const T* u, T* out, int nx, int ny, int nz, int by, int bz, int run, \
                             int hx, cudaStream_t s) { \
    return ps::plane_window<T, ps::WINDOW_REDUCED, ps::K_QUADRATIC, C>(x, c, u, out, nullptr, nullptr, nx, ny, nz, run, by, \
                                                                      bz, hx, s); \
  } \
  int ps_apply_uniform_##TAG(const T* x, const C* c, T* out, int nx, int ny, int nz, int by, int bz, int run, int hx, \
                             cudaStream_t s) { \
    return ps::plane_window<T, ps::WINDOW_UNIFORM, ps::K_QUADRATIC, C>(x, c, nullptr, out, nullptr, nullptr, nx, ny, nz, run, \
                                                                      by, bz, hx, s); \
  } \
  int ps_apply_uniform_pap_##TAG(const T* x, const C* c, T* out, T* partials, int nx, int ny, int nz, int by, int bz, \
                                 int run, cudaStream_t s) { \
    return ps::plane_window<T, ps::WINDOW_UNIFORM_PAP, ps::K_QUADRATIC, C>(x, c, nullptr, out, nullptr, partials, nx, ny, \
                                                                          nz, run, by, bz, 0, s); \
  } \
  int ps_grid_mom_pap_blocks_per_sm_##TAG(int by, int bz) { \
    return ps::window_blocks_per_sm<T, ps::WINDOW_GRID_MOM, C>(by, bz); \
  } \
  int ps_moments_blocks_per_sm_##TAG(int by, int bz) { return ps::window_blocks_per_sm<T, ps::WINDOW_MOM, C>(by, bz); } \
  int ps_apply_reduced_blocks_per_sm_##TAG(int by, int bz) { \
    return ps::window_blocks_per_sm<T, ps::WINDOW_REDUCED, C>(by, bz); \
  } \
  int ps_apply_uniform_blocks_per_sm_##TAG(int by, int bz) { \
    return ps::window_blocks_per_sm<T, ps::WINDOW_UNIFORM, C>(by, bz); \
  } \
  int ps_apply_uniform_pap_blocks_per_sm_##TAG(int by, int bz) { \
    return ps::window_blocks_per_sm<T, ps::WINDOW_UNIFORM_PAP, C>(by, bz); \
  }
// (the blocks per SM at the column (by, bz) of each kernel that marches
// the window).  The bf16 forms are built from this file in a translation
// unit of their own, fused_apply_bf16.cu, so that nvcc compiles the two
// halves in parallel.
#ifndef PS_FUSED_APPLY_BF16
PS_WINDOW_FORMS(f32, float, float)
PS_WINDOW_FORMS(f64, double, double)
// the plane window's dynamic shared memory (of the kernel whose MODE is
// `mode`) at the column (by, bz): the window holds T, whatever the stack
int ps_window_bytes_f32(int by, int bz, int mode) { return ps::window_bytes(mode, by, bz, (int)sizeof(float)); }
int ps_window_bytes_f64(int by, int bz, int mode) { return ps::window_bytes(mode, by, bz, (int)sizeof(double)); }
#else
PS_WINDOW_FORMS(f32_bf16, float, ps::bf16)
PS_WINDOW_FORMS(f64_bf16, double, ps::bf16)
#endif
#undef PS_WINDOW_FORMS
#undef PS_MOMENT_MODES

}  // extern "C"
