"""The packed layout and the three kernels of the reduced apply, the
counterpart of ``polystokes_tpu.pallas_apply``.

Packed layout
-------------
All 7 solve fields and the 17 coefficient fields are channel-stacked as
``[C, nx, ny, nz]``.  Cells map to slot = cell; face family a drops its
natural index-0 plane (natural face f -> slot f - e_a); edge family e
drops the index-0 planes of both offset axes.  That is exact while no
face or edge on those planes is active (``solver.boundary_activity``).
In slot space (t = 3 - a - e, out-of-range reads are 0):

  s_a[i]   = ffw_a[i] (g_a[i+e_a] - g_a[i] + sum_e (h_e[i-e_t] - h_e[i]))
  w_a      = ffw_a (-dtMcInv_a s_a - u_a)
  p[c]     = clw[c] sum_a (w_a[c-e_a] - w_a[c])
  tc_a[c]  = -clw[c] (w_a[c-e_a] - w_a[c]) - uinv2_c[c] x_tc_a[c]
  te_e[j]  = elw_e[j] sum_a (w_a[j+e_t] - w_a[j]) - uinv2_e[j] x_te_e[j]

with g_a = clw (p - tc_a) and h_e = elw_e x_te_e.  The second ffw factor
in w (the transpose's own face weight) matters at solid-cut faces.

Coefficient channels: 0 clw_s | 1-3 elw_s | 4-6 ffw | 7-9 dt*mc_inv |
10 0.5*uinv_c | 11-13 0.5*uinv_e | 14-16 reduced-face masks, which the
uniform stack (14 channels) omits.  The stack is unpadded: the CUDA
kernels read a zero for every out-of-range neighbour.

Kernels
-------
Each wrapper takes a CPU tensor to its plain PyTorch twin (``*_plain``)
and a CUDA tensor to its hand-written kernel, built with nvcc for sm_90a
into ``build/polystokes_tpu_torch/`` on first use and loaded with ctypes:

* ``moments_packed``, ``expand_packed``, ``apply_reduced_packed``: the
  reduced apply (``expand`` in ``csrc/packed_apply.cu``, the other two on
  the plane window of ``csrc/fused_apply.cu``);
* ``grid_mom_pap_packed``, ``finish_packed``: the fused reduced apply that
  also returns <x, A x> (``fuse_pap``); ``apply_uniform_packed``,
  ``apply_uniform_pap_packed``: the uniform apply (``csrc/fused_apply.cu``);
* ``transpose_u_packed``: [G Dt]^T u, the transpose leg of the
  REGION_ARROW solve; ``forward_s_packed``, ``combine_packed``: the
  forward and combine halves of ``apply_reduced_packed``
  (``csrc/transpose_apply.cu``);
* ``cg_update_packed``, ``finish_update_packed``,
  ``exp_finish_update_packed``: the fused CG update of ``fuse_update``
  from a stored A p, from the deferred (out_grid, u) pair, or from
  (out_grid, v) with the expand in place; each applies the pointwise
  preconditioner of its ``kind`` ("none", "diag" or "arrow") and returns
  the three loop dots as 0-dim tensors (``csrc/update_apply.cu``).

``LAUNCHES`` counts the kernel launches of each wrapper; under a CUDA
graph, ``captured_launches`` and ``add_launches`` count each replay's.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .basis import monomials_xyz
from .classify import REDUCED, is_active
from .grid import EDGE_OFFSET_AXES, pad_axis, shift, unit
from .operators import PTau

C_CLW = 0
C_ELW = 1  # +e
C_FFW = 4  # +a
C_DTMCINV = 7  # +a
C_UINV2C = 10
C_UINV2E = 11  # +e
C_RED = 14  # +a
N_COEFF = 17
N_COEFF_UNIFORM = 14  # without the reduced-face masks
K = 10  # quadratic monomials per axis
PAP_BLOCK = 256  # slots per dot partial of the update kernels (their thread block)
KERNEL_THREADS = 256  # most threads in a block of any kernel (csrc/stencil.cuh kThreads)

LAUNCHES = {name: 0 for name in ("moments", "expand", "apply_reduced", "grid_mom_pap", "finish", "apply_uniform",
                                 "apply_uniform_pap", "transpose_u", "forward_s", "combine", "cg_update",
                                 "finish_update", "exp_finish_update")}

# channels of the CELL_ARROW factor stack (pack_arrow_factors), as in the
# JAX package's pallas_apply
_ARROW_KD = 0  # +a
_ARROW_SCHUR = 3
_ARROW_K = 4  # +a
_ARROW_INVD = 7  # +a
_ARROW_TEINV = 10  # +e
N_ARROW = 13
# the preconditioner kinds of the update kernels -> the kernels' KIND
# template argument, and the factor channels each reads
UPDATE_KINDS = {"none": 0, "diag": 1, "arrow": 2}
_KIND_CHANNELS = {"none": None, "diag": 7, "arrow": N_ARROW}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a dict that, on exit, holds the
    launches counted inside, which are taken back out of ``LAUNCHES``: a
    capture launches nothing, and each replay adds them (``add_launches``)."""
    before = dict(LAUNCHES)
    counted = {}
    try:
        yield counted
    finally:
        for name, n in before.items():
            counted[name] = LAUNCHES[name] - n
            LAUNCHES[name] = n


def add_launches(counted, times: int) -> None:
    """Count ``times`` replays of a graph that launches ``counted``."""
    for name, n in counted.items():
        LAUNCHES[name] += n * times


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def _face_to_slot(arr, a):
    """Drop natural face index 0 along a (assumed inactive)."""
    return arr.narrow(a, 1, arr.shape[a] - 1)


def _edge_to_slot(arr, e):
    p, q = EDGE_OFFSET_AXES[e]
    return arr.narrow(p, 1, arr.shape[p] - 1).narrow(q, 1, arr.shape[q] - 1)


def _slot_to_edge(arr, e):
    p, q = EDGE_OFFSET_AXES[e]
    return pad_axis(pad_axis(arr, p, 1, 0), q, 1, 0)


def pack_ptau(x: PTau) -> torch.Tensor:
    """PTau -> [7, nx, ny, nz]."""
    return torch.stack([x.p] + list(x.tc) + [_edge_to_slot(x.te[e], e) for e in range(3)], dim=0)


def unpack_ptau(packed: torch.Tensor) -> PTau:
    return PTau(
        p=packed[0],
        tc=tuple(packed[1 + a] for a in range(3)),
        te=tuple(_slot_to_edge(packed[4 + e], e) for e in range(3)),
    )


def reduced_face_masks(cls) -> list:
    """The three reduced-face masks (bool, natural face shape)."""
    return [(cls.face_labels[a] == REDUCED) & (cls.face_region[a] >= 0) for a in range(3)]


def packed_masks(cls, dtype) -> torch.Tensor:
    """Active-DOF masks per packed channel: p and tau_c on active cells,
    tau_e on active edges."""
    cell = is_active(cls.cell_labels).to(dtype)
    edges = [_edge_to_slot(is_active(cls.edge_labels[e]).to(dtype), e) for e in range(3)]
    return torch.stack([cell, cell, cell, cell] + edges, dim=0)


def pack_coeffs(asm, cls=None) -> torch.Tensor:
    """Assembled -> the unpadded [17, nx, ny, nz] pre-scaled coefficient
    stack (the JAX package's ``pack_coeffs(..., pad=False)``); without
    ``cls`` (the uniform solve) the [14, ...] stack without the reduced-face
    masks, which the uniform kernels never read."""
    dtype = asm.clw_s.dtype
    chans = [asm.clw_s]
    chans += [_edge_to_slot(asm.elw_s[e], e) for e in range(3)]
    chans += [_face_to_slot(asm.ffw[a], a) for a in range(3)]
    chans += [_face_to_slot(asm.dt * asm.mc_inv[a], a) for a in range(3)]
    chans += [0.5 * asm.uinv_c]
    chans += [_edge_to_slot(0.5 * asm.uinv_e[e], e) for e in range(3)]
    if cls is not None:
        chans += [_face_to_slot(m.to(dtype), a) for a, m in enumerate(reduced_face_masks(cls))]
    return torch.stack(chans, dim=0).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch twins (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _forward_s(x, c):
    """s_a (list of 3) in slot space."""
    p = x[0]
    h = [c[C_ELW + e] * x[4 + e] for e in range(3)]
    s = []
    for a in range(3):
        g = c[C_CLW] * (p - x[1 + a])
        v = shift(g, unit(a, 1)) - g
        for e in range(3):
            if e != a:
                v = v + shift(h[e], unit(3 - a - e, -1)) - h[e]
        s.append(c[C_FFW + a] * v)
    return s


def _transpose_contrib(c, w):
    """The 7 output channels of [G Dt]^T on face values w, without the mass
    terms; the transpose's own ffw factor is applied here."""
    w = [c[C_FFW + a] * w[a] for a in range(3)]
    dsum = [shift(w[a], unit(a, -1)) - w[a] for a in range(3)]
    clw = c[C_CLW]
    out = [clw * (dsum[0] + dsum[1] + dsum[2])]
    out += [-clw * dsum[a] for a in range(3)]
    for e in range(3):
        p_ax, q_ax = EDGE_OFFSET_AXES[e]
        out.append(c[C_ELW + e] * sum(shift(w[a], unit(3 - a - e, 1)) - w[a] for a in (p_ax, q_ax)))
    return torch.stack(out, dim=0)


def _transpose_out(x, c, w):
    """The 7 output channels from face values w, with the mass terms."""
    out = _transpose_contrib(c, w)
    out[1:4] -= c[C_UINV2C] * x[1:4]
    out[4:7] -= c[C_UINV2E : C_UINV2E + 3] * x[4:7]
    return out


def _grid_w(c, s):
    """The grid branch's face values -dt McInv s (before the ffw factor)."""
    return [-c[C_DTMCINV + a] * s[a] for a in range(3)]


def _local_monomials(T: int, a: int, like):
    """[K, T, T, T] monomials at cube-local face positions (+0.5 on axis a)."""
    loc = torch.arange(T, dtype=like.dtype, device=like.device)
    pos = [loc[:, None, None], loc[None, :, None], loc[None, None, :]]
    pos[a] = pos[a] + 0.5
    return torch.stack([m.expand(T, T, T) for m in monomials_xyz(*pos)], dim=0)


def _moments_from_s(s, coeffs, T: int):
    """[cs0, cs1, 3K, cs2] cube-origin moments of the reduced-masked s."""
    nx, ny, nz = s[0].shape
    rows = []
    for a in range(3):
        sm = (s[a] * coeffs[C_RED + a]).reshape(nx // T, T, ny // T, T, nz // T, T)
        rows.append(torch.einsum("aibjck,mijk->abmc", sm, _local_monomials(T, a, s[a])))
    return torch.cat(rows, dim=2)


def _box_sums(field, box):
    """[nx, ny, nz] -> the sums over boxes of box = (bx, by, bz) slots, zero
    past the grid's far edges, boxes in (x, y, z) order."""
    pad = [(-n % b) for n, b in zip(field.shape, box)]
    f = torch.nn.functional.pad(field, (0, pad[2], 0, pad[1], 0, pad[0]))
    nx, ny, nz = f.shape
    bx, by, bz = box
    return f.reshape(nx // bx, bx, ny // by, by, nz // bz, bz).sum(dim=(1, 3, 5)).reshape(-1)


def moments_packed_plain(xp, coeffs, T: int):
    """Per-cube monomial moments about the cube origin of the reduced-
    masked s: [cs0, cs1, 3K, cs2]."""
    return _moments_from_s(_forward_s(xp, coeffs), coeffs, T)


def expand_packed_plain(v_origin, red_packed, T: int):
    """u_a = chi_a sum_k v[cube, aK+k] m_k(p - origin): [3, nx, ny, nz]."""
    cs0, cs1, _, cs2 = v_origin.shape
    out = []
    for a in range(3):
        va = v_origin[:, :, a * K : (a + 1) * K, :]
        u = torch.einsum("abmc,mijk->aibjck", va, _local_monomials(T, a, v_origin))
        out.append(u.reshape(cs0 * T, cs1 * T, cs2 * T) * red_packed[a])
    return torch.stack(out, dim=0)


def apply_reduced_packed_plain(xp, coeffs, up):
    """The reduced A x given the expanded u: [7, nx, ny, nz]."""
    s = _forward_s(xp, coeffs)
    w = [wg - up[a] for a, wg in enumerate(_grid_w(coeffs, s))]
    return _transpose_out(xp, coeffs, w)


def grid_mom_pap_packed_plain(xp, coeffs, T: int):
    """(out_grid, mom, partials): the grid branch of A x with its mass
    terms, the moments of ``moments_packed_plain`` and the per-cube
    partials of <x, out_grid>."""
    s = _forward_s(xp, coeffs)
    out = _transpose_out(xp, coeffs, _grid_w(coeffs, s))
    return out, _moments_from_s(s, coeffs, T), _box_sums((xp * out).sum(dim=0), (T, T, T))


def finish_packed_plain(coeffs, out_grid, up):
    """out_grid + [G Dt]^T (-u): the reduced branch, no mass terms."""
    return out_grid + _transpose_contrib(coeffs, [-up[a] for a in range(3)])


def apply_uniform_packed_plain(xp, coeffs):
    """The uniform A x: [7, nx, ny, nz]."""
    return _transpose_out(xp, coeffs, _grid_w(coeffs, _forward_s(xp, coeffs)))


def transpose_u_packed_plain(coeffs, up):
    """[G Dt]^T u: positive sign, no mass terms, no grid branch."""
    return _transpose_contrib(coeffs, [up[a] for a in range(3)])


def forward_s_packed_plain(xp, coeffs):
    """s = [G Dt] x on all faces: [3, nx, ny, nz]."""
    return torch.stack(_forward_s(xp, coeffs), dim=0)


def combine_packed_plain(xp, coeffs, sp, up):
    """[G Dt]^T (-dt McInv s - u) with the mass terms: [7, nx, ny, nz]."""
    return _transpose_out(xp, coeffs, [wg - up[a] for a, wg in enumerate(_grid_w(coeffs, sp))])


def apply_uniform_pap_packed_plain(xp, coeffs):
    """(A x, partials): the uniform A x and the partials of <x, A x>, one
    per block of ``uniform_plan``: L planes of a by x bz column, in the
    kernel's (run, y column, z column) order."""
    out = apply_uniform_packed_plain(xp, coeffs)
    by, bz, run = uniform_plan(tuple(xp.shape[1:]))
    return out, _box_sums((xp * out).sum(dim=0), (run, by, bz))


def pack_arrow_factors(factors: dict) -> torch.Tensor:
    """precond_factors_packed's CELL_ARROW dict -> the [13, nx, ny, nz]
    stack the update kernels read: kd | inv_schur | k | inv_d | te_inv."""
    chans = list(factors["kd"]) + [factors["inv_schur"]] + list(factors["k"])
    chans += list(factors["inv_d"]) + list(factors["te_inv_s"])
    return torch.stack(chans, dim=0).contiguous()


def _precond_z(r, factors, kind):
    """z = M^-1 r for the pointwise packed preconditioners."""
    if kind == "none":
        return r
    if kind == "diag":
        return factors * r
    f = factors
    z_p = (r[0] + sum(f[_ARROW_KD + a] * r[1 + a] for a in range(3))) * f[_ARROW_SCHUR]
    z_tc = [(r[1 + a] + f[_ARROW_K + a] * z_p) * f[_ARROW_INVD + a] for a in range(3)]
    z_te = [r[4 + e] * f[_ARROW_TEINV + e] for e in range(3)]
    return torch.stack([z_p] + z_tc + z_te, dim=0)


def cg_update_packed_plain(xp, rp, pp, app, alpha, factors=None, kind="none"):
    """(x', r', z, <r',r'>, <x',x'>, <r',z>): x' = x + alpha p, r' = r -
    alpha Ap, z = M^-1 r' for the preconditioner ``kind``."""
    x = xp + alpha * pp
    r = rp - alpha * app
    z = _precond_z(r, factors, kind)
    return x, r, z, torch.sum(r * r), torch.sum(x * x), torch.sum(r * z)


def finish_update_packed_plain(xp, rp, pp, alpha, coeffs, out_grid, up, factors=None, kind="none"):
    """cg_update with Ap = out_grid + [G Dt]^T (-u), the deferred finish."""
    return cg_update_packed_plain(xp, rp, pp, finish_packed_plain(coeffs, out_grid, up), alpha, factors, kind)


def exp_finish_update_packed_plain(xp, rp, pp, alpha, coeffs, out_grid, v_origin, T: int, factors=None, kind="none"):
    """finish_update with u expanded from v on the reduced-face masks of
    the coefficient stack."""
    up = expand_packed_plain(v_origin, coeffs[C_RED : C_RED + 3], T)
    return finish_update_packed_plain(xp, rp, pp, alpha, coeffs, out_grid, up, factors, kind)


# ---------------------------------------------------------------------------
# The CUDA library: built with nvcc on first use, loaded with ctypes
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "polystokes_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None
# the kernels that march a plane window, each with its MODE in
# csrc/fused_apply.cu plane_window_kernel
_WINDOW_KERNELS = {"grid_mom_pap": 0, "apply_uniform": 1, "apply_uniform_pap": 2, "apply_reduced": 3, "moments": 4}
# (entry point, pointer arguments, int arguments) of each kernel; every
# entry point also takes the stream and exists for f32 and f64
_SIGNATURES = (("moments", 3, 6), ("expand", 3, 7), ("apply_reduced", 4, 6), ("grid_mom_pap", 5, 6),
               ("finish", 4, 3), ("apply_uniform", 3, 6), ("apply_uniform_pap", 4, 6), ("transpose_u", 3, 3),
               ("forward_s", 3, 3), ("combine", 5, 3), ("cg_update", 10, 4), ("finish_update", 12, 4),
               ("exp_finish_update", 12, 5))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")
    return path


def build_kernels():
    """Compile csrc/ into a shared library keyed by a hash of the sources
    and flags (an edit rebuilds it): one nvcc per ``.cu`` file, all started
    together, then one link.  Returns (path, seconds spent building,
    ptxas report); seconds is 0.0 when the library existed."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libpolystokes_kernels.so"
    log = out_dir / "ptxas.txt"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    stamp = time.monotonic_ns()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in sources if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{stamp}.o"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report, failed = "", []
    for obj, proc in jobs:  # wait for every compiler before raising
        out, err = proc.communicate()
        report += out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {obj.name}:\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"lib.{stamp}.so"
    res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp)] + [str(obj) for obj, _ in jobs],
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    seconds = time.perf_counter() - t0
    log.write_text(report)
    tmp.replace(lib)
    return lib, seconds, report


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for dt in ("f32", "f64"):
            for name, n_ptr, n_int in _SIGNATURES:
                fn = getattr(lib, f"ps_{name}_{dt}")
                fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
                fn.restype = i32
            # window bytes at (by, bz, MODE); blocks per SM at (by, bz)
            for query, n_int in [("window_bytes", 3)] + [(f"{k}_blocks_per_sm", 2) for k in _WINDOW_KERNELS]:
                fn = getattr(lib, f"ps_{query}_{dt}")
                fn.argtypes, fn.restype = [i32] * n_int, i32
        _LIB = lib
    return _LIB


def _launch(name: str, tensors, ints, dtype):
    """Launch one kernel; a tensor given as None is a null pointer (the
    factors of the update kernels' kind "none")."""
    fn = getattr(_library(), f"ps_{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    device = tensors[0].device
    with torch.cuda.device(device):  # the runtime launches on the current device
        err = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check(name, tensors, shapes):
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    returns the device type ('cpu' or 'cuda')."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 tensors required, got {dtype}")
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: all tensors must share device and dtype ({dev}, {dtype})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _cube_dims(res, T):
    if any(n % T for n in res):
        raise ValueError(f"resolution {tuple(res)} must be a multiple of the tile size {T}")
    return tuple(n // T for n in res)


@functools.lru_cache(maxsize=None)
def expand_plan(res, T: int, itemsize: int, aligned: bool):
    """(vec, bx, by), the launch geometry of the expand kernel: each thread
    takes vec consecutive z slots of one cube, 16 bytes where nz and T are
    multiples of vec and the pointers are 16-byte aligned, else 1; a block
    is bx threads along z by by rows along y; the grid covers
    (nz / vec, ny, nx)."""
    vec = 16 // itemsize
    if not aligned or res[2] % vec or T % vec:
        vec = 1
    bx = min(res[2] // vec, 32)
    return vec, bx, min(KERNEL_THREADS // bx, res[1])


@functools.lru_cache(maxsize=None)
def grid_mom_plan(T: int):
    """(by, bz), the column of a cube that one block of the grid_mom_pap
    kernel owns and marches along x: the widest bz dividing T, then the
    tallest by dividing T, with by * bz within the kernel's block of
    KERNEL_THREADS.  The whole plane, one block per cube, up to T 16; above,
    a cube takes (T / by) * (T / bz) blocks, whose moments and partials the
    wrapper sums in a fixed order."""
    divisors = [n for n in range(T, 0, -1) if T % n == 0]
    bz = next(n for n in divisors if n <= KERNEL_THREADS)
    return next(n for n in divisors if n * bz <= KERNEL_THREADS), bz


# (by, bz, L) of the uniform and reduced apply kernels: 4 rows of 64 slots
# (256-byte z rows) over runs of 32 planes, of the geometries chip_smoke.py
# phase 2 sweeps at 128^3 the fastest for apply_uniform_pap and
# apply_reduced and within 3 % of the fastest for apply_uniform (PERF.md)
_UNIFORM_GEOMETRY = (4, 64, 32)


@functools.lru_cache(maxsize=None)
def uniform_plan(res):
    """(by, bz, L), the launch geometry of the uniform and reduced apply
    kernels: a block owns a by x bz column in (y, z) and marches along x
    over a run of L planes; the grid is (ceil(nz / bz), ceil(ny / by),
    ceil(nx / L)), so the last column and run may pass the grid's edge.  The
    geometry timed fastest at 128^3, narrowed to the resolution where that
    is smaller."""
    return tuple(min(g, n) for g, n in zip(_UNIFORM_GEOMETRY, (res[1], res[2], res[0])))


def window_occupancy(kernel: str, dtype, by: int, bz: int):
    """(window bytes, blocks per SM) of a plane-window kernel (one of
    _WINDOW_KERNELS) at the column (by, bz): its dynamic shared memory and
    the blocks the CUDA occupancy calculator lets reside on one SM
    (registers, shared memory, threads)."""
    dt = "f32" if dtype == torch.float32 else "f64"
    n = getattr(_library(), f"ps_{kernel}_blocks_per_sm_{dt}")(by, bz)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return getattr(_library(), f"ps_window_bytes_{dt}")(by, bz, _WINDOW_KERNELS[kernel]), n


def grid_mom_pap_occupancy(dtype, by: int, bz: int):
    """window_occupancy of the grid_mom_pap kernel."""
    return window_occupancy("grid_mom_pap", dtype, by, bz)


def _cube_parts(T: int, by: int, bz: int):
    """The leading dimension of the per-block moments and partials of a
    moment kernel at the column (by, bz): () for one block per cube, else
    (blocks per cube,)."""
    parts = (T // by) * (T // bz)
    return (parts,) if parts > 1 else ()


def moments_packed(xp, coeffs, T: int):
    """[cs0, cs1, 3K, cs2] per-cube moments of the reduced-masked s."""
    res = tuple(xp.shape[1:])
    _cube_dims(res, T)
    dev = _check("moments_packed", (xp, coeffs), ((7,) + res, (N_COEFF,) + res))
    if dev == "cpu":
        return moments_packed_plain(xp, coeffs, T)
    return _moments_cuda(xp, coeffs, T, *grid_mom_plan(T))


def _moments_cuda(xp, coeffs, T: int, by: int, bz: int):
    """moments_packed's kernel at the column geometry (by, bz), on
    grid_mom_pap's columns: each of a cube's (T / by) * (T / bz) blocks
    writes its own moments, summed here over dim 0 as _grid_mom_pap_cuda
    sums them, so the two agree bit for bit at one column."""
    res = tuple(xp.shape[1:])
    cs = _cube_dims(res, T)
    lead = _cube_parts(T, by, bz)
    mom = torch.empty(lead + (cs[0], cs[1], 3 * K, cs[2]), dtype=xp.dtype, device=xp.device)
    _launch("moments", (xp, coeffs, mom), (*res, T, by, bz), xp.dtype)
    return mom.sum(dim=0) if lead else mom


def expand_packed(v_origin, red_packed, T: int):
    """[3, nx, ny, nz] region polynomials on the reduced faces."""
    res = tuple(red_packed.shape[1:])
    cs = _cube_dims(res, T)
    dev = _check("expand_packed", (v_origin, red_packed), ((cs[0], cs[1], 3 * K, cs[2]), (3,) + res))
    if dev == "cpu":
        return expand_packed_plain(v_origin, red_packed, T)
    u = torch.empty((3,) + res, dtype=v_origin.dtype, device=v_origin.device)
    plan = expand_plan(res, T, u.element_size(), aligned=red_packed.data_ptr() % 16 == 0 and u.data_ptr() % 16 == 0)
    _launch("expand", (v_origin, red_packed, u), (*res, T, *plan), v_origin.dtype)
    return u


def apply_reduced_packed(xp, coeffs, up):
    """[7, nx, ny, nz] = the reduced A x given the expanded u."""
    res = tuple(xp.shape[1:])
    dev = _check("apply_reduced_packed", (xp, coeffs, up), ((7,) + res, (N_COEFF,) + res, (3,) + res))
    if dev == "cpu":
        return apply_reduced_packed_plain(xp, coeffs, up)
    return _apply_reduced_cuda(xp, coeffs, up, *uniform_plan(res))


def _apply_reduced_cuda(xp, coeffs, up, by: int, bz: int, run: int):
    """The reduced apply kernel at the geometry (by, bz, run): by x bz
    columns over runs of `run` planes, as the uniform apply's."""
    out = torch.empty_like(xp)
    _launch("apply_reduced", (xp, coeffs, up, out), (*xp.shape[1:], by, bz, run), xp.dtype)
    return out


def grid_mom_pap_packed(xp, coeffs, T: int):
    """(out_grid [7, nx, ny, nz], mom [cs0, cs1, 3K, cs2], partials
    [ncubes]): the grid branch of A x with its mass terms, the per-cube
    moments of the reduced-masked s, and per-cube partials of <x, out_grid>."""
    res = tuple(xp.shape[1:])
    _cube_dims(res, T)
    dev = _check("grid_mom_pap_packed", (xp, coeffs), ((7,) + res, (N_COEFF,) + res))
    if dev == "cpu":
        return grid_mom_pap_packed_plain(xp, coeffs, T)
    return _grid_mom_pap_cuda(xp, coeffs, T, *grid_mom_plan(T))


def _grid_mom_pap_cuda(xp, coeffs, T: int, by: int, bz: int):
    """grid_mom_pap_packed's kernel at the column geometry (by, bz): each of
    a cube's (T / by) * (T / bz) blocks writes its own moments and partial,
    summed here over dim 0 (a fixed order) when there are several."""
    res = tuple(xp.shape[1:])
    cs = _cube_dims(res, T)
    lead = _cube_parts(T, by, bz)
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    mom = torch.empty(lead + (cs[0], cs[1], 3 * K, cs[2]), dtype=xp.dtype, device=xp.device)
    partials = torch.empty(lead + (cs[0] * cs[1] * cs[2],), dtype=xp.dtype, device=xp.device)
    _launch("grid_mom_pap", (xp, coeffs, out, mom, partials), (*res, T, by, bz), xp.dtype)
    if not lead:
        return out, mom, partials
    return out, mom.sum(dim=0), partials.sum(dim=0)


def finish_packed(coeffs, out_grid, up):
    """[7, nx, ny, nz] = out_grid + [G Dt]^T (-u), a new array."""
    res = tuple(out_grid.shape[1:])
    dev = _check("finish_packed", (coeffs, out_grid, up), ((N_COEFF,) + res, (7,) + res, (3,) + res))
    if dev == "cpu":
        return finish_packed_plain(coeffs, out_grid, up)
    out = torch.empty((7,) + res, dtype=out_grid.dtype, device=out_grid.device)
    _launch("finish", (coeffs, out_grid, up, out), res, out_grid.dtype)
    return out


def _coeff_channels(name, coeffs):
    """The channel count of a coefficient stack for a kernel that reads no
    reduced-face mask: the 14-channel uniform stack or the 17-channel one
    (such kernels read channels 0-13 at most)."""
    n = coeffs.shape[0]
    if n not in (N_COEFF_UNIFORM, N_COEFF):
        raise ValueError(f"{name}: expected {N_COEFF_UNIFORM} or {N_COEFF} coefficient channels, got {n}")
    return n


def apply_uniform_packed(xp, coeffs):
    """[7, nx, ny, nz] = the uniform A x."""
    res = tuple(xp.shape[1:])
    n = _coeff_channels("apply_uniform_packed", coeffs)
    dev = _check("apply_uniform_packed", (xp, coeffs), ((7,) + res, (n,) + res))
    if dev == "cpu":
        return apply_uniform_packed_plain(xp, coeffs)
    return _apply_uniform_cuda(xp, coeffs, *uniform_plan(res), pap=False)


def apply_uniform_pap_packed(xp, coeffs):
    """(A x [7, nx, ny, nz], partials): the uniform A x and the partials of
    <x, A x>, one per block of ``uniform_plan(res)``."""
    res = tuple(xp.shape[1:])
    n = _coeff_channels("apply_uniform_pap_packed", coeffs)
    dev = _check("apply_uniform_pap_packed", (xp, coeffs), ((7,) + res, (n,) + res))
    if dev == "cpu":
        return apply_uniform_pap_packed_plain(xp, coeffs)
    return _apply_uniform_cuda(xp, coeffs, *uniform_plan(res), pap=True)


def _apply_uniform_cuda(xp, coeffs, by: int, bz: int, run: int, pap: bool):
    """The uniform apply kernel at the geometry (by, bz, run): A x, and with
    pap also its partials, one per block in (run, y column, z column)
    order."""
    res = tuple(xp.shape[1:])
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    if not pap:
        _launch("apply_uniform", (xp, coeffs, out), (*res, by, bz, run), xp.dtype)
        return out
    blocks = -(-res[0] // run) * -(-res[1] // by) * -(-res[2] // bz)
    partials = torch.empty((blocks,), dtype=xp.dtype, device=xp.device)
    _launch("apply_uniform_pap", (xp, coeffs, out, partials), (*res, by, bz, run), xp.dtype)
    return out, partials


def transpose_u_packed(coeffs, up):
    """[7, nx, ny, nz] = [G Dt]^T u on face values u [3, nx, ny, nz]: no
    mass terms, no grid branch (the REGION_ARROW solve's transpose leg)."""
    res = tuple(up.shape[1:])
    n = _coeff_channels("transpose_u_packed", coeffs)
    dev = _check("transpose_u_packed", (coeffs, up), ((n,) + res, (3,) + res))
    if dev == "cpu":
        return transpose_u_packed_plain(coeffs, up)
    out = torch.empty((7,) + res, dtype=up.dtype, device=up.device)
    _launch("transpose_u", (coeffs, up, out), res, up.dtype)
    return out


def forward_s_packed(xp, coeffs):
    """[3, nx, ny, nz] = [G Dt] x on all faces (slot space)."""
    res = tuple(xp.shape[1:])
    n = _coeff_channels("forward_s_packed", coeffs)
    dev = _check("forward_s_packed", (xp, coeffs), ((7,) + res, (n,) + res))
    if dev == "cpu":
        return forward_s_packed_plain(xp, coeffs)
    s = torch.empty((3,) + res, dtype=xp.dtype, device=xp.device)
    _launch("forward_s", (xp, coeffs, s), res, xp.dtype)
    return s


def combine_packed(xp, coeffs, sp, up):
    """[7, nx, ny, nz] = [G Dt]^T (-dt McInv s - u) minus the mass terms,
    from the forward values s and the expanded u."""
    res = tuple(xp.shape[1:])
    n = _coeff_channels("combine_packed", coeffs)
    dev = _check("combine_packed", (xp, coeffs, sp, up), ((7,) + res, (n,) + res, (3,) + res, (3,) + res))
    if dev == "cpu":
        return combine_packed_plain(xp, coeffs, sp, up)
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    _launch("combine", (xp, coeffs, sp, up, out), res, xp.dtype)
    return out


def _update_inputs(name, xp, rp, pp, alpha, factors, kind, extra, extra_shapes, out=None):
    """Checks shared by the update wrappers; returns (device type, alpha as
    a one-element tensor on xp's device).  ``out``, when given, is the pair
    (x', r') of packed tensors the update writes, apart from every input."""
    if kind not in UPDATE_KINDS:
        raise ValueError(f"{name}: kind must be one of {tuple(UPDATE_KINDS)}, got {kind!r}")
    res = tuple(xp.shape[1:])
    n_f = _KIND_CHANNELS[kind]
    if (factors is None) != (n_f is None):
        raise ValueError(f"{name}: kind {kind!r} takes {'no factors' if n_f is None else f'{n_f} factor channels'}")
    tensors = [xp, rp, pp, *extra] + ([] if factors is None else [factors])
    shapes = [(7,) + res] * 3 + list(extra_shapes) + ([] if n_f is None else [(n_f,) + res])
    if out is not None:
        inputs = {t.data_ptr() for t in tensors}
        if len(out) != 2 or out[0].data_ptr() == out[1].data_ptr() or any(t.data_ptr() in inputs for t in out):
            raise ValueError(f"{name}: out must be two tensors apart from each other and from the inputs")
        tensors, shapes = tensors + list(out), shapes + [(7,) + res] * 2
    dev = _check(name, tensors, shapes)
    return dev, torch.as_tensor(alpha, dtype=xp.dtype, device=xp.device).reshape(1)


def _into(out, result):
    """The twin's 6-tuple with x' and r' copied into ``out`` when given."""
    if out is None:
        return result
    out[0].copy_(result[0])
    out[1].copy_(result[1])
    return (out[0], out[1]) + tuple(result[2:])


def _run_update(name, tensors, ints, xp, kind, out=None):
    """Launch an update kernel on (alpha, inputs..., factors) and return the
    JAX 6-tuple, x' and r' in ``out`` when given; the [3, blocks] dot
    partials are summed in a fixed order."""
    xo, ro = (torch.empty_like(xp), torch.empty_like(xp)) if out is None else out
    zo = torch.empty_like(xp)
    partials = torch.empty((3, -(-xp[0].numel() // PAP_BLOCK)), dtype=xp.dtype, device=xp.device)
    _launch(name, (*tensors, xo, ro, zo, partials), (*tuple(xp.shape[1:]), *ints, UPDATE_KINDS[kind]), xp.dtype)
    sums = torch.sum(partials, dim=1)
    return xo, ro, zo, sums[0], sums[1], sums[2]


def cg_update_packed(xp, rp, pp, app, alpha, factors=None, kind="none", out=None):
    """(x', r', z, <r',r'>, <x',x'>, <r',z>): x' = x + alpha p, r' = r -
    alpha Ap, z = M^-1 r' for the preconditioner ``kind`` with its
    ``factors`` ([13, ...] arrow, [7, ...] diagonal inverse, None); alpha
    is a 0-dim tensor on the device, read there by the kernel.  ``out``
    (x', r') names the tensors x' and r' are written to, else new ones."""
    res = tuple(xp.shape[1:])
    dev, a = _update_inputs("cg_update_packed", xp, rp, pp, alpha, factors, kind, (app,), ((7,) + res,), out)
    if dev == "cpu":
        return _into(out, cg_update_packed_plain(xp, rp, pp, app, a[0], factors, kind))
    return _run_update("cg_update", (a, xp, rp, pp, app, factors), (), xp, kind, out)


def finish_update_packed(xp, rp, pp, alpha, coeffs, out_grid, up, factors=None, kind="none", out=None):
    """cg_update_packed with Ap = out_grid + [G Dt]^T (-u), finished in the
    kernel from the deferred (out_grid, u) pair."""
    res = tuple(xp.shape[1:])
    n = _coeff_channels("finish_update_packed", coeffs)
    dev, a = _update_inputs("finish_update_packed", xp, rp, pp, alpha, factors, kind, (coeffs, out_grid, up),
                            ((n,) + res, (7,) + res, (3,) + res), out)
    if dev == "cpu":
        return _into(out, finish_update_packed_plain(xp, rp, pp, a[0], coeffs, out_grid, up, factors, kind))
    return _run_update("finish_update", (a, coeffs, out_grid, up, xp, rp, pp, factors), (), xp, kind, out)


def exp_finish_update_packed(xp, rp, pp, alpha, coeffs, out_grid, v_origin, T: int, factors=None, kind="none",
                             out=None):
    """finish_update_packed with u expanded in the kernel from the per-cube
    polynomial coefficients v [cs0, cs1, 3K, cs2] on the reduced-face masks
    of the 17-channel stack: u never reaches device memory."""
    res = tuple(xp.shape[1:])
    cs = _cube_dims(res, T)
    dev, a = _update_inputs("exp_finish_update_packed", xp, rp, pp, alpha, factors, kind, (coeffs, out_grid, v_origin),
                            ((N_COEFF,) + res, (7,) + res, (cs[0], cs[1], 3 * K, cs[2])), out)
    if dev == "cpu":
        return _into(out, exp_finish_update_packed_plain(xp, rp, pp, a[0], coeffs, out_grid, v_origin, T, factors,
                                                         kind))
    return _run_update("exp_finish_update", (a, coeffs, v_origin, out_grid, xp, rp, pp, factors), (T,), xp, kind,
                       out)
