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
  reduced apply (``csrc/packed_apply.cu``);
* ``grid_mom_pap_packed``, ``finish_packed``: the fused reduced apply that
  also returns <x, A x> (``fuse_pap``); ``apply_uniform_packed``,
  ``apply_uniform_pap_packed``: the uniform apply (``csrc/fused_apply.cu``).

``LAUNCHES`` counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes
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
PAP_BLOCK = 256  # slots per <x, A x> partial of apply_uniform_pap (the kernel's thread block)

LAUNCHES = {name: 0 for name in ("moments", "expand", "apply_reduced", "grid_mom_pap", "finish", "apply_uniform",
                                 "apply_uniform_pap")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _cube_sums(field, T: int):
    """[nx, ny, nz] -> [ncubes] per-cube sums, cubes in (c0, c1, c2) order."""
    nx, ny, nz = field.shape
    return field.reshape(nx // T, T, ny // T, T, nz // T, T).sum(dim=(1, 3, 5)).reshape(-1)


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
    return out, _moments_from_s(s, coeffs, T), _cube_sums((xp * out).sum(dim=0), T)


def finish_packed_plain(coeffs, out_grid, up):
    """out_grid + [G Dt]^T (-u): the reduced branch, no mass terms."""
    return out_grid + _transpose_contrib(coeffs, [-up[a] for a in range(3)])


def apply_uniform_packed_plain(xp, coeffs):
    """The uniform A x: [7, nx, ny, nz]."""
    return _transpose_out(xp, coeffs, _grid_w(coeffs, _forward_s(xp, coeffs)))


def apply_uniform_pap_packed_plain(xp, coeffs):
    """(A x, partials): the uniform A x and the partials of <x, A x> over
    runs of PAP_BLOCK consecutive slots."""
    out = apply_uniform_packed_plain(xp, coeffs)
    dots = (xp * out).sum(dim=0).reshape(-1)
    dots = torch.nn.functional.pad(dots, (0, -dots.numel() % PAP_BLOCK))
    return out, dots.reshape(-1, PAP_BLOCK).sum(dim=1)


# ---------------------------------------------------------------------------
# The CUDA library: built with nvcc on first use, loaded with ctypes
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "polystokes_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None
# (entry point, pointer arguments, int arguments) of each kernel; every
# entry point also takes the stream and exists for f32 and f64
_SIGNATURES = (("moments", 3, 4), ("expand", 3, 4), ("apply_reduced", 4, 3), ("grid_mom_pap", 5, 4),
               ("finish", 4, 3), ("apply_uniform", 3, 3), ("apply_uniform_pap", 4, 3))


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
        _LIB = lib
    return _LIB


def _launch(name: str, tensors, ints, dtype):
    fn = getattr(_library(), f"ps_{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    device = tensors[0].device
    with torch.cuda.device(device):  # the runtime launches on the current device
        err = fn(*[t.data_ptr() for t in tensors], *ints, torch.cuda.current_stream(device).cuda_stream)
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


def moments_packed(xp, coeffs, T: int):
    """[cs0, cs1, 3K, cs2] per-cube moments of the reduced-masked s."""
    res = tuple(xp.shape[1:])
    cs = _cube_dims(res, T)
    dev = _check("moments_packed", (xp, coeffs), ((7,) + res, (N_COEFF,) + res))
    if dev == "cpu":
        return moments_packed_plain(xp, coeffs, T)
    mom = torch.empty((cs[0], cs[1], 3 * K, cs[2]), dtype=xp.dtype, device=xp.device)
    _launch("moments", (xp, coeffs, mom), (*res, T), xp.dtype)
    return mom


def expand_packed(v_origin, red_packed, T: int):
    """[3, nx, ny, nz] region polynomials on the reduced faces."""
    res = tuple(red_packed.shape[1:])
    cs = _cube_dims(res, T)
    dev = _check("expand_packed", (v_origin, red_packed), ((cs[0], cs[1], 3 * K, cs[2]), (3,) + res))
    if dev == "cpu":
        return expand_packed_plain(v_origin, red_packed, T)
    u = torch.empty((3,) + res, dtype=v_origin.dtype, device=v_origin.device)
    _launch("expand", (v_origin, red_packed, u), (*res, T), v_origin.dtype)
    return u


def apply_reduced_packed(xp, coeffs, up):
    """[7, nx, ny, nz] = the reduced A x given the expanded u."""
    res = tuple(xp.shape[1:])
    dev = _check("apply_reduced_packed", (xp, coeffs, up), ((7,) + res, (N_COEFF,) + res, (3,) + res))
    if dev == "cpu":
        return apply_reduced_packed_plain(xp, coeffs, up)
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    _launch("apply_reduced", (xp, coeffs, up, out), res, xp.dtype)
    return out


def grid_mom_pap_packed(xp, coeffs, T: int):
    """(out_grid [7, nx, ny, nz], mom [cs0, cs1, 3K, cs2], partials
    [ncubes]): the grid branch of A x with its mass terms, the per-cube
    moments of the reduced-masked s, and per-cube partials of <x, out_grid>."""
    res = tuple(xp.shape[1:])
    cs = _cube_dims(res, T)
    dev = _check("grid_mom_pap_packed", (xp, coeffs), ((7,) + res, (N_COEFF,) + res))
    if dev == "cpu":
        return grid_mom_pap_packed_plain(xp, coeffs, T)
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    mom = torch.empty((cs[0], cs[1], 3 * K, cs[2]), dtype=xp.dtype, device=xp.device)
    partials = torch.empty((cs[0] * cs[1] * cs[2],), dtype=xp.dtype, device=xp.device)
    _launch("grid_mom_pap", (xp, coeffs, out, mom, partials), (*res, T), xp.dtype)
    return out, mom, partials


def finish_packed(coeffs, out_grid, up):
    """[7, nx, ny, nz] = out_grid + [G Dt]^T (-u), a new array."""
    res = tuple(out_grid.shape[1:])
    dev = _check("finish_packed", (coeffs, out_grid, up), ((N_COEFF,) + res, (7,) + res, (3,) + res))
    if dev == "cpu":
        return finish_packed_plain(coeffs, out_grid, up)
    out = torch.empty((7,) + res, dtype=out_grid.dtype, device=out_grid.device)
    _launch("finish", (coeffs, out_grid, up, out), res, out_grid.dtype)
    return out


def _uniform_stack(name, coeffs):
    """The channel count of a coefficient stack the uniform kernels take:
    the 14-channel uniform stack or the 17-channel one (they read 0-13)."""
    n = coeffs.shape[0]
    if n not in (N_COEFF_UNIFORM, N_COEFF):
        raise ValueError(f"{name}: expected {N_COEFF_UNIFORM} or {N_COEFF} coefficient channels, got {n}")
    return n


def apply_uniform_packed(xp, coeffs):
    """[7, nx, ny, nz] = the uniform A x."""
    res = tuple(xp.shape[1:])
    n = _uniform_stack("apply_uniform_packed", coeffs)
    dev = _check("apply_uniform_packed", (xp, coeffs), ((7,) + res, (n,) + res))
    if dev == "cpu":
        return apply_uniform_packed_plain(xp, coeffs)
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    _launch("apply_uniform", (xp, coeffs, out), res, xp.dtype)
    return out


def apply_uniform_pap_packed(xp, coeffs):
    """(A x [7, nx, ny, nz], partials): the uniform A x and the partials of
    <x, A x>, one per PAP_BLOCK consecutive slots."""
    res = tuple(xp.shape[1:])
    n = _uniform_stack("apply_uniform_pap_packed", coeffs)
    dev = _check("apply_uniform_pap_packed", (xp, coeffs), ((7,) + res, (n,) + res))
    if dev == "cpu":
        return apply_uniform_pap_packed_plain(xp, coeffs)
    out = torch.empty((7,) + res, dtype=xp.dtype, device=xp.device)
    partials = torch.empty((-(-xp[0].numel() // PAP_BLOCK),), dtype=xp.dtype, device=xp.device)
    _launch("apply_uniform_pap", (xp, coeffs, out, partials), res, xp.dtype)
    return out, partials
