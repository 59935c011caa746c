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
10 0.5*uinv_c | 11-13 0.5*uinv_e | 14-16 reduced-face masks.  The stack is
unpadded: the CUDA kernels read a zero for every out-of-range neighbour.

Kernels
-------
``moments_packed``, ``expand_packed`` and ``apply_reduced_packed`` take a
CPU tensor to their plain PyTorch twin (``*_plain``) and a CUDA tensor to
the hand-written kernel in ``csrc/packed_apply.cu``, built with nvcc for
sm_90a into ``build/polystokes_tpu_torch/`` on first use and loaded with
ctypes.  ``LAUNCHES`` counts the kernel launches of each wrapper.
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
K = 10  # quadratic monomials per axis

LAUNCHES = {"moments": 0, "expand": 0, "apply_reduced": 0}


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


def pack_coeffs(asm, cls) -> torch.Tensor:
    """Assembled -> the unpadded [17, nx, ny, nz] pre-scaled coefficient
    stack (the JAX package's ``pack_coeffs(..., pad=False)``)."""
    dtype = asm.clw_s.dtype
    chans = [asm.clw_s]
    chans += [_edge_to_slot(asm.elw_s[e], e) for e in range(3)]
    chans += [_face_to_slot(asm.ffw[a], a) for a in range(3)]
    chans += [_face_to_slot(asm.dt * asm.mc_inv[a], a) for a in range(3)]
    chans += [0.5 * asm.uinv_c]
    chans += [_edge_to_slot(0.5 * asm.uinv_e[e], e) for e in range(3)]
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


def _transpose_out(x, c, w):
    """The 7 output channels from face values w, with the mass terms."""
    w = [c[C_FFW + a] * w[a] for a in range(3)]
    dsum = [shift(w[a], unit(a, -1)) - w[a] for a in range(3)]
    clw = c[C_CLW]
    out = [clw * (dsum[0] + dsum[1] + dsum[2])]
    out += [-clw * dsum[a] - c[C_UINV2C] * x[1 + a] for a in range(3)]
    for e in range(3):
        p_ax, q_ax = EDGE_OFFSET_AXES[e]
        acc = sum(shift(w[a], unit(3 - a - e, 1)) - w[a] for a in (p_ax, q_ax))
        out.append(c[C_ELW + e] * acc - c[C_UINV2E + e] * x[4 + e])
    return torch.stack(out, dim=0)


def _local_monomials(T: int, a: int, like):
    """[K, T, T, T] monomials at cube-local face positions (+0.5 on axis a)."""
    loc = torch.arange(T, dtype=like.dtype, device=like.device)
    pos = [loc[:, None, None], loc[None, :, None], loc[None, None, :]]
    pos[a] = pos[a] + 0.5
    return torch.stack([m.expand(T, T, T) for m in monomials_xyz(*pos)], dim=0)


def moments_packed_plain(xp, coeffs, T: int):
    """Per-cube monomial moments about the cube origin of the reduced-
    masked s: [cs0, cs1, 3K, cs2]."""
    nx, ny, nz = xp.shape[1:]
    s = _forward_s(xp, coeffs)
    rows = []
    for a in range(3):
        sm = (s[a] * coeffs[C_RED + a]).reshape(nx // T, T, ny // T, T, nz // T, T)
        rows.append(torch.einsum("aibjck,mijk->abmc", sm, _local_monomials(T, a, xp)))
    return torch.cat(rows, dim=2)


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
    w = [-coeffs[C_DTMCINV + a] * s[a] - up[a] for a in range(3)]
    return _transpose_out(xp, coeffs, w)


# ---------------------------------------------------------------------------
# The CUDA library: built with nvcc on first use, loaded with ctypes
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "polystokes_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")
    return path


def build_kernels():
    """Compile csrc/ into a shared library keyed by a hash of the sources
    and flags (an edit rebuilds it).  Returns (path, seconds spent
    compiling, ptxas report); seconds is 0.0 when the library existed."""
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
    tmp = out_dir / f"lib.{time.monotonic_ns()}.so"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp)] + [str(s) for s in sources if s.suffix == ".cu"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    tmp.replace(lib)
    return lib, seconds, res.stdout + res.stderr


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for dt in ("f32", "f64"):
            for name, n_ptr, n_int in (("moments", 3, 4), ("expand", 3, 4), ("apply_reduced", 4, 3)):
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
