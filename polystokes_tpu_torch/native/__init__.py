"""ctypes binding of the port's host helpers, its copy of the JAX
package's native library: the union-find connected components
(``union_find.cpp``) and the MatrixMarket writers (``mtx_writer.cpp``).

The shared library is built from both sources with ``g++ -O3 -shared
-fPIC`` at first use into ``build/polystokes_tpu_torch/native-<hash>/``
(git-ignored), keyed by a hash of the sources and flags, and loaded with
ctypes, as ``packed_apply.build_kernels`` builds the CUDA library.  Where
g++ is missing or the build fails, ``connected_components_host`` returns
None and the caller takes the scipy form (``classify._numpy_cc``), and the
writers return False, as the JAX package's do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRCS = tuple(Path(__file__).resolve().parent / name for name in ("union_find.cpp", "mtx_writer.cpp"))
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "polystokes_tpu_torch"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> Optional[Path]:
    """The library's path, built if it is not there yet; None where g++
    is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    digest = hashlib.sha256((" ".join(_FLAGS) + "\n").encode() + b"".join(s.read_bytes() for s in _SRCS)).hexdigest()[:16]
    lib = _BUILD_ROOT / f"native-{digest}" / "libpolystokes_native.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *_FLAGS, *map(str, _SRCS), "-o", str(tmp)], capture_output=True, text=True, check=False)
    if res.returncode != 0:
        return None
    tmp.replace(lib)  # atomic: concurrent builds each write their own tmp
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.ps_connected_components.restype = ctypes.c_int64
    lib.ps_connected_components.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ps_write_mtx.restype = ctypes.c_int
    lib.ps_write_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_double)]
    lib.ps_write_mtx_vector.restype = ctypes.c_int
    lib.ps_write_mtx_vector.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def connected_components_host(labels: np.ndarray, fwx: np.ndarray, fwy: np.ndarray, fwz: np.ndarray):
    """Union-find components of REDUCED cells on the host: (regions int32,
    count), or None when the library is unavailable.  The labels go in as
    int8 and the face weights as float32, as in the JAX package."""
    lib = get_lib()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, dtype=np.int8)
    fwx = np.ascontiguousarray(fwx, dtype=np.float32)
    fwy = np.ascontiguousarray(fwy, dtype=np.float32)
    fwz = np.ascontiguousarray(fwz, dtype=np.float32)
    nx, ny, nz = labels.shape
    out = np.empty(labels.shape, dtype=np.int32)
    count = lib.ps_connected_components(_ptr(labels, ctypes.c_int8), _ptr(fwx, ctypes.c_float),
                                        _ptr(fwy, ctypes.c_float), _ptr(fwz, ctypes.c_float), nx, ny, nz,
                                        _ptr(out, ctypes.c_int32))
    return out, int(count)


def write_mtx(path: str, m) -> bool:
    """MatrixMarket export of a scipy sparse matrix via the native writer;
    False where the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    coo = m.tocoo()
    rows = np.ascontiguousarray(coo.row, dtype=np.int64)
    cols = np.ascontiguousarray(coo.col, dtype=np.int64)
    vals = np.ascontiguousarray(coo.data, dtype=np.float64)
    rc = lib.ps_write_mtx(str(path).encode(), coo.shape[0], coo.shape[1], coo.nnz, _ptr(rows, ctypes.c_int64),
                          _ptr(cols, ctypes.c_int64), _ptr(vals, ctypes.c_double))
    return rc == 0


def write_mtx_vector(path: str, v: np.ndarray) -> bool:
    """MatrixMarket array export of a vector via the native writer; False
    where the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    v = np.ascontiguousarray(v, dtype=np.float64).ravel()
    return lib.ps_write_mtx_vector(str(path).encode(), v.size, _ptr(v, ctypes.c_double)) == 0
