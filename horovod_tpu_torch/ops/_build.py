"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``ops/csrc/`` have a plain C interface and include no
PyTorch header, so they build in seconds.  One nvcc compiles them into
one shared library,
``<repo>/build/horovod_tpu_torch/libhvd_torch_kernels_<srchash>.so``, named by
a hash of the sources and flags so that an edited source never loads a stale
library.  The build runs at first use, never at import: the CPU-only tests
import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "horovod_tpu_torch")
# No --use_fast_math: the accuracy of expf/logf is part of the parity
# tolerance against the plain PyTorch versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the build that produced the library

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, strides, B, S, H, D, scale, causal, dtype, out_f32,
    # stream
    "hvd_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                      _I, _P],
    # q, k, v, dO, lse, delta, dlse, dq, strides, B, S, H, D, scale,
    # causal, dtype, do_f32, stream
    "hvd_flash_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                     _I, _I, _I, _P],
    # q, k, v, dO, lse, delta, dlse, dk, dv, strides, B, S, H, D, scale,
    # causal, dtype, do_f32, stream
    "hvd_flash_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _F, _I, _I, _I, _P],
}


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels cannot be built")


def library_path() -> str:
    """The library's path, named by a hash of the flags and of every file
    under ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libhvd_torch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources into the shared library with one nvcc, unless a
    library of the same sources exists."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A per-process name, then an atomic rename: ranks that build at the
    # same time never load a half-written library.
    part = f"{out}.{os.getpid()}.part"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-shared", "-o", part] + sources()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(part, out)
    build_log = r.stdout + r.stderr
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib
