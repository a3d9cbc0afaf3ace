"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``ops/csrc/`` have a plain C interface and include no
PyTorch header, so they build in seconds.  One nvcc per source, all started
together, compiles them to objects, and one more links the objects into one
shared library,
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
    # q, k, v (or their hi planes), their lower planes (an array: q mid,
    # q lo, k mid, k lo, v mid, v lo; or null), o, lse, strides, B, S, H, D,
    # scale, causal, dtype, out_f32, stream
    "hvd_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                      _I, _I, _P],
    # q, k, v (or their hi planes), their and dO's lower planes (an array:
    # q mid, q lo, k mid, k lo, v mid, v lo, dO mid, dO lo; or null), dO (or
    # its hi plane), dO's lo plane (bf16 q/k/v with an fp32 dO; or null),
    # lse, delta, dlse, dq, strides, B, S, H, D, scale, causal, dtype, stream
    "hvd_flash_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _F, _I, _I, _P],
    # as hvd_flash_dq, with dk, dv in place of dq
    "hvd_flash_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      _I, _I, _I, _F, _I, _I, _P],
    # number of inputs, their fp32 bases (an array), their (b, s, h)
    # strides, B, S, H, D, planes per input (2 or 3), the bf16 planes
    # [n, planes, B, S, H, D], stream
    "hvd_flash_split": [_I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
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
    """Compile the sources into the shared library, one nvcc per source in
    parallel and one to link, unless a library of the same sources
    exists."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-process names, then an atomic rename: ranks that build at the
    # same time never load a half-written library.
    tag = f"{os.getpid()}.part"
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [_nvcc()] + NVCC_FLAGS + ["-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    part = f"{out}.{tag}"
    link = [_nvcc()] + NVCC_FLAGS + ["-shared", "-o", part] + objs
    if all(rc == 0 for _, _, rc in logs):
        r = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, r.stdout + r.stderr, r.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    for cmd, text, rc in logs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
    os.replace(part, out)
    build_log = "".join(text for _, text, _ in logs)
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
