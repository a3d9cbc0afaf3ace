"""Loader of the native C++ core (``horovod_tpu_torch/csrc/``): the port
of ``horovod_tpu/native.py``.

:func:`load` builds the core at first use (``common/native_build.py``)
and binds its C API with ``ctypes``.  It raises :class:`NativeUnavailable`
when the core cannot be had (no compiler, a failed build) or when
``HVD_TPU_CORE=py`` (or ``python``) asks for the Python engine, so that
``hvd.init()`` falls back to ``PyEngine`` before any rendezvous traffic.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from horovod_tpu_torch.common import native_build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(ImportError):
    """The native core cannot run in this process."""


def forced_python() -> bool:
    """True when ``HVD_TPU_CORE`` asks for the Python engine."""
    return os.environ.get("HVD_TPU_CORE", "").lower() in ("py", "python")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.hvd_create.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_double, c.c_int64, c.c_double, c.c_double, c.c_int, c.c_int64,
        c.c_int, c.c_int,                          # hierarchical ar/ag
        c.c_int, c.c_int, c.c_int, c.c_int,        # autotune, tune f/c/c
        c.c_int, c.c_int,                          # tune hier ar/ag
        c.c_int, c.c_int, c.c_double,
        c.c_char_p, c.c_char_p, c.c_int,
    ]
    lib.hvd_create.restype = c.c_int
    lib.hvd_cache_stats.argtypes = [c.POINTER(c.c_int64)]
    lib.hvd_cache_stats.restype = None
    lib.hvd_shutdown.argtypes = []
    lib.hvd_shutdown.restype = None
    for name, restype in (("hvd_is_aborted", c.c_int),
                          ("hvd_last_error", c.c_char_p),
                          ("hvd_engine_handle", c.c_void_p),
                          ("hvd_join", c.c_int),
                          ("hvd_simd_available", c.c_int)):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = restype
    lib.hvd_allreduce_async.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.c_int, c.c_double, c.c_double, c.c_int, c.c_int,
    ]
    lib.hvd_allreduce_async.restype = c.c_int64
    lib.hvd_allgather_async.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.c_int, c.c_int,
    ]
    lib.hvd_allgather_async.restype = c.c_int64
    lib.hvd_broadcast_async.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.c_int, c.c_int, c.c_int,
    ]
    lib.hvd_broadcast_async.restype = c.c_int64
    lib.hvd_alltoall_async.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.POINTER(c.c_int64), c.c_int, c.c_int, c.c_int,
    ]
    lib.hvd_alltoall_async.restype = c.c_int64
    lib.hvd_reducescatter_async.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.c_int, c.c_int, c.c_int,
    ]
    lib.hvd_reducescatter_async.restype = c.c_int64
    lib.hvd_register_process_set.argtypes = [
        c.c_int, c.POINTER(c.c_int32), c.c_int,
    ]
    lib.hvd_register_process_set.restype = c.c_int64
    lib.hvd_poll.argtypes = [c.c_int64]
    lib.hvd_poll.restype = c.c_int
    lib.hvd_wait.argtypes = [c.c_int64]
    lib.hvd_wait.restype = c.c_int
    lib.hvd_handle_error.argtypes = [c.c_int64]
    lib.hvd_handle_error.restype = c.c_char_p
    lib.hvd_result_nbytes.argtypes = [c.c_int64]
    lib.hvd_result_nbytes.restype = c.c_int64
    lib.hvd_result_data.argtypes = [c.c_int64]
    lib.hvd_result_data.restype = c.c_void_p
    lib.hvd_result_splits.argtypes = [
        c.c_int64, c.POINTER(c.c_int64), c.c_int]
    lib.hvd_result_splits.restype = c.c_int
    lib.hvd_release.argtypes = [c.c_int64]
    lib.hvd_release.restype = None
    lib.hvd_barrier.argtypes = [c.c_int, c.c_int]
    lib.hvd_barrier.restype = c.c_int
    # The wire codecs, for their tests: fp8 <-> fp32 (kind 0 e4m3fn, 1
    # e5m2), and one hop's combine of ``n`` elements into ``dst``.
    lib.hvd_fp8_to_f32.argtypes = [c.c_int, c.c_void_p, c.c_void_p, c.c_int]
    lib.hvd_fp8_to_f32.restype = None
    lib.hvd_f32_to_fp8.argtypes = [c.c_int, c.c_void_p, c.c_void_p, c.c_int]
    lib.hvd_f32_to_fp8.restype = None
    lib.hvd_combine_into.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64,
                                     c.c_int, c.c_int]
    lib.hvd_combine_into.restype = None
    return lib


def load() -> ctypes.CDLL:
    """Build (at first use) and load the core; raises
    :class:`NativeUnavailable` when it cannot run here or when
    ``HVD_TPU_CORE`` asks for the Python engine."""
    global _lib
    if forced_python():
        raise NativeUnavailable("HVD_TPU_CORE forces the Python engine")
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = native_build.build_core()
        except (OSError, subprocess.SubprocessError, RuntimeError) as e:
            raise NativeUnavailable(f"cannot build the native core: {e}")
        _lib = _bind(ctypes.CDLL(path))
        return _lib
