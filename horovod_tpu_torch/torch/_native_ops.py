"""The PyTorch dispatcher ops of the native core: the port of
``horovod_tpu/torch/_native_ops.py``.

``horovod_tpu_torch/csrc/torch_ops.cc`` registers ``torch.ops.hvd.
allreduce``, ``allreduce_``, ``broadcast``, ``allgather`` and
``grouped_allreduce``, CPU kernels that enqueue straight into the C++
engine and wait on it (the reference's ``mpi_ops_v2.cc`` mechanism); being
dispatcher ops, ``torch.compile`` traces them as calls, not graph breaks.
The library is built at first use against the installed torch's headers
(``common/native_build.py``; ``_GLIBCXX_USE_CXX11_ABI`` taken from this
torch) and loaded with ``torch.ops.load_library``.

:func:`available` re-checks its preconditions at every call (the native
engine runs in this process, ``HVD_TORCH_NATIVE_OPS`` is not ``0``); only
a failed build or load latches.  Callers keep the eager engine's numpy
path for everything else: CUDA tensors, compression, the Python engine.
"""

from __future__ import annotations

import collections
import os
import threading

from horovod_tpu_torch.common import native_build

_lock = threading.Lock()
_loaded = False
_failed = False
# Calls routed to each dispatcher op (by op name), counted where the
# Python callers route them: what a run went through.
dispatched = collections.Counter()

SRC = "torch_ops.cc"
# The dtypes torch_ops.cc's MapDtype takes.
SUPPORTED_DTYPES = frozenset({
    "torch.float32", "torch.float64", "torch.float16", "torch.bfloat16",
    "torch.float8_e4m3fn", "torch.float8_e5m2", "torch.int8",
    "torch.uint8", "torch.int16", "torch.int32", "torch.int64",
    "torch.bool"})


def _flags():
    """(compile flags, link flags, hash key) for this torch."""
    import torch
    import torch.utils.cpp_extension as ce

    abi = int(getattr(torch._C, "_GLIBCXX_USE_CXX11_ABI", True))
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    flags = [*(f"-I{p}" for p in ce.include_paths()),
             f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    links = [f"-L{torch_lib}", "-ltorch", "-ltorch_cpu", "-lc10",
             f"-Wl,-rpath,{torch_lib}"]
    return flags, links, (torch.__version__, *flags, *links)


def library_path() -> str:
    """The library's path for this torch and the current sources (built
    or not)."""
    return native_build.ops_path(SRC, _flags()[2])


def available() -> bool:
    """True when ``torch.ops.hvd.*`` can serve this process's engine."""
    global _loaded, _failed
    if os.environ.get("HVD_TORCH_NATIVE_OPS", "1") == "0":
        return False
    if not native_build.native_engine_active():
        return False
    if _loaded or _failed:
        return _loaded
    with _lock:
        if _loaded or _failed:
            return _loaded
        try:
            load()
            _loaded = True
        except Exception as e:
            _failed = True
            from horovod_tpu_torch.utils.logging import get_logger

            get_logger().warning("torch dispatcher ops unavailable: %s", e)
    return _loaded


def load() -> str:
    """Build (at first use) and load the library; returns its path."""
    import torch

    flags, links, key = _flags()
    path = native_build.build_ops(SRC, flags, links, key)
    torch.ops.load_library(path)
    return path
