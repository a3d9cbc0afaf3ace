"""The TensorFlow custom-op library of the native core: the port of
``horovod_tpu/tensorflow/_native_ops.py``.

``horovod_tpu_torch/csrc/tf_ops.cc`` (the port's copy of the JAX
package's ``csrc/tf_ops.cc``) registers ``HvdAllreduce``,
``HvdGroupedAllreduce``, ``HvdBroadcast`` and ``HvdAllgather``: real graph
ops whose kernels enqueue straight into the C++ engine (the reference's
``tensorflow/mpi_ops.cc`` mechanism).  The library is built at first use
against the installed TensorFlow's compile and link flags by
``common/native_build.py`` (the build directory, hashed names, the lock),
linked to the port's core with an ``$ORIGIN`` rpath, and loaded with
``tf.load_op_library``.  ``HVD_TF_NATIVE_OPS=0`` opts out.

The preconditions (the switch, the native engine running in this process)
are checked again at every call: a collective issued before
``hvd.init()``, or a re-``init`` onto another engine, must not latch the
native path off.  Only a failed build or load latches.  While
:func:`lib` is ``None`` the front-end runs its ``tf.py_function`` path,
and :func:`reason` says why; a failed build or load is also logged.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from horovod_tpu_torch.common import native_build

_lock = threading.Lock()
_lib = None
_failed: Optional[str] = None
_reason: Optional[str] = "not loaded yet"

SRC = "tf_ops.cc"
# The dtypes of the ops' type lists in tf_ops.cc; every other dtype takes
# the py_function path, tensor by tensor.
SUPPORTED_DTYPES = frozenset({
    "float32", "float64", "float16", "bfloat16", "int32", "int64",
    "uint8", "int8", "bool"})


def _flags():
    """(compile flags, link flags, hash key) for this TensorFlow."""
    import tensorflow as tf

    flags = list(tf.sysconfig.get_compile_flags())
    links = list(tf.sysconfig.get_link_flags())
    return flags, links, (tf.__version__, *flags, *links)


def library_path() -> str:
    """The library's path for this TensorFlow and the current sources
    (built or not)."""
    return native_build.ops_path(SRC, _flags()[2])


def reason() -> Optional[str]:
    """Why :func:`lib` returned ``None`` at its last call (``None`` once
    the library serves)."""
    return _reason


def lib():
    """The loaded op library, or ``None`` while the native path is off."""
    global _lib, _failed, _reason
    if os.environ.get("HVD_TF_NATIVE_OPS", "1") == "0":
        _reason = "HVD_TF_NATIVE_OPS=0"
        return None
    if not native_build.native_engine_active():
        _reason = "the native engine does not run in this process"
        return None
    if _lib is None and _failed is None:
        with _lock:
            if _lib is None and _failed is None:
                try:
                    _lib = _load()
                except Exception as e:
                    _failed = f"build or load failed: {e}"
                    from horovod_tpu_torch.utils.logging import get_logger

                    get_logger().warning("tf native ops unavailable: %s", e)
    _reason = _failed if _lib is None else None
    return _lib


def _load():
    import tensorflow as tf

    flags, links, key = _flags()
    return tf.load_op_library(native_build.build_ops(SRC, flags, links,
                                                     key))
