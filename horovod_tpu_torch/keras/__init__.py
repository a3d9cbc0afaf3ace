"""Keras front-end: ``import horovod_tpu_torch.keras as hvd``.  The port
of ``horovod_tpu/keras/__init__.py``.

Role parity: ``horovod/keras/__init__.py`` + ``horovod/_keras`` — the
Keras training surface: ``DistributedOptimizer`` (gradient allreduce
before apply), broadcast/metric/LR-warmup callbacks, and ``load_model``
that rewraps the optimizer.  Built for Keras 3; with the TF backend the
collectives run through the port's TensorFlow front-end
(``horovod_tpu_torch.tensorflow``), whose ops ride the port's eager
engine.  ``init`` is ``horovod_tpu_torch.basics.init`` (``device="cpu"``
where there is no card).  Nothing is left out.
"""

from __future__ import annotations

import keras

from horovod_tpu_torch.basics import (  # noqa: F401
    cache_stats,
    cross_rank,
    cross_size,
    cuda_built,
    gloo_built,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
    xla_built,
)
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.keras import callbacks  # noqa: F401
from horovod_tpu_torch.keras.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
)

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM


def _tf_surface():
    from horovod_tpu_torch import tensorflow as hvd_tf

    return hvd_tf


def allreduce(value, name=None, average=True):
    """Eager allreduce of a numpy/backend tensor (keras surface parity:
    keras/__init__.py allreduce)."""
    from horovod_tpu_torch.ops import eager

    import numpy as np

    return eager.allreduce(np.asarray(value), average=average, name=name)


def allgather(value, name=None):
    from horovod_tpu_torch.ops import eager

    import numpy as np

    return eager.allgather(np.asarray(value), name=name)


def broadcast(value, root_rank=0, name=None):
    from horovod_tpu_torch.ops import eager

    import numpy as np

    return eager.broadcast(np.asarray(value), root_rank=root_rank,
                           name=name)


def DistributedOptimizer(optimizer, name=None,
                         device_dense="", device_sparse="",
                         compression=None, op=ReduceOp.AVERAGE,
                         backward_passes_per_step=1,
                         average_aggregated_gradients=False,
                         process_set=None):
    """Wraps a Keras optimizer so gradients are allreduced across ranks
    before being applied (parity: _keras/__init__.py:20-86 — dynamic
    subclass overriding the gradient-aggregation step).

    ``backward_passes_per_step=N`` aggregates gradients locally over N
    ``apply_gradients`` calls and allreduces+applies only on the Nth
    (intermediate calls leave variables untouched);
    ``average_aggregated_gradients=True`` divides the local sum by N
    before the allreduce — both exactly as on the TF surface
    (``horovod_tpu.tensorflow.DistributedOptimizer``).

    Supported with the TensorFlow Keras backend, whose trainer funnels
    through ``apply_gradients``.  The JAX and torch Keras backends
    bypass ``apply_gradients`` (``stateless_apply`` / ``apply``), so
    wrapping there would silently skip gradient synchronization — use
    the native ``horovod_tpu`` (JAX) or ``horovod_tpu.torch`` front-ends
    for those stacks instead."""
    backend = keras.backend.backend()
    if backend != "tensorflow":
        raise NotImplementedError(
            f"horovod_tpu_torch.keras.DistributedOptimizer supports the "
            f"tensorflow Keras backend; the current backend is "
            f"'{backend}', whose trainer does not route through "
            f"apply_gradients. Use horovod_tpu_torch.torch "
            f"directly.")
    hvd_tf = _tf_surface()
    comp = compression or hvd_tf.Compression.none
    return hvd_tf.DistributedOptimizer(
        optimizer, name=name, compression=comp, op=op,
        backward_passes_per_step=backward_passes_per_step,
        average_aggregated_gradients=average_aggregated_gradients,
        process_set=process_set)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Loads a Keras model and wraps its optimizer in
    ``DistributedOptimizer`` (parity: keras/__init__.py:117-148)."""
    model = keras.models.load_model(filepath,
                                    custom_objects=custom_objects)
    if getattr(model, "optimizer", None) is not None:
        model.optimizer = DistributedOptimizer(model.optimizer,
                                               compression=compression)
    return model


def __getattr__(name):
    # ``Compression`` must be the TF-surface compressor (it handles
    # tf.Tensors; the base ops.compression one is the engine's and crashes
    # on them) — resolved lazily so importing this module stays valid
    # on non-TF Keras backends.  Parity: reference keras/__init__.py:28.
    if name == "Compression":
        return _tf_surface().Compression
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
