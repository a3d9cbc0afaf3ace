"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd; hvd.init()`` starts a process group
(NCCL on ``cuda:<local_rank>``, or gloo with ``hvd.init(device="cpu")``)
and the eager engine.  The top level binds the JAX package's names:
``hvd.allreduce``, ``hvd.allgather``, ``hvd.broadcast``, ``hvd.barrier``
and the rest of the classic API are the eager engine's
(``ops/eager.py``); the mesh-axis forms are in
``horovod_tpu_torch.ops.collective``, where the JAX package keeps its own.
The classic torch front-end (hook-driven ``DistributedOptimizer`` over a
torch optimizer, in-place and autograd collectives) is
``import horovod_tpu_torch.torch as hvd``.
The port imports ``torch`` and never ``jax`` or the JAX package.

The names load on first use (PEP 562), so that a process that imports
only a submodule, the launcher ``python -m horovod_tpu_torch.runner.run``
among them, does not pay for importing ``torch``.
"""

import importlib

_NAMES = {
    "horovod_tpu_torch.basics": (
        "cache_stats", "cross_rank", "cross_size", "cuda_built", "device",
        "gloo_built", "init", "is_homogeneous", "is_initialized",
        "local_rank", "local_size", "metrics_snapshot", "mpi_built",
        "mpi_enabled", "mpi_threads_supported", "nccl_built", "rank",
        "rocm_built", "shutdown", "size", "xla_built"),
    "horovod_tpu_torch.common.types": (
        "CollectiveTimeoutError", "RanksFailedError", "ReduceOp",
        "ReplicaDivergenceError"),
    "horovod_tpu_torch.ops.compression": ("Compression",),
    "horovod_tpu_torch.ops.eager": (
        "allgather", "allgather_async", "allreduce", "allreduce_async",
        "alltoall", "alltoall_async", "barrier", "broadcast",
        "broadcast_async", "broadcast_object", "broadcast_parameters",
        "grouped_allreduce", "join", "poll", "reducescatter",
        "reducescatter_async", "sparse_allreduce", "synchronize"),
    "horovod_tpu_torch.ops.flash_attention": (
        "flash_attention", "flash_attention_lse"),
    "horovod_tpu_torch.parallel.multihost": ("init_torch_distributed",),
    "horovod_tpu_torch.parallel.optimizer": (
        "DistributedOptimizer", "allreduce_gradients", "distributed_grad",
        "distributed_value_and_grad"),
    "horovod_tpu_torch.process_sets": ("ProcessSet",),
    "horovod_tpu_torch.parallel.train": (
        "ResNetState", "TrainState", "make_mnist_train_step",
        "make_resnet_train_step", "make_resnet_train_step_hvd",
        "make_transformer_train_step"),
}
_WHERE = {name: mod for mod, names in _NAMES.items() for name in names}
# The reference-named ReduceOp constants.
_OPS = {"Average": "AVERAGE", "Sum": "SUM", "Adasum": "ADASUM",
        "Min": "MIN", "Max": "MAX", "Product": "PRODUCT"}
# Submodules bound at the top level: ``hvd.data`` (sampling and
# prefetch), ``hvd.elastic`` (``hvd.elastic.run``, ...).
_SUBMODULES = ("data", "elastic")


def __getattr__(name):
    if name in _WHERE:
        value = getattr(importlib.import_module(_WHERE[name]), name)
    elif name in _OPS:
        from horovod_tpu_torch.common.types import ReduceOp

        value = ReduceOp[_OPS[name]]
    elif name in _SUBMODULES:
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_WHERE) | set(_OPS)
                  | set(_SUBMODULES))


__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "device", "ReduceOp",
    "Average", "Sum", "Adasum", "Min", "Max", "Product", "allreduce",
    "allreduce_async", "grouped_allreduce", "allgather", "allgather_async",
    "broadcast", "broadcast_async", "broadcast_object",
    "broadcast_parameters", "alltoall", "alltoall_async", "reducescatter",
    "reducescatter_async", "sparse_allreduce", "barrier", "join", "poll",
    "synchronize", "cache_stats", "metrics_snapshot", "is_homogeneous", "nccl_built",
    "gloo_built", "mpi_built", "cuda_built", "rocm_built", "xla_built",
    "mpi_enabled", "mpi_threads_supported", "ProcessSet",
    "RanksFailedError", "CollectiveTimeoutError", "ReplicaDivergenceError",
    "Compression",
    "DistributedOptimizer", "allreduce_gradients", "distributed_grad",
    "distributed_value_and_grad", "flash_attention",
    "flash_attention_lse", "TrainState", "make_transformer_train_step",
    "ResNetState", "make_resnet_train_step", "make_resnet_train_step_hvd",
    "make_mnist_train_step", "init_torch_distributed", "elastic",
]
