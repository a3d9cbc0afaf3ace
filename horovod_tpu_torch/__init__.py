"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd; hvd.init()`` starts a process group
(NCCL on ``cuda:<local_rank>``, or gloo with ``hvd.init(device="cpu")``)
and the eager engine.  The top level binds the JAX package's names:
``hvd.allreduce``, ``hvd.allgather``, ``hvd.broadcast``, ``hvd.barrier``
and the rest of the classic API are the eager engine's
(``ops/eager.py``); the mesh-axis forms are in
``horovod_tpu_torch.ops.collective``, where the JAX package keeps its own.
The port imports ``torch`` and never ``jax`` or the JAX package.
"""

from horovod_tpu_torch import data  # noqa: F401  (sampling + prefetch)
from horovod_tpu_torch import elastic  # noqa: F401  (hvd.elastic.run, ...)
from horovod_tpu_torch.basics import (cache_stats, cross_rank, cross_size,
                                      cuda_built, device, gloo_built, init,
                                      is_homogeneous, is_initialized,
                                      local_rank, local_size,
                                      metrics_snapshot, mpi_built,
                                      mpi_enabled, mpi_threads_supported,
                                      nccl_built, rank, rocm_built,
                                      shutdown, size, xla_built)
from horovod_tpu_torch.common.types import (CollectiveTimeoutError,
                                            RanksFailedError, ReduceOp,
                                            ReplicaDivergenceError)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.eager import (allgather, allgather_async,
                                         allreduce, allreduce_async,
                                         alltoall, alltoall_async, barrier,
                                         broadcast, broadcast_async,
                                         broadcast_object,
                                         broadcast_parameters,
                                         grouped_allreduce, join, poll,
                                         reducescatter, reducescatter_async,
                                         sparse_allreduce, synchronize)
from horovod_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_lse)
from horovod_tpu_torch.parallel.multihost import init_torch_distributed
from horovod_tpu_torch.parallel.optimizer import (DistributedOptimizer,
                                                  allreduce_gradients,
                                                  distributed_grad,
                                                  distributed_value_and_grad)
from horovod_tpu_torch.process_sets import ProcessSet
from horovod_tpu_torch.parallel.train import (ResNetState, TrainState,
                                              make_mnist_train_step,
                                              make_resnet_train_step,
                                              make_resnet_train_step_hvd,
                                              make_transformer_train_step)

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

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
