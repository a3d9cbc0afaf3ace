"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd; hvd.init()`` starts a process group
(NCCL on ``cuda:<local_rank>``, or gloo with ``hvd.init(device="cpu")``).
The port imports ``torch`` and never ``jax`` or the JAX package.
"""

from horovod_tpu_torch.basics import (device, init, is_initialized,
                                      local_rank, local_size, rank,
                                      shutdown, size)
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops.collective import (allgather, allreduce, barrier,
                                              broadcast, grouped_allreduce)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_lse)
from horovod_tpu_torch.parallel.optimizer import (DistributedOptimizer,
                                                  allreduce_gradients)
from horovod_tpu_torch.parallel.train import (TrainState,
                                              make_transformer_train_step)

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "device", "ReduceOp", "Average", "Sum", "Adasum", "Min",
    "Max", "Product", "allreduce", "grouped_allreduce", "allgather",
    "broadcast", "barrier", "Compression", "DistributedOptimizer",
    "allreduce_gradients", "flash_attention", "flash_attention_lse",
    "TrainState", "make_transformer_train_step",
]
