"""Types the port shares across modules.

The port's copy of what it needs from ``horovod_tpu/common/types.py``
(``ReduceOp``, with the same values); the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    """Reduction semantics of an allreduce: Average / Sum / Adasum / Min /
    Max / Product, numbered as in the JAX package."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


class NotInitializedError(ValueError):
    """A collective or rank query ran before ``horovod_tpu_torch.init()``."""

    def __init__(self):
        super().__init__("horovod_tpu_torch has not been initialized; call "
                         "hvd.init() first.")


class NoCudaDeviceError(RuntimeError):
    """An entry point was asked to run on the card and there is none.

    The port runs on ``cuda:<local_rank>`` unless the caller passes
    ``device="cpu"``; it never moves to the CPU on its own."""

    def __init__(self, what: str):
        super().__init__(
            f"{what} runs on the CUDA device by default and torch finds no "
            "CUDA device; pass device='cpu' to run on the CPU")
