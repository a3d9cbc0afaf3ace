"""Types the port shares across modules.

The port's copy of what it needs from ``horovod_tpu/common/types.py``
(``DataType`` and ``ReduceOp``, with the same values, and the dtype
mappings); the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum

import torch


class DataType(enum.IntEnum):
    """Wire dtype tags, numbered as in the JAX package."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10
    FLOAT8_E4M3 = 11
    FLOAT8_E5M2 = 12

    @property
    def itemsize(self) -> int:
        return dtype_to_torch(self).itemsize


_TORCH = {
    DataType.UINT8: torch.uint8,
    DataType.INT8: torch.int8,
    DataType.UINT16: torch.uint16,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT16: torch.float16,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BOOL: torch.bool,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT8_E4M3: torch.float8_e4m3fn,
    DataType.FLOAT8_E5M2: torch.float8_e5m2,
}


def dtype_to_torch(dt: DataType) -> torch.dtype:
    return _TORCH[dt]


def dtype_from_torch(dtype: torch.dtype) -> DataType:
    for k, v in _TORCH.items():
        if v == dtype:
            return k
    raise ValueError(f"horovod_tpu_torch does not support dtype {dtype}")


def dtype_to_numpy_name(dt: DataType) -> str:
    """The numpy (and JAX) name of the type, e.g. ``"float8_e4m3fn"``."""
    return str(_TORCH[dt]).split(".", 1)[1]


def dtype_from_numpy(np_dtype) -> DataType:
    name = str(np_dtype)
    for k in _TORCH:
        if dtype_to_numpy_name(k) == name:
            return k
    raise ValueError(f"horovod_tpu_torch does not support dtype {name!r}")


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
