"""Gradient compression for the classic torch front-end: the port of
``horovod_tpu/torch/compression.py``.

A Compressor interface with ``none`` and ``fp16``, on torch tensors:
``fp16`` casts a floating tensor to IEEE half and restores its dtype
afterwards, as the reference's torch binding does (the engine-level
``horovod_tpu_torch.ops.compression`` names bfloat16 ``fp16``, as the
JAX package's does).  The classes are the engine-level module's own:
``Compressor``, ``NoneCompressor``, and ``Float16Compressor`` as
``FP16Compressor``, which casts on compress and restores on decompress.
"""

from __future__ import annotations

from horovod_tpu_torch.ops.compression import (  # noqa: F401
    Compressor,
    NoneCompressor,
)
from horovod_tpu_torch.ops.compression import \
    Float16Compressor as FP16Compressor


class Compression:
    """Optional gradient compression algorithms used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
