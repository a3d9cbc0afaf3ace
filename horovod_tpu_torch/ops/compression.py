"""Gradient compression: the port of ``horovod_tpu/ops/compression.py``.

A compressor casts floating tensors to a narrower wire type before the
collective and back after it; other tensors pass through.  The names and
their wire types are the JAX package's, including ``fp16`` meaning the
16-bit wire format bfloat16 and ``float16`` meaning IEEE half.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: compress before the collective, decompress after."""

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``wire_dtype``; restore the original dtype
    after the reduction."""

    wire_dtype = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BFloat16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Float16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class Float8Compressor(_CastCompressor):
    """OCP FP8 e4m3fn on the wire; saturates near ±448, prefer
    ``fp8_e5m2`` when overflow is a concern."""

    wire_dtype = torch.float8_e4m3fn


class Float8E5M2Compressor(_CastCompressor):
    wire_dtype = torch.float8_e5m2


class Compression:
    """Optional gradient compression algorithms, Horovod-API-compatible."""

    none = NoneCompressor
    fp16 = BFloat16Compressor      # 16-bit wire format, bf16
    float16 = Float16Compressor    # strict IEEE fp16
    bfloat16 = BFloat16Compressor
    bf16 = BFloat16Compressor
    fp8 = Float8Compressor         # 8-bit wire format (e4m3fn)
    fp8_e5m2 = Float8E5M2Compressor
