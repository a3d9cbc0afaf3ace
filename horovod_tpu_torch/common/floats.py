"""The eager data plane's numpy storage and fp32 arithmetic for the 16- and
8-bit float types, without ``ml_dtypes``.

The JAX package holds bfloat16 and the fp8 wire types in ``ml_dtypes``
arrays and reduces them in fp32, rounding back after each hop
(``horovod_tpu/ops/cpu_backend.py``).  The port holds them in numpy as
their bits (``uint16`` for bfloat16, ``uint8`` for fp8) and does the same
arithmetic through the conversions here, which give ``ml_dtypes``' bits:

* to fp32: exact (bfloat16 by a shift; fp8 by a table of its 256 codes);
* from fp32: round to nearest, ties to even.  A NaN keeps its sign and
  becomes the type's quiet NaN (bfloat16 ``0x7FC0``, e4m3fn ``0x7F``, e5m2
  ``0x7E``); past the largest finite value e4m3fn (which has no infinity)
  goes to NaN and e5m2 to infinity.  float64 converts through float32, as
  ``ml_dtypes`` does.

IEEE float16 is numpy's own type, in both packages.
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.common.types import DataType

# (exponent bits, mantissa bits, bias, largest finite code, overflow code,
# quiet NaN code) of the fp8 types.
_FP8 = {
    DataType.FLOAT8_E4M3: (4, 3, 7, 0x7E, 0x7F, 0x7F),
    DataType.FLOAT8_E5M2: (5, 2, 15, 0x7B, 0x7C, 0x7E),
}

_STORAGE = {
    DataType.BFLOAT16: np.dtype(np.uint16),
    DataType.FLOAT8_E4M3: np.dtype(np.uint8),
    DataType.FLOAT8_E5M2: np.dtype(np.uint8),
}

NARROW = (DataType.FLOAT16, DataType.BFLOAT16, DataType.FLOAT8_E4M3,
          DataType.FLOAT8_E5M2)

# The numpy names the JAX package gives these types (``ml_dtypes``'), by
# which an ml_dtypes array handed to the port is recognized.
_ML_NAMES = {"bfloat16": DataType.BFLOAT16,
             "float8_e4m3fn": DataType.FLOAT8_E4M3,
             "float8_e5m2": DataType.FLOAT8_E5M2}


def storage_dtype(dt: DataType) -> np.dtype:
    """The numpy type the port stores ``dt`` in."""
    s = _STORAGE.get(dt)
    if s is not None:
        return s
    from horovod_tpu_torch.common.types import dtype_to_numpy_name

    return np.dtype(dtype_to_numpy_name(dt))


def ml_dtype_of(np_dtype) -> DataType:
    """The DataType of an ``ml_dtypes`` array's dtype, or None."""
    return _ML_NAMES.get(np.dtype(np_dtype).name)


def needs_f32_math(dt: DataType) -> bool:
    """Sub-32-bit floats do their arithmetic in fp32."""
    return dt in NARROW


def _fp8_table(dt: DataType) -> np.ndarray:
    e_bits, m_bits, bias, _max_code, _ovf, nan_code = _FP8[dt]
    out = np.empty(256, np.float32)
    for code in range(256):
        sign = -1.0 if code & 0x80 else 1.0
        mag = code & 0x7F
        e, m = mag >> m_bits, mag & ((1 << m_bits) - 1)
        if dt == DataType.FLOAT8_E4M3 and mag == nan_code:
            out[code] = np.copysign(np.float32(np.nan), sign)
        elif dt == DataType.FLOAT8_E5M2 and e == (1 << e_bits) - 1:
            out[code] = (np.copysign(np.float32(np.inf), sign) if m == 0
                         else np.copysign(np.float32(np.nan), sign))
        elif e == 0:
            out[code] = sign * m * 2.0 ** (1 - bias - m_bits)
        else:
            out[code] = sign * ((1 << m_bits) + m) * 2.0 ** (
                e - bias - m_bits)
    return out


_TABLES = {}


def _table(dt: DataType) -> np.ndarray:
    t = _TABLES.get(dt)
    if t is None:
        t = _TABLES[dt] = _fp8_table(dt)
    return t


def to_f32(arr: np.ndarray, dt: DataType, out=None) -> np.ndarray:
    """The float32 values of ``arr`` (``dt``'s numpy storage), exactly."""
    if out is None:
        out = np.empty(arr.shape, np.float32)
    if dt == DataType.BFLOAT16:
        out.view(np.uint32)[...] = arr
        out.view(np.uint32)[...] <<= 16
    elif dt in _FP8:
        np.take(_table(dt), arr, out=out)
    else:
        out[...] = arr
    return out


def _bf16_from_f32(x: np.ndarray, out: np.ndarray) -> None:
    u = x.view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    r = (u >> 16) & 1
    r += 0x7FFF
    r += u  # wraps only for NaN bit patterns, replaced below
    r >>= 16
    out[...] = r
    if nan.any():
        out[nan] = np.where(u[nan] >> 31, 0xFFC0, 0x7FC0)


def _fp8_from_f32(x: np.ndarray, dt: DataType) -> np.ndarray:
    _e_bits, m_bits, bias, max_code, ovf_code, nan_code = _FP8[dt]
    u = x.view(np.uint32).astype(np.int64)
    sign = (u >> 31) << 7
    a = u & 0x7FFFFFFF
    e = a >> 23
    sig = np.where(e > 0, (a & 0x7FFFFF) | 0x800000, a & 0x7FFFFF)
    exp2 = np.where(e > 0, e - 150, -149)  # value = sig * 2**exp2
    # The result's quantum: 2**(E - m_bits) for an exponent E at or above
    # the smallest normal one, 2**(1 - bias - m_bits) below it.
    q = np.maximum(e - 127, 1 - bias) - m_bits
    shift = np.clip(q - exp2, 1, 40)
    res = sig >> shift
    rem = sig & ((np.int64(1) << shift) - 1)
    half = np.int64(1) << (shift - 1)
    res += (rem > half) | ((rem == half) & ((res & 1) == 1))
    # A carry out of the mantissa lands in the exponent field by itself.
    code = np.where(res == 0, 0, ((q + m_bits + bias - 1) << m_bits) + res)
    code = np.where(code > max_code, ovf_code, code)
    code = np.where(a > 0x7F800000, nan_code, code)
    code = np.where(a == 0x7F800000, ovf_code, code)
    return (code | sign).astype(np.uint8)


def from_f32(x: np.ndarray, dt: DataType, out=None) -> np.ndarray:
    """``x`` (float32) rounded to ``dt``, in ``dt``'s numpy storage."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if dt == DataType.BFLOAT16:
        if out is None:
            out = np.empty(x.shape, np.uint16)
        _bf16_from_f32(x, out)
        return out
    if dt in _FP8:
        r = _fp8_from_f32(x, dt)
    else:
        r = x.astype(storage_dtype(dt))
    if out is None:
        return r
    out[...] = r
    return out


def times(arr: np.ndarray, dt: DataType, factor: float) -> np.ndarray:
    """``arr * factor`` (a Python float) as numpy computes it on the JAX
    package's arrays: an ``ml_dtypes`` array (bfloat16, fp8) gives fp32,
    the factor rounded to fp32; any other array numpy's own promotion (an
    int array gives float64)."""
    if dt in _STORAGE:
        return to_f32(arr, dt) * np.float32(factor)
    return arr * factor


def cast(arr: np.ndarray, src: DataType, dst: DataType) -> np.ndarray:
    """``arr`` (``src``'s storage) converted to ``dst``'s storage, as
    ``ml_dtypes``' ``astype`` converts: a narrow float on either side goes
    through float32."""
    if src == dst:
        return arr.copy()
    if dst in _STORAGE:
        if src in _STORAGE:
            return from_f32(to_f32(arr, src), dst)
        return from_f32(np.asarray(arr).astype(np.float32), dst)
    if src in _STORAGE:
        return to_f32(arr, src).astype(storage_dtype(dst))
    return arr.astype(storage_dtype(dst))
