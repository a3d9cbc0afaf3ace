"""Persistent scratch memory for the eager data plane: the port of
``horovod_tpu/ops/fusion_buffer.py``.

One long-lived buffer per engine that fused tensors are packed into, so
that the steady-state collective path makes no payload-sized allocation.
Four regions, grown geometrically and never shrunk:

* ``data``: the fusion buffer proper; entries are packed into it once and
  the ring walks slices of it in place;
* ``hop``: the ring's receive landing zone (one chunk);
* ``f32a``/``f32b``: fp32 scratch for the arithmetic of sub-32-bit floats
  (fp16, bf16 and fp8 hops upcast, reduce and round back).

Storage is ``uint8``, viewed per collective as its numpy storage type (the
port keeps bf16 as ``uint16`` and fp8 as ``uint8``; ``common/floats.py``).

Every growth adds its bytes to ``hvd_dataplane_alloc_bytes``, which stays
flat in the steady state.
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.telemetry import registry as _tmx

_MIN_BYTES = 1024


class FusionBuffer:
    """Per-engine persistent buffers; not thread-safe (the engine's
    background loop is the only caller, one collective at a time)."""

    def __init__(self):
        self._data = np.empty(0, np.uint8)
        self._hop = np.empty(0, np.uint8)
        self._f32a = np.empty(0, np.float32)
        self._f32b = np.empty(0, np.float32)

    @staticmethod
    def _capacity(need: int, have: int) -> int:
        cap = max(have, _MIN_BYTES)
        while cap < need:
            cap *= 2
        return cap

    def _ensure_u8(self, buf: np.ndarray, nbytes: int) -> np.ndarray:
        if buf.nbytes >= nbytes:
            return buf
        cap = self._capacity(nbytes, buf.nbytes)
        _tmx.inc_counter("hvd_dataplane_alloc_bytes", cap)
        return np.empty(cap, np.uint8)

    def data_view(self, n: int, dtype) -> np.ndarray:
        """Flat ``n``-element view of the fusion buffer as ``dtype``."""
        dtype = np.dtype(dtype)
        self._data = self._ensure_u8(self._data, n * dtype.itemsize)
        return self._data[:n * dtype.itemsize].view(dtype)

    def hop_view(self, n: int, dtype) -> np.ndarray:
        """Flat ``n``-element receive-scratch view as ``dtype``."""
        dtype = np.dtype(dtype)
        self._hop = self._ensure_u8(self._hop, n * dtype.itemsize)
        return self._hop[:n * dtype.itemsize].view(dtype)

    def f32_views(self, n: int):
        """Two ``n``-element fp32 scratch arrays (incoming, accumulator)."""
        if self._f32a.size < n:
            cap = self._capacity(n * 4, self._f32a.nbytes) // 4
            _tmx.inc_counter("hvd_dataplane_alloc_bytes", cap * 8)
            self._f32a = np.empty(cap, np.float32)
            self._f32b = np.empty(cap, np.float32)
        return self._f32a[:n], self._f32b[:n]

    def pack(self, entries, dtype) -> np.ndarray:
        """Pack every entry's array, flattened and cast to ``dtype``, into
        the fusion buffer; returns the fused flat view."""
        dtype = np.dtype(dtype)
        total = sum(int(e.array.size) for e in entries)
        flat = self.data_view(total, dtype)
        off = 0
        for e in entries:
            n = int(e.array.size)
            flat[off:off + n] = np.ravel(e.array)
            off += n
        return flat

    @staticmethod
    def unpack(flat: np.ndarray, entries):
        """Reshaped per-entry views over ``flat``.  The caller passes a
        per-collective copy (not the live fusion buffer) so that results
        stay valid when the next collective repacks."""
        results = []
        off = 0
        for e in entries:
            n = int(e.array.size)
            results.append(flat[off:off + n].reshape(e.array.shape))
            off += n
        return results
