"""The native engine: a ``ctypes`` facade over the C++ core
(``horovod_tpu_torch/csrc/``), the port of ``horovod_tpu/runtime_native.py``.

``NativeEngine`` has the interface of ``runtime_py.PyEngine``
(``allreduce_async``, ``allgather_async``, ``reducescatter_async``,
``broadcast_async``, ``alltoall_async``, ``poll``, ``synchronize``,
``barrier``, ``join``, ``cache_stats``, ``shutdown``), so that
``ops/eager.py`` runs on either.  The core speaks the wire of
``common/wire.py`` and runs the same ring algorithms, so one gang may mix
native ranks, ``PyEngine`` ranks (``HVD_TPU_CORE=py``) and the JAX
package's ranks of either kind, and still reduce to the same bits.

Buffers: allreduce and broadcast run in place on the enqueue-side numpy
buffer (a copy of the caller's), which this class keeps alive until the
handle completes.  Allgather and alltoall outputs are sized by the
negotiation, so the core owns them until ``synchronize`` copies them out.
A bfloat16 or fp8 tensor travels as its bits (``uint16``/``uint8``) with
its wire type passed beside them (``dtype=``), as on ``PyEngine``.

What the core does not do, the engine refuses or leaves to ``PyEngine``:

* the recovery ladder: ``HVD_WIRE_CRC=1`` raises before any rendezvous
  traffic (a native rank in a CRC-armed gang would reduce its peers'
  trailers as payload);
* the shm rings: the core speaks TCP only, and publishes a rank-unique
  host record, so that every peer pairs with it over TCP;
* liveness, deadlines, the control tree, telemetry spans inside the
  engine, the flight recorder, the serve channel and the elastic epoch:
  Python-engine features (``basics.init`` refuses ``HVD_ELASTIC_EPOCH``
  on this engine, and serving refuses it).

The timeline (``HVD_TIMELINE``, rank 0) is written by the core itself;
``self.timeline`` is a disabled Python writer, so that nothing else opens
the file.  The autotuner's knobs reach the core as ``hvd_create``'s
arguments.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from horovod_tpu_torch.common import floats
from horovod_tpu_torch.common.types import DataType, ReduceOp, \
    RequestType, StatusType
from horovod_tpu_torch.runner.discovery import block_topology_ok
from horovod_tpu_torch.runtime_py import _data_type
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import timeline as timeline_mod


@dataclass
class _HandleMeta:
    kind: RequestType
    array: np.ndarray  # the enqueue-side buffer, alive until completion
    dtype: DataType
    shape: tuple


class NativeEngine:
    """The ``ctypes`` facade of the C++ engine; see the module
    docstring."""

    def __init__(self, rank, size, local_rank, local_size,
                 cross_rank, cross_size, rdv_addr, rdv_port):
        from horovod_tpu_torch import native
        from horovod_tpu_torch.bootstrap import bootstrap_mesh

        if env_util.wire_crc():
            raise RuntimeError(
                "HVD_WIRE_CRC=1 is not supported by the native engine; "
                "unset it or run the Python engine (HVD_TPU_CORE=py)")
        self._lib = native.load()
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.is_homogeneous = True
        self.native_fallback_reason = None
        self.timeline = timeline_mod.Timeline()

        data, ctrl_sock, ctrl_socks, _kv, _prefix = bootstrap_mesh(
            rank, size, rdv_addr, rdv_port, shm_capable=False)

        # The connected descriptors go to the core, which owns them from
        # here on.
        data_fds = (ctypes.c_int32 * size)(*[-1] * size)
        ctrl_fds = (ctypes.c_int32 * size)(*[-1] * size)
        for r, s in data.items():
            data_fds[r] = s.detach()
        if rank == 0:
            for r, s in ctrl_socks.items():
                ctrl_fds[r] = s.detach()
        elif ctrl_sock is not None:
            ctrl_fds[0] = ctrl_sock.detach()

        self.hierarchical_allreduce = env_util.get_bool(
            env_util.HIERARCHICAL_ALLREDUCE, False)
        self.hierarchical_allgather = env_util.get_bool(
            env_util.HIERARCHICAL_ALLGATHER, False)
        timeline = env_util.get_str(env_util.TIMELINE, "")
        rc = self._lib.hvd_create(
            rank, size, local_rank, local_size, cross_rank, cross_size,
            data_fds, ctrl_fds,
            env_util.cycle_time_ms() / 1e3,
            env_util.fusion_threshold_bytes(),
            env_util.get_float(env_util.STALL_CHECK_TIME, 60.0),
            env_util.get_float(env_util.STALL_SHUTDOWN_TIME, 0.0),
            1 if env_util.get_bool(env_util.STALL_CHECK_DISABLE, False)
            else 0,
            env_util.get_int(env_util.CACHE_CAPACITY, 1024),
            1 if self.hierarchical_allreduce else 0,
            1 if self.hierarchical_allgather else 0,
            *self._autotune_args(self.hierarchical_topology_ok()),
            timeline.encode() if timeline and rank == 0 else None,
            1 if env_util.get_bool(env_util.TIMELINE_MARK_CYCLES, False)
            else 0)
        if rc != 0:
            raise OSError(self._lib.hvd_last_error().decode())

        self._meta: Dict[int, _HandleMeta] = {}
        self._meta_lock = threading.Lock()
        self._shutdown = False

        # Sets constructed before the engine existed: the coordinator and
        # the non-members need the registry too, to look a set up or skip
        # its responses.
        from horovod_tpu_torch import process_sets

        for sid, ranks in process_sets.snapshot().items():
            self.register_process_set(sid, ranks)

    def hierarchical_topology_ok(self) -> bool:
        """True at a block topology, where the two-level collectives
        run."""
        return block_topology_ok(self.rank, self.size, self.local_rank,
                                 self.local_size, self.cross_rank,
                                 self.cross_size)

    def register_process_set(self, set_id, ranks):
        arr = (ctypes.c_int32 * len(ranks))(*ranks)
        self._lib.hvd_register_process_set(set_id, arr, len(ranks))

    @staticmethod
    def _autotune_args(hierarchical_ok: bool = False):
        """``hvd_create``'s autotuner arguments, from the environment as
        the Python engine reads it."""
        from horovod_tpu_torch.autotune.parameter_manager import (
            autotune_options_from_env,
        )

        opts = autotune_options_from_env(hierarchical_ok)
        if opts is None:
            return (0, 0, 0, 0, 0, 0, 0, 0, 0.0, None)
        return (1,
                1 if opts["tune_fusion"] else 0,
                1 if opts["tune_cycle"] else 0,
                1 if opts["tune_cache"] else 0,
                1 if opts["tune_hier_allreduce"] else 0,
                1 if opts["tune_hier_allgather"] else 0,
                opts["warmup_samples"], opts["max_samples"],
                opts["sample_duration_s"],
                opts["log_path"].encode() if opts["log_path"] else None)

    # -- enqueue -----------------------------------------------------------

    @staticmethod
    def _dims(arr: np.ndarray):
        dims = (ctypes.c_int64 * max(arr.ndim, 1))(*(arr.shape or (1,)))
        return arr.ndim, dims

    def _raise_enqueue_error(self):
        msg = self._lib.hvd_last_error().decode()
        # Argument errors are ValueErrors, as on the Python engine.
        if any(k in msg for k in ("same name", "out of range", "splits",
                                  "divisible", "per participant")):
            raise ValueError(msg)
        raise RuntimeError(msg)

    def _ps_args(self, process_set):
        """The (id, size) arguments of a validated process set (the core
        learns the set when it is constructed, not per call)."""
        if process_set is None:
            return 0, 0
        return process_set.validate(self.rank, self.size)

    def _track(self, h, kind, arr, dt):
        if h < 0:
            self._raise_enqueue_error()
        with self._meta_lock:
            self._meta[h] = _HandleMeta(kind, arr, dt, arr.shape)
        return h

    @staticmethod
    def _owned(array) -> np.ndarray:
        """A contiguous copy: the core writes into it in place."""
        arr = np.ascontiguousarray(array)
        return arr.copy() if arr is array else arr

    def allreduce_async(self, name, array, op=ReduceOp.SUM,
                        prescale=1.0, postscale=1.0, process_set=None,
                        dtype: Optional[DataType] = None):
        arr = self._owned(array)
        dt = _data_type(arr, dtype)
        nd, dims = self._dims(arr)
        ps_id, ps_size = self._ps_args(process_set)
        h = self._lib.hvd_allreduce_async(
            name.encode(), arr.ctypes.data, nd, dims, int(dt), int(op),
            prescale, postscale, ps_id, ps_size)
        return self._track(h, RequestType.ALLREDUCE, arr, dt)

    def allgather_async(self, name, array, process_set=None,
                        dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        dt = _data_type(arr, dtype)
        nd, dims = self._dims(arr)
        ps_id, ps_size = self._ps_args(process_set)
        h = self._lib.hvd_allgather_async(
            name.encode(), arr.ctypes.data, nd, dims, int(dt), ps_id,
            ps_size)
        return self._track(h, RequestType.ALLGATHER, arr, dt)

    def reducescatter_async(self, name, array, op=ReduceOp.SUM,
                            process_set=None,
                            dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        if arr.ndim == 0:
            raise ValueError(
                "reducescatter needs at least one dimension to scatter "
                "over (got a scalar)")
        dt = _data_type(arr, dtype)
        nd, dims = self._dims(arr)
        ps_id, ps_size = self._ps_args(process_set)
        h = self._lib.hvd_reducescatter_async(
            name.encode(), arr.ctypes.data, nd, dims, int(dt), int(op),
            ps_id, ps_size)
        return self._track(h, RequestType.REDUCESCATTER, arr, dt)

    def broadcast_async(self, name, array, root_rank=0, process_set=None,
                        dtype: Optional[DataType] = None):
        arr = self._owned(array)
        dt = _data_type(arr, dtype)
        nd, dims = self._dims(arr)
        ps_id, ps_size = self._ps_args(process_set)
        if process_set is not None and root_rank not in process_set.ranks:
            raise ValueError(
                f"broadcast root rank {root_rank} (global) is not a "
                f"member of {process_set}")
        h = self._lib.hvd_broadcast_async(
            name.encode(), arr.ctypes.data, nd, dims, int(dt), root_rank,
            ps_id, ps_size)
        return self._track(h, RequestType.BROADCAST, arr, dt)

    def alltoall_async(self, name, array, splits: Optional[List[int]] = None,
                       process_set=None, dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        dt = _data_type(arr, dtype)
        nd, dims = self._dims(arr)
        ps_id, ps_size = self._ps_args(process_set)
        csplits, n = None, 0
        if splits is not None:
            splits = [int(s) for s in splits]
            if sum(splits) != (arr.shape[0] if arr.ndim else 0):
                raise ValueError("splits must sum to dim 0")
            csplits, n = (ctypes.c_int64 * len(splits))(*splits), \
                len(splits)
        h = self._lib.hvd_alltoall_async(
            name.encode(), arr.ctypes.data, nd, dims, int(dt), csplits, n,
            ps_id, ps_size)
        return self._track(h, RequestType.ALLTOALL, arr, dt)

    # -- completion --------------------------------------------------------

    def poll(self, handle: int) -> bool:
        rc = self._lib.hvd_poll(handle)
        if rc < 0:
            raise ValueError(f"unknown handle {handle}")
        return rc == 1

    def synchronize(self, handle: int, timeout=None):
        st = StatusType(self._lib.hvd_wait(handle))
        with self._meta_lock:
            meta = self._meta.pop(handle, None)
        if st != StatusType.OK:
            msg = self._lib.hvd_handle_error(handle).decode()
            self._lib.hvd_release(handle)
            raise RuntimeError(msg or "collective failed")
        try:
            if meta is None:
                return None
            if meta.kind in (RequestType.ALLREDUCE, RequestType.BROADCAST):
                return meta.array  # reduced or received in place
            np_dt = floats.storage_dtype(meta.dtype)
            nbytes = self._lib.hvd_result_nbytes(handle)
            src = self._lib.hvd_result_data(handle)
            rest = meta.shape[1:]
            if nbytes <= 0 or src is None:
                out = np.zeros((0,) + rest, np_dt)
            else:
                out = np.frombuffer(ctypes.string_at(src, nbytes),
                                    dtype=np_dt).copy().reshape((-1,) + rest)
            if meta.kind == RequestType.ALLTOALL:
                sp = (ctypes.c_int64 * self.size)()
                n = self._lib.hvd_result_splits(handle, sp, self.size)
                return out, [int(sp[i]) for i in range(max(n, 0))]
            return out
        finally:
            self._lib.hvd_release(handle)

    # -- blocking ops ------------------------------------------------------

    def barrier(self, process_set=None):
        ps_id, ps_size = self._ps_args(process_set)
        if self._lib.hvd_barrier(ps_id, ps_size) != 0:
            raise RuntimeError(self._lib.hvd_last_error().decode())

    def cache_stats(self) -> Dict[str, int]:
        out = (ctypes.c_int64 * 5)()
        self._lib.hvd_cache_stats(out)
        return {"hits": out[0], "misses": out[1], "evictions": out[2],
                "size": out[3], "capacity": out[4]}

    def join(self) -> int:
        return self._lib.hvd_join()

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        self._lib.hvd_shutdown()
        self.timeline.shutdown()
