"""The eager engine: a background thread, a star controller and the host
ring data plane.  The port of ``horovod_tpu/runtime_py.py``'s core.

A framework thread enqueues named tensors; the background thread sends
their requests to the coordinator (rank 0) each cycle; the coordinator
counts which names every rank has submitted, checks that their requests
agree ("Mismatched ..." errors otherwise), fuses ready allreduces up to
``HVD_FUSION_THRESHOLD``, and broadcasts the response list, which every
rank executes in the same order over the TCP mesh
(``ops/cpu_backend.py``).  The response cache (``common/response_cache``)
turns steady-state requests into positions; ``join`` lets a rank that ran
out of data contribute zeros; shutdown is negotiated, so that every rank
stops in the same cycle.

The frames (``common/wire.py``), the bootstrap (``bootstrap.py``), the
cache's positions and the data plane's arithmetic are the JAX package's,
so that port ranks and JAX ``PyEngine`` ranks (``HVD_TPU_CORE=py``) form
one gang.  The port plans the flat star: a JAX rank in a gang with port
ranks runs with ``HVD_CTRL_TREE=0``.

The data plane: same-host peers pair over a shm ring unless
``HVD_SHM_DISABLE``, the others over TCP (``utils/transport.py``); with
``HVD_WIRE_CRC=1`` every pair is a self-healing ``LadderLink``
(``utils/ladder.py``) and the bootstrap listener stays open for its
re-dials.  ``HVD_HIERARCHICAL_ALLREDUCE``/``ALLGATHER`` turn on the
two-level collectives at a block topology
(:meth:`PyEngine.hierarchical_topology_ok`).  ``HVD_TIMELINE`` makes rank
0 write a Chrome-tracing timeline (``utils/timeline.py``), and
``HOROVOD_FAULT_PLAN`` arms the fault sites (``common/fault_injection.py``;
``engine.cycle``, ``ctrl.worker.send`` and ``ctrl.coord.send`` here).

Left out until their features are ported, by their items of ROADMAP Queue
1, item 5 (setting a knob that turns one on raises ``NotImplementedError``
at ``init()``, so that a port rank never runs another protocol quietly):

* 5.3: heartbeats, eviction and ``EVICT`` (``HVD_HEARTBEAT_TIMEOUT``),
  collective deadlines, abort and replay (``HVD_COLLECTIVE_TIMEOUT``;
  until then a ``WireCorruptionError`` fails its collective on this rank,
  with no gang-wide agreement);
* 5.4: the control tree (``HVD_CTRL_TREE`` is not read: the star is
  flat);
* 5.5: the autotuner (``HVD_AUTOTUNE``), telemetry (``HVD_METRICS*``,
  ``HVD_STRAGGLER_WARN_MS``), the trace (``HVD_TRACE``) with its clock
  pings, and the flight recorder;
* 5.7: elastic membership epochs (``HVD_ELASTIC_EPOCH``: every frame
  carries epoch 0), then the serving loop's
  ``serve_broadcast``/``serve_recv``.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common import floats
from horovod_tpu_torch.common import response_cache as rcache
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common.types import (
    DataType,
    ReduceOp,
    Request,
    RequestType,
    Response,
    ResponseType,
    Status,
    TensorShape,
    dtype_from_numpy,
)
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import socketutil as su
from horovod_tpu_torch.utils import timeline as timeline_mod

_OP_NAMES = {
    RequestType.ALLREDUCE: "ALLREDUCE",
    RequestType.ALLGATHER: "ALLGATHER",
    RequestType.BROADCAST: "BROADCAST",
    RequestType.ALLTOALL: "ALLTOALL",
    RequestType.JOIN: "JOIN",
    RequestType.BARRIER: "BARRIER",
    RequestType.REDUCESCATTER: "REDUCESCATTER",
}

# Knobs that turn on a feature the port has not ported yet: (variable,
# when it is on: "bool" true, "positive" > 0, "set" non-empty; the
# ROADMAP Queue 1 item that brings it).
_LEFT_OUT = (
    ("HVD_HEARTBEAT_TIMEOUT", "positive", "5.3, heartbeats"),
    ("HOROVOD_HEARTBEAT_TIMEOUT", "positive", "5.3, heartbeats"),
    ("HVD_COLLECTIVE_TIMEOUT", "positive",
     "5.3, deadlines, abort and replay"),
    ("HVD_AUTOTUNE", "bool", "5.5, autotune"),
    ("HVD_METRICS", "bool", "5.5, telemetry"),
    ("HVD_METRICS_PORT", "set", "5.5, telemetry"),
    ("HVD_METRICS_FILE", "set", "5.5, telemetry"),
    ("HVD_STRAGGLER_WARN_MS", "positive", "5.5, telemetry"),
    ("HVD_TRACE", "bool", "5.5, the trace"),
    ("HVD_ELASTIC_EPOCH", "set", "5.7, elastic"),
)


def check_left_out_knobs() -> None:
    """Raise ``NotImplementedError`` naming the first set knob that turns
    on a feature the port's engine does not run yet."""
    for name, test, item in _LEFT_OUT:
        v = os.environ.get(name, "")
        if test == "bool":
            on = env_util.get_bool(name, False)
        elif test == "positive":
            on = env_util.get_float(name, 0.0) > 0
        else:
            on = bool(v)
        if on:
            raise NotImplementedError(
                f"{name}={v!r} turns on a feature the port's eager engine "
                f"does not run yet (ROADMAP Queue 1, item {item}); unset "
                f"it, gang-wide, to run the engine's core")


class HandleManager:
    """Async handle table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next = 0
        self._status: Dict[int, Optional[Status]] = {}
        self._result: Dict[int, object] = {}

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._status[h] = None
            return h

    def mark_done(self, handle: int, status: Status, result=None) -> None:
        with self._cv:
            self._status[handle] = status
            self._result[handle] = result
            self._cv.notify_all()

    def poll(self, handle: int) -> bool:
        with self._lock:
            if handle not in self._status:
                raise ValueError(f"unknown handle {handle}")
            return self._status[handle] is not None

    def wait(self, handle: int, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._status.get(handle) is None:
                remaining = None if deadline is None else max(
                    0.0, deadline - time.monotonic())
                if deadline is not None and remaining == 0.0:
                    raise TimeoutError(f"handle {handle} timed out")
                self._cv.wait(remaining)
            status = self._status.pop(handle)
            result = self._result.pop(handle, None)
        if not status.ok_():
            if status.exc is not None:
                raise status.exc
            raise RuntimeError(status.reason or "collective failed")
        return result


@dataclass
class TensorTableEntry:
    """One enqueued tensor awaiting its collective: its numpy host copy
    (in the storage type of ``request.tensor_type``)."""

    name: str
    array: np.ndarray
    handle: int
    request: Request
    root_rank: int = -1
    splits: Optional[List[int]] = None


class _MessageTable:
    """Coordinator-side ready counts, keyed by tensor name (and process
    set)."""

    def __init__(self, size: int):
        self.size = size
        self.entries: Dict[str, List[Request]] = {}
        self.first_seen: Dict[str, float] = {}

    @staticmethod
    def key_of(req: Request) -> str:
        """Process-set requests are scoped by set id, so that one name may
        be in flight in two sets at once."""
        if req.process_set_id:
            return f"{req.tensor_name}@ps{req.process_set_id}"
        return req.tensor_name

    def increment(self, req: Request, joined_size: int) -> bool:
        """Record a rank's readiness; True when every non-joined rank (for
        a process set: every member) is in.  A second tick from the same
        rank is ignored."""
        key = self.key_of(req)
        lst = self.entries.setdefault(key, [])
        if any(q.request_rank == req.request_rank for q in lst):
            return False
        lst.append(req)
        self.first_seen.setdefault(key, time.monotonic())
        if req.process_set_id:
            return len(lst) == req.process_set_size
        return len(lst) == self.size - joined_size

    def pop(self, name: str) -> List[Request]:
        self.first_seen.pop(name, None)
        return self.entries.pop(name)


class _EngineBase:
    """Shared enqueue-side logic and introspection."""

    def __init__(self, rank, size, local_rank, local_size,
                 cross_rank, cross_size):
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.handles = HandleManager()
        self._pending_names: set = set()
        self._name_lock = threading.Lock()
        self._barrier_counters = {0: 0}  # per process-set id

    def _claim_name(self, name: str) -> None:
        with self._name_lock:
            if name in self._pending_names:
                raise ValueError(
                    f"Requested a collective on a tensor with the same name "
                    f"as another tensor that is currently being processed: "
                    f"{name}")
            self._pending_names.add(name)

    def _release_name(self, name: str) -> None:
        with self._name_lock:
            self._pending_names.discard(name)

    def poll(self, handle: int) -> bool:
        return self.handles.poll(handle)

    def synchronize(self, handle: int, timeout: Optional[float] = None):
        return self.handles.wait(handle, timeout)

    def cache_stats(self) -> Dict[str, int]:
        return {"hits": 0, "misses": 0, "evictions": 0, "size": 0,
                "capacity": 0}


class SingleProcessEngine(_EngineBase):
    """size == 1: every collective is the identity (modulo scaling),
    applied at once.  Keeps the async handle API, so user code is the
    same at any size."""

    def __init__(self):
        super().__init__(0, 1, 0, 1, 0, 1)
        self.timeline = timeline_mod.from_env(0)

    def shutdown(self):
        self.timeline.shutdown()

    def _finish(self, name, op_name, result):
        self.timeline.negotiate_start(name, op_name)
        self.timeline.negotiate_rank_ready(name, 0)
        self.timeline.negotiate_end(name)
        self.timeline.start(name, op_name)
        self.timeline.end(name)
        h = self.handles.allocate()
        self.handles.mark_done(h, Status.ok(), result)
        return h

    def _check_ps(self, process_set):
        if process_set is not None:
            process_set.validate(0, 1)

    def allreduce_async(self, name, array, op=ReduceOp.SUM,
                        prescale=1.0, postscale=1.0, process_set=None,
                        dtype: Optional[DataType] = None):
        self._check_ps(process_set)
        out = np.asarray(array)
        if prescale != 1.0 or postscale != 1.0:
            out = floats.times(out, _data_type(out, dtype),
                               prescale * postscale)
        else:
            out = out.copy()
        return self._finish(name, "ALLREDUCE", out)

    def allgather_async(self, name, array, process_set=None, dtype=None):
        self._check_ps(process_set)
        return self._finish(name, "ALLGATHER", np.asarray(array).copy())

    def reducescatter_async(self, name, array, op=ReduceOp.SUM,
                            process_set=None, dtype=None):
        self._check_ps(process_set)
        return self._finish(name, "REDUCESCATTER",
                            np.asarray(array).copy())

    def broadcast_async(self, name, array, root_rank=0, process_set=None,
                        dtype=None):
        self._check_ps(process_set)
        if root_rank != 0:
            raise ValueError(
                f"broadcast root rank {root_rank} out of range for size 1")
        return self._finish(name, "BROADCAST", np.asarray(array).copy())

    def alltoall_async(self, name, array, splits=None, process_set=None,
                       dtype=None):
        self._check_ps(process_set)
        arr = np.asarray(array)
        if splits is not None:
            splits = [int(s) for s in splits]
            if len(splits) != 1:
                raise ValueError(
                    "alltoall needs one split per participant (1)")
            if sum(splits) != (arr.shape[0] if arr.ndim else 0):
                raise ValueError("splits must sum to dim 0")
        return self._finish(name, "ALLTOALL", arr.copy())

    def barrier(self, process_set=None):
        self._check_ps(process_set)
        return None

    def join(self) -> int:
        return 0


def _data_type(arr: np.ndarray, dtype: Optional[DataType]) -> DataType:
    """The wire type of a host array: ``dtype`` where the caller says (a
    bfloat16 or fp8 tensor's bits), else the numpy type's."""
    if dtype is not None:
        return dtype
    ml = floats.ml_dtype_of(arr.dtype)
    return ml if ml is not None else dtype_from_numpy(arr.dtype)


class PyEngine(_EngineBase):
    """Multi-process engine: background thread, star controller, ring data
    plane.  See the module docstring."""

    def __init__(self, rank, size, local_rank, local_size,
                 cross_rank, cross_size, rdv_addr, rdv_port):
        check_left_out_knobs()
        super().__init__(rank, size, local_rank, local_size,
                         cross_rank, cross_size)
        self.log = logging.getLogger(f"horovod_tpu_torch[{rank}]")
        self.timeline = timeline_mod.from_env(rank)
        self.cycle_time = env_util.cycle_time_ms() / 1e3
        self.fusion_threshold = env_util.fusion_threshold_bytes()
        self.ring_segment_bytes = env_util.ring_segment_bytes()
        self.stall_warn_s = env_util.get_float(env_util.STALL_CHECK_TIME,
                                               60.0)
        self.stall_shutdown_s = env_util.get_float(
            env_util.STALL_SHUTDOWN_TIME, 0.0)
        self.stall_check_disable = env_util.get_bool(
            env_util.STALL_CHECK_DISABLE, False)
        # The two-level data plane, effective only at a block topology
        # (hierarchical_topology_ok).
        self.hierarchical_allreduce = env_util.get_bool(
            env_util.HIERARCHICAL_ALLREDUCE, False)
        self.hierarchical_allgather = env_util.get_bool(
            env_util.HIERARCHICAL_ALLGATHER, False)
        self.epoch = 0
        # When a list, every executed response appends (type, tensors,
        # bytes, from_cache) to it: the card's engine phase reads it.
        self.response_log: Optional[list] = None

        # request queue (tensor queue) + tensor table
        self._queue_lock = threading.Lock()
        self._request_queue: List[Request] = []
        self._table: Dict[str, TensorTableEntry] = {}

        # join state
        self._join_handle: Optional[int] = None
        self._last_joined_rank = -1

        # `_shutdown_requested` asks the loop to negotiate the stop (the
        # shutdown bit on the wire) so every rank exits in the same cycle;
        # `_shutdown_flag` is the hard local stop.
        self._shutdown_requested = threading.Event()
        self._shutdown_flag = threading.Event()
        self._loop_exited = threading.Event()
        self._closed = False
        self._aborted = False
        self._abort_reason = None
        self._ctrl_conn_lost = False

        # coordinator state
        self._msg_table = _MessageTable(size) if rank == 0 else None
        self._joined_ranks: set = set()
        self._ctrl_inbox: list = []
        self._ctrl_lock = threading.Lock()
        self._ctrl_send_lock = threading.Lock()
        self._last_stall_check = time.monotonic()

        # Response cache; touched only on the background thread.
        self._cache = rcache.ResponseCache(
            env_util.get_int(env_util.CACHE_CAPACITY, 1024))
        self._cache_classify_enabled = True
        self._resend_uncached: set = set()
        self._hit_ranks: Dict[str, set] = {}

        try:
            self._bootstrap(rdv_addr, rdv_port)
        except BaseException:
            self.timeline.shutdown()
            raise
        self._bg = threading.Thread(
            target=self._background_loop, name="hvd-background", daemon=True)
        self._bg.start()

    # ------------------------------------------------------------------
    # bootstrap: rendezvous + socket meshes
    # ------------------------------------------------------------------

    def _bootstrap(self, rdv_addr: str, rdv_port: int) -> None:
        from horovod_tpu_torch.bootstrap import bootstrap_mesh
        from horovod_tpu_torch.ops.fusion_buffer import FusionBuffer
        from horovod_tpu_torch.utils import transport as tpt

        # The recovery ladder keeps the bootstrap listener open for
        # re-dials, and remembers every peer's address.
        ladder_on = env_util.wire_crc()
        self._reconnect_listener = None
        if ladder_on:
            (self._data, self._ctrl_sock, self._ctrl_socks, kv, kv_prefix,
             mesh_peers, mesh_listener) = bootstrap_mesh(
                self.rank, self.size, rdv_addr, rdv_port,
                keep_listener=True)
            from horovod_tpu_torch.utils import ladder

            self._transports, self._reconnect_listener = \
                ladder.build_ladder_links(
                    self.rank, self.size, self._data, kv, kv_prefix,
                    mesh_peers, mesh_listener, epoch=self.epoch)
            # Ladder links own their sender threads.
            self._senders = {}
        else:
            (self._data, self._ctrl_sock, self._ctrl_socks, kv,
             kv_prefix) = bootstrap_mesh(self.rank, self.size, rdv_addr,
                                         rdv_port)
            self._transports = tpt.build_transports(
                self.rank, self.size, self._data, kv, kv_prefix)
            # A shm transport's sender thread lives inside it: one sender
            # thread a peer either way.
            self._senders = {r: t.sender
                             for r, t in self._transports.items()
                             if t.kind == "tcp"}
        self._fusion_buf = FusionBuffer()
        self._response_inbox: List[bytes] = []
        self._response_lock = threading.Lock()
        self._response_cv = threading.Condition(self._response_lock)
        if self.rank == 0:
            for r, s in self._ctrl_socks.items():
                threading.Thread(target=self._ctrl_recv_loop,
                                 args=(r, s), daemon=True).start()
        else:
            threading.Thread(target=self._worker_recv_loop,
                             daemon=True).start()

    def _ctrl_recv_loop(self, peer_rank: int, sock: socket.socket) -> None:
        try:
            while not self._shutdown_flag.is_set():
                tag, payload = su.recv_frame(sock)
                if tag == su.TAG_REQUEST_LIST:
                    with self._ctrl_lock:
                        self._ctrl_inbox.append((peer_rank, payload))
                # Other tags belong to features the port leaves out, whose
                # knobs must be off gang-wide.
        except (ConnectionError, OSError):
            pass

    def _worker_recv_loop(self) -> None:
        try:
            while not self._shutdown_flag.is_set():
                tag, payload = su.recv_frame(self._ctrl_sock)
                if tag == su.TAG_RESPONSE_LIST:
                    with self._response_cv:
                        self._response_inbox.append(payload)
                        self._response_cv.notify_all()
        except (ConnectionError, OSError):
            # Coordinator EOF: expected during a negotiated shutdown;
            # otherwise the next worker cycle drains any shutdown frame
            # already received and only then declares the hub lost.
            if not (self._shutdown_flag.is_set()
                    or self._shutdown_requested.is_set() or self._closed):
                self._ctrl_conn_lost = True

    # ------------------------------------------------------------------
    # enqueue API (framework-thread side)
    # ------------------------------------------------------------------

    def _enqueue(self, entry: TensorTableEntry) -> int:
        if self._aborted or self._shutdown_flag.is_set() \
                or self._shutdown_requested.is_set():
            raise RuntimeError("horovod_tpu_torch runtime has been shut down")
        self._claim_name(entry.name)
        with self._queue_lock:
            self._table[entry.name] = entry
            self._request_queue.append(entry.request)
        return entry.handle

    def _ps_fields(self, process_set):
        if process_set is None:
            return 0, 0
        return process_set.validate(self.rank, self.size)

    def _request(self, rtype, name, arr, dtype, process_set, **kw):
        ps_id, ps_size = self._ps_fields(process_set)
        return Request(request_rank=self.rank, request_type=rtype,
                       tensor_type=_data_type(arr, dtype), tensor_name=name,
                       device="cpu", tensor_shape=TensorShape(arr.shape),
                       process_set_id=ps_id, process_set_size=ps_size, **kw)

    def allreduce_async(self, name, array, op=ReduceOp.SUM,
                        prescale=1.0, postscale=1.0, process_set=None,
                        dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        req = self._request(RequestType.ALLREDUCE, name, arr, dtype,
                            process_set, reduce_op=op,
                            prescale_factor=prescale,
                            postscale_factor=postscale)
        h = self.handles.allocate()
        return self._enqueue(TensorTableEntry(name, arr, h, req))

    def allgather_async(self, name, array, process_set=None,
                        dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        req = self._request(RequestType.ALLGATHER, name, arr, dtype,
                            process_set)
        h = self.handles.allocate()
        return self._enqueue(TensorTableEntry(name, arr, h, req))

    def reducescatter_async(self, name, array, op=ReduceOp.SUM,
                            process_set=None,
                            dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        if arr.ndim == 0:
            raise ValueError(
                "reducescatter needs at least one dimension to scatter "
                "over (got a scalar)")
        req = self._request(RequestType.REDUCESCATTER, name, arr, dtype,
                            process_set, reduce_op=op)
        h = self.handles.allocate()
        return self._enqueue(TensorTableEntry(name, arr, h, req))

    def broadcast_async(self, name, array, root_rank=0, process_set=None,
                        dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        if not (0 <= root_rank < self.size):
            raise ValueError(
                f"broadcast root rank {root_rank} out of range "
                f"[0, {self.size})")
        self._ps_fields(process_set)
        if process_set is not None and \
                root_rank not in process_set.ranks:
            raise ValueError(
                f"broadcast root rank {root_rank} (global) is not a "
                f"member of {process_set}")
        req = self._request(RequestType.BROADCAST, name, arr, dtype,
                            process_set, root_rank=root_rank)
        h = self.handles.allocate()
        return self._enqueue(
            TensorTableEntry(name, arr, h, req, root_rank=root_rank))

    def alltoall_async(self, name, array, splits=None, process_set=None,
                       dtype: Optional[DataType] = None):
        arr = np.ascontiguousarray(array)
        ps_id, ps_size = self._ps_fields(process_set)
        n = ps_size or self.size
        if splits is not None:
            splits = [int(s) for s in splits]
            if len(splits) != n:
                raise ValueError(
                    f"alltoall needs one split per participant ({n})")
            if sum(splits) != arr.shape[0]:
                raise ValueError("splits must sum to dim 0")
        elif arr.ndim and arr.shape[0] % n:
            raise ValueError(
                "alltoall without splits requires dim 0 divisible by "
                "the participant count")
        req = self._request(RequestType.ALLTOALL, name, arr, dtype,
                            process_set)
        h = self.handles.allocate()
        return self._enqueue(
            TensorTableEntry(name, arr, h, req, splits=splits))

    def barrier(self, process_set=None):
        # One counter per process set (not the handle counter): the name
        # must agree on every member whatever else each has issued, and
        # with the JAX engines' names.
        ps_id, ps_size = self._ps_fields(process_set)
        with self._queue_lock:
            c = self._barrier_counters.get(ps_id, 0)
            self._barrier_counters[ps_id] = c + 1
        name = f"__barrier.{c}" if not ps_id else \
            f"__barrier.ps{ps_id}.{c}"
        req = Request(request_rank=self.rank,
                      request_type=RequestType.BARRIER,
                      tensor_type=DataType.INT32,
                      tensor_name=name, device="cpu",
                      process_set_id=ps_id, process_set_size=ps_size)
        h = self.handles.allocate()
        self._enqueue(TensorTableEntry(
            name, np.zeros(1, np.int32), h, req))
        return self.handles.wait(h)

    def join(self) -> int:
        """Block until every rank has joined; returns the last rank that
        joined.  Until then this rank contributes zeros to the others'
        allreduces."""
        req = Request(request_rank=self.rank, request_type=RequestType.JOIN,
                      tensor_name="__join__", device="cpu")
        h = self.handles.allocate()
        with self._queue_lock:
            self._join_handle = h
            self._request_queue.append(req)
        self.handles.wait(h)
        return self._last_joined_rank

    def shutdown(self):
        """Negotiated stop: the next cycle carries the shutdown bit, the
        coordinator's response list stops every rank in the same cycle,
        and only then do the sockets close.  Bounded, in case the peers
        are gone already.  Runs its cleanup once, also on a rank whose
        loop a peer's shutdown already stopped."""
        if self._closed:
            return
        self._closed = True
        self._shutdown_requested.set()
        self._loop_exited.wait(timeout=10)
        self._shutdown_flag.set()
        self._bg.join(timeout=10)
        self.timeline.shutdown()
        # The ladder's listener first, so that no re-dial lands on a dying
        # link; then the shm transports and ladder links (each drains,
        # breaks a writer spinning on a dead peer's full ring, joins its
        # threads and unmaps its segment, whose name was unlinked at
        # pairing); then the senders (they drain while the sockets are
        # open); then the sockets, which also unblocks a sender stuck
        # writing to a dead peer; then the joins.
        if self._reconnect_listener is not None:
            try:
                self._reconnect_listener.close()
            except Exception:
                pass
        transports = list(self._transports.values())
        for t in transports:
            if t.kind != "tcp":
                try:
                    t.close(timeout=2.0)
                except Exception:
                    pass
        senders = list(self._senders.values())
        for snd in senders:
            try:
                snd.close(timeout=2.0)
            except Exception:
                pass
        self._senders = {}
        socks = list(self._data.values()) + list(self._ctrl_socks.values())
        if self._ctrl_sock is not None:
            socks.append(self._ctrl_sock)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for snd in senders:
            snd.thread.join(timeout=2.0)
        for t in transports:
            try:
                t.join(timeout=2.0)
            except Exception:
                pass
        self._transports = {}

    def transport_media(self) -> Dict[int, str]:
        """Peer rank -> what carries that pair's bytes now: ``"shm"`` or
        ``"tcp"`` (a ladder link reports its current mode)."""
        return {r: t.medium for r, t in sorted(self._transports.items())}

    # ------------------------------------------------------------------
    # background loop
    # ------------------------------------------------------------------

    def _background_loop(self):
        try:
            while not self._shutdown_flag.is_set():
                t0 = time.monotonic()
                self.timeline.mark_cycle_start()
                if not self._run_loop_once():
                    break
                dt = time.monotonic() - t0
                if dt < self.cycle_time:
                    time.sleep(self.cycle_time - dt)
        except Exception as e:  # deliver the failure to pending handles
            if not (self._shutdown_requested.is_set()
                    or self._shutdown_flag.is_set()):
                self.log.error("background loop failed: %r", e)
            self._abort(str(e))
        finally:
            self._drain_on_shutdown()
            self._loop_exited.set()

    def _drain_on_shutdown(self):
        with self._queue_lock:
            entries = list(self._table.values())
            self._table.clear()
            self._request_queue.clear()
            jh, self._join_handle = self._join_handle, None
        status = Status.aborted(
            self._abort_reason or "Horovod has been shut down.")
        for e in entries:
            self._release_name(e.name)
            self.handles.mark_done(e.handle, status, None)
        if jh is not None:
            self.handles.mark_done(jh, Status.ok(), None)

    def _run_loop_once(self) -> bool:
        _fi.fire("engine.cycle", str(self.rank))
        with self._queue_lock:
            msgs = self._request_queue
            self._request_queue = []
        if self.rank == 0:
            return self._coordinator_cycle(msgs)
        return self._worker_cycle(msgs)

    # -- cache classification (both roles, background thread only) -------

    def _classify(self, msgs: List[Request]):
        """Split popped requests into (uncached requests, hit events)."""
        requests: List[Request] = []
        hits: List[tuple] = []
        for req in msgs:
            if req.tensor_name in self._resend_uncached:
                self._resend_uncached.discard(req.tensor_name)
                requests.append(req)
                continue
            if not self._cache_classify_enabled:
                requests.append(req)
                continue
            state, pos = self._cache.classify(req)
            if state == rcache.HIT:
                hits.append((req.tensor_name, pos))
            else:
                requests.append(req)
        return requests, hits

    def _execute_cached_hits(self, hit_positions: List[int]) -> None:
        cached: List[Response] = []
        for p in hit_positions:
            resp = self._cache.get_by_position(p)
            if resp is None:
                # This rank's cache diverged from the coordinator's:
                # running the other hits would launch a different
                # collective sequence and hang the gang.  Fail fast.
                self.log.error(
                    "cache coherence violation: position %d missing "
                    "locally, aborting", p)
                self._abort(f"cache coherence violation: position {p}")
                return
            self._cache.touch(p)
            # A copy: fusion extends its inputs in place.
            cached.append(Response(
                response_type=resp.response_type,
                tensor_type=resp.tensor_type,
                tensor_names=list(resp.tensor_names),
                devices=list(resp.devices),
                tensor_sizes=list(resp.tensor_sizes),
                reduce_op=resp.reduce_op,
                prescale_factor=resp.prescale_factor,
                postscale_factor=resp.postscale_factor,
                tensor_shapes=list(resp.tensor_shapes),
            ))
        for resp in self._fuse_responses(cached):
            self._perform_operation(resp, from_cache=True)

    def _process_resends(self, resend_names: List[str]) -> None:
        """The coordinator could not resolve our hit (its entry was evicted
        in flight): requeue the full Request."""
        with self._queue_lock:
            for nm in resend_names:
                ent = self._table.get(nm)
                if ent is not None:
                    self._resend_uncached.add(nm)
                    self._request_queue.append(ent.request)

    # -- worker ---------------------------------------------------------

    def _worker_cycle(self, msgs: List[Request]) -> bool:
        requests, hit_events = self._classify(msgs)
        want_shutdown = self._shutdown_requested.is_set()
        send_failed = False
        if requests or hit_events or want_shutdown:
            payload = wire.encode_request_list(requests,
                                               shutdown=want_shutdown,
                                               cache_hits=hit_events,
                                               epoch=self.epoch)
            try:
                _fi.fire("ctrl.worker.send", str(self.rank))
                with self._ctrl_send_lock:
                    su.send_frame(self._ctrl_sock, su.TAG_REQUEST_LIST,
                                  payload)
            except (ConnectionError, OSError):
                # The coordinator may have closed right after its shutdown
                # frame; the receiver may hold it already.
                send_failed = True
        with self._response_lock:
            inbox = self._response_inbox
            self._response_inbox = []
        for payload in inbox:
            responses, shutdown, hit_positions, resend, params, epoch = \
                wire.decode_response_list(payload)
            if epoch != self.epoch:
                self.log.warning(
                    "dropping response frame from epoch %d (ours: %d)",
                    epoch, self.epoch)
                continue
            if params is not None:
                # Before this frame's hits: the threshold shapes the fused
                # launches, which must agree on every rank.
                self._apply_params(params)
            self._process_resends(resend)
            self._execute_cached_hits(hit_positions)
            for resp in responses:
                self._perform_operation(resp)
            if shutdown:
                self._shutdown_flag.set()
                return False
        if send_failed or self._ctrl_conn_lost:
            # Drain once more: a shutdown frame may have landed since.
            with self._response_lock:
                late = self._response_inbox
                self._response_inbox = []
            for payload in late:
                decoded = wire.decode_response_list(payload)
                if decoded[1] and decoded[5] == self.epoch:
                    self._shutdown_flag.set()
                    return False
            self._abort("lost connection to coordinator")
            return False
        return True

    def _apply_params(self, params) -> None:
        """A coordinator's knob broadcast.  The port's coordinator sends
        none (no autotuner); a JAX coordinator's may reach a port
        worker."""
        fusion, cycle_s, cache_on, hier_ar, hier_ag = params[:5]
        self.fusion_threshold = fusion
        self.cycle_time = cycle_s
        self._cache_classify_enabled = cache_on
        self.hierarchical_allreduce = hier_ar
        self.hierarchical_allgather = hier_ag
        if len(params) > 5:
            self.ring_segment_bytes = params[5]

    def hierarchical_topology_ok(self) -> bool:
        """True when the two-level data plane can run: a real local/cross
        split in the launcher's block rank layout."""
        from horovod_tpu_torch.runner.discovery import block_topology_ok

        return block_topology_ok(self.rank, self.size, self.local_rank,
                                 self.local_size, self.cross_rank,
                                 self.cross_size)

    # -- coordinator ----------------------------------------------------

    def _coordinator_cycle(self, msgs: List[Request]) -> bool:
        ready: List[str] = []
        shutdown = self._shutdown_requested.is_set()
        resend_by_rank: Dict[int, List[str]] = {}

        def _absorb(req: Request) -> None:
            if req.request_type == RequestType.JOIN:
                self._joined_ranks.add(req.request_rank)
                self._last_joined_rank = req.request_rank
                # Tensors waiting only on joined ranks become ready
                # (global-set entries only).
                for nm, lst in list(self._msg_table.entries.items()):
                    if lst[0].process_set_id == 0 and \
                            len(lst) == self.size - len(self._joined_ranks):
                        if nm not in ready:
                            ready.append(nm)
                return
            if self.timeline.enabled:
                # Start on the first request for this key: a process set
                # may not hold rank 0, and an End without a Start breaks
                # the trace.
                key = _MessageTable.key_of(req)
                if key not in self._msg_table.entries:
                    self.timeline.negotiate_start(
                        req.tensor_name, _OP_NAMES[req.request_type])
                self.timeline.negotiate_rank_ready(
                    req.tensor_name, req.request_rank)
            if self._msg_table.increment(req, len(self._joined_ranks)):
                ready.append(_MessageTable.key_of(req))

        def _absorb_hit(name: str, pos: int, rank: int) -> None:
            # A hit stands for the full Request: rebuild it from our own
            # (coherent) cache, or ask the sender to resend it if our
            # entry was evicted in flight.
            if self._cache.name_at(pos) != name:
                resend_by_rank.setdefault(rank, []).append(name)
                return
            req = self._cache.synthesize_request(pos, rank)
            self._hit_ranks.setdefault(name, set()).add(rank)
            _absorb(req)

        requests, own_hits = self._classify(msgs)
        for req in requests:
            _absorb(req)
        for name, pos in own_hits:
            _absorb_hit(name, pos, 0)
        with self._ctrl_lock:
            inbox = self._ctrl_inbox
            self._ctrl_inbox = []
        for peer, payload in inbox:
            reqs, peer_shutdown, peer_hits, peer_epoch = \
                wire.decode_request_list(payload)
            if peer_epoch != self.epoch:
                self.log.warning(
                    "rejecting request frame from rank %d at epoch %d "
                    "(ours: %d)", peer, peer_epoch, self.epoch)
                continue
            shutdown = shutdown or peer_shutdown
            for req in reqs:
                _absorb(req)
            for name, pos in peer_hits:
                _absorb_hit(name, pos, peer)

        responses: List[Response] = []
        hit_positions: List[int] = []
        for key in ready:
            reqs = self._msg_table.pop(key)
            name = reqs[0].tensor_name  # the key may be set-scoped
            if self.timeline.enabled:
                self.timeline.negotiate_end(name)
            hit_ranks = self._hit_ranks.pop(key, set())
            contributors = {r.request_rank for r in reqs}
            ent_pos = -1
            if hit_ranks >= contributors:
                # Every contributor hit, so every request came from the
                # same cache entry: the response is the cached one.
                ent_pos = self._cache.position_of(name)
            if ent_pos >= 0:
                hit_positions.append(ent_pos)
            else:
                responses.append(self._construct_response(name, reqs))

        if len(self._joined_ranks) == self.size:
            responses.append(Response(
                response_type=ResponseType.JOIN,
                tensor_sizes=[self._last_joined_rank]))
            self._joined_ranks = set()

        if not self.stall_check_disable:
            shutdown = self._check_stalls() or shutdown

        if responses or hit_positions or resend_by_rank or shutdown:
            fused = self._fuse_responses(responses)
            shared = None
            for r, s in self._ctrl_socks.items():
                resend = resend_by_rank.get(r, [])
                if resend:
                    payload = wire.encode_response_list(
                        fused, shutdown=shutdown,
                        hit_positions=hit_positions, resend_names=resend,
                        epoch=self.epoch)
                else:
                    if shared is None:
                        shared = wire.encode_response_list(
                            fused, shutdown=shutdown,
                            hit_positions=hit_positions, epoch=self.epoch)
                    payload = shared
                try:
                    _fi.fire("ctrl.coord.send", str(r))
                    with self._ctrl_send_lock:
                        su.send_frame(s, su.TAG_RESPONSE_LIST, payload)
                except (ConnectionError, OSError):
                    pass
            self._execute_cached_hits(hit_positions)
            for resp in fused:
                self._perform_operation(resp)
            if shutdown:
                self._shutdown_flag.set()
                return False
        return True

    def _check_stalls(self) -> bool:
        """Warn about tensors some ranks have submitted and others not for
        ``HVD_STALL_CHECK_TIME_SECONDS``; True (shut down) past
        ``HVD_STALL_SHUTDOWN_TIME_SECONDS`` when that is set."""
        now = time.monotonic()
        if now - self._last_stall_check < self.stall_warn_s / 4:
            return False
        self._last_stall_check = now
        shutdown = False
        for name, t0 in self._msg_table.first_seen.items():
            waited = now - t0
            if waited > self.stall_warn_s:
                have = sorted(r.request_rank
                              for r in self._msg_table.entries[name])
                missing = [r for r in range(self.size)
                           if r not in have and
                           r not in self._joined_ranks]
                self.log.warning(
                    "Stalled tensor %s: ready on ranks %s, waiting on %s "
                    "for %.0fs", name, have, missing, waited)
                if self.stall_shutdown_s > 0 and \
                        waited > self.stall_shutdown_s:
                    self.log.error(
                        "Stalled tensor %s exceeded shutdown threshold; "
                        "shutting down", name)
                    shutdown = True
        return shutdown

    # -- response construction ------------------------------------------

    def _construct_response(self, name: str, reqs: List[Request]) -> Response:
        first = reqs[0]
        err = None
        if any(r.request_type != first.request_type for r in reqs):
            err = (f"Mismatched collective operations for tensor {name}: "
                   + ", ".join(sorted({_OP_NAMES[r.request_type]
                                       for r in reqs})))
        elif any(r.process_set_id != first.process_set_id or
                 r.process_set_size != first.process_set_size
                 for r in reqs):
            err = f"Mismatched process sets for tensor {name}"
        elif first.process_set_id and \
                first.request_type == RequestType.JOIN:
            err = (f"{_OP_NAMES[first.request_type]} does not support "
                   f"process sets (tensor {name})")
        elif any(r.tensor_type != first.tensor_type for r in reqs):
            err = (f"Mismatched data types for tensor {name}: "
                   + ", ".join(sorted({r.tensor_type.name for r in reqs})))
        elif first.request_type == RequestType.ALLREDUCE:
            if any(r.tensor_shape != first.tensor_shape for r in reqs):
                err = (f"Mismatched allreduce tensor shapes for {name}: "
                       + ", ".join(sorted({str(r.tensor_shape)
                                           for r in reqs})))
            elif any(r.reduce_op != first.reduce_op for r in reqs):
                err = f"Mismatched reduce ops for tensor {name}"
            elif first.process_set_id and \
                    first.reduce_op == ReduceOp.ADASUM:
                err = (f"Adasum is not supported with process sets "
                       f"(tensor {name})")
        elif first.request_type == RequestType.BROADCAST:
            if any(r.root_rank != first.root_rank for r in reqs):
                err = (f"Mismatched broadcast root ranks for {name}: "
                       + ", ".join(sorted({str(r.root_rank)
                                           for r in reqs})))
            elif any(r.tensor_shape != first.tensor_shape for r in reqs):
                err = f"Mismatched broadcast tensor shapes for {name}"
            elif first.process_set_id:
                from horovod_tpu_torch import process_sets

                members = process_sets.ranks_of(first.process_set_id)
                if members is not None and \
                        first.root_rank not in members:
                    err = (f"broadcast root rank {first.root_rank} is "
                           f"not a member of process set "
                           f"{first.process_set_id} (tensor {name})")
        elif first.request_type == RequestType.ALLGATHER:
            for r in reqs:
                if r.tensor_shape.rank != first.tensor_shape.rank or \
                        r.tensor_shape.dims[1:] != first.tensor_shape.dims[1:]:
                    err = (f"Mismatched allgather tensor shapes for {name}: "
                           f"all dimensions except the first must match")
                    break
        elif first.request_type == RequestType.REDUCESCATTER:
            if any(r.tensor_shape != first.tensor_shape for r in reqs):
                err = (f"Mismatched reducescatter tensor shapes for "
                       f"{name}: "
                       + ", ".join(sorted({str(r.tensor_shape)
                                           for r in reqs})))
            elif any(r.reduce_op != first.reduce_op for r in reqs):
                err = f"Mismatched reduce ops for tensor {name}"
            elif first.reduce_op == ReduceOp.ADASUM:
                err = (f"Adasum is not defined for reducescatter "
                       f"(tensor {name})")

        if err is not None:
            return Response(response_type=ResponseType.ERROR,
                            tensor_names=[name], error_message=err)

        resp = Response(
            response_type=ResponseType(int(first.request_type)),
            tensor_names=[name],
            tensor_type=first.tensor_type,
            devices=[first.device],
            process_set_id=first.process_set_id,
        )
        if first.request_type == RequestType.ALLREDUCE:
            resp.tensor_sizes = [first.tensor_shape.num_elements]
            resp.reduce_op = first.reduce_op
            resp.prescale_factor = first.prescale_factor
            resp.postscale_factor = first.postscale_factor
            resp.tensor_shapes = [first.tensor_shape]
        elif first.request_type == RequestType.ALLGATHER:
            # First-dim size per rank in rank order (0 for joined ranks);
            # for a process set, per member in member order.
            by_rank = {r.request_rank: r for r in reqs}
            if first.process_set_id:
                from horovod_tpu_torch import process_sets

                members = process_sets.ranks_of(first.process_set_id)
                if members is None:
                    return Response(
                        response_type=ResponseType.ERROR,
                        tensor_names=[name],
                        error_message=(
                            f"process set {first.process_set_id} is not "
                            "registered on the coordinator (construct "
                            "the ProcessSet on every rank)"))
                order = members
            else:
                order = range(self.size)
            resp.tensor_sizes = [
                by_rank[r].tensor_shape.dims[0] if r in by_rank else 0
                for r in order]
        elif first.request_type == RequestType.BROADCAST:
            resp.tensor_sizes = [first.root_rank]
        elif first.request_type == RequestType.REDUCESCATTER:
            resp.tensor_sizes = [first.tensor_shape.num_elements]
            resp.reduce_op = first.reduce_op
            resp.tensor_shapes = [first.tensor_shape]
        return resp

    # -- fusion ----------------------------------------------------------

    def _fuse_responses(self, responses: List[Response]) -> List[Response]:
        """Merge consecutive allreduces of the same type, device, op,
        scale factors and process set while their bytes stay within the
        fusion threshold."""
        out: List[Response] = []
        pending: Optional[Response] = None
        pending_bytes = 0
        for r in responses:
            fusable = (r.response_type == ResponseType.ALLREDUCE
                       and not r.error_message)
            if not fusable:
                if pending is not None:
                    out.append(pending)
                    pending = None
                out.append(r)
                continue
            nbytes = sum(r.tensor_sizes) * r.tensor_type.itemsize
            if pending is not None and \
                    pending.tensor_type == r.tensor_type and \
                    pending.devices == r.devices and \
                    pending.reduce_op == r.reduce_op and \
                    pending.prescale_factor == r.prescale_factor and \
                    pending.postscale_factor == r.postscale_factor and \
                    pending.process_set_id == r.process_set_id and \
                    pending_bytes + nbytes <= self.fusion_threshold:
                pending.tensor_names.extend(r.tensor_names)
                pending.tensor_sizes.extend(r.tensor_sizes)
                pending.tensor_shapes.extend(r.tensor_shapes)
                pending_bytes += nbytes
            else:
                if pending is not None:
                    out.append(pending)
                pending = r
                pending_bytes = nbytes
        if pending is not None:
            out.append(pending)
        return out

    # -- execution -------------------------------------------------------

    def _get_entries(self, resp: Response) -> List[TensorTableEntry]:
        """The response's entries, or zero stand-ins where this rank has
        joined."""
        entries = []
        with self._queue_lock:
            for i, nm in enumerate(resp.tensor_names):
                if nm in self._table:
                    entries.append(self._table.pop(nm))
                    continue
                dt = floats.storage_dtype(resp.tensor_type)
                if resp.response_type == ResponseType.ALLREDUCE:
                    arr = np.zeros(resp.tensor_sizes[i], dt)
                elif resp.response_type == ResponseType.REDUCESCATTER:
                    # The negotiated shape: the scatter splits dim 0.
                    arr = np.zeros(tuple(resp.tensor_shapes[i].dims), dt)
                else:
                    arr = np.zeros(0, dt)
                req = Request(request_rank=self.rank, tensor_name=nm,
                              tensor_type=resp.tensor_type,
                              tensor_shape=TensorShape(arr.shape))
                entries.append(TensorTableEntry(nm, arr, -1, req))
        return entries

    def _perform_operation(self, resp: Response,
                           from_cache: bool = False) -> None:
        from horovod_tpu_torch.ops import cpu_backend

        if resp.process_set_id and \
                resp.response_type != ResponseType.ERROR:
            # Non-members skip a set's responses.
            from horovod_tpu_torch import process_sets

            members = process_sets.ranks_of(resp.process_set_id)
            if members is None or self.rank not in members:
                return

        if resp.response_type == ResponseType.JOIN:
            self._last_joined_rank = int(resp.tensor_sizes[0]) \
                if resp.tensor_sizes else -1
            with self._queue_lock:
                jh, self._join_handle = self._join_handle, None
            if jh is not None:
                self.handles.mark_done(jh, Status.ok(), None)
            return

        if resp.response_type == ResponseType.EVICT:
            raise NotImplementedError(
                "the coordinator evicted ranks (heartbeats), which the port "
                "does not run (ROADMAP Queue 1, item 5.3)")

        if resp.response_type == ResponseType.ERROR:
            for nm in resp.tensor_names:
                for e in self._get_entries(
                        Response(response_type=ResponseType.ERROR,
                                 tensor_names=[nm])):
                    self._release_name(e.name)
                    if e.handle >= 0:
                        self.handles.mark_done(
                            e.handle,
                            Status.precondition_error(resp.error_message),
                            None)
            return

        if not from_cache:
            # Before execution and whatever its outcome: the put stores
            # metadata only, and doing it in response-stream order keeps
            # every rank's cache the same.
            self._cache.put(resp)

        entries = self._get_entries(resp)
        op_name = resp.response_type.name
        self.timeline.start(resp.tensor_names[0], op_name)
        if self.response_log is not None:
            self.response_log.append(
                (resp.response_type.name, len(entries),
                 sum(int(e.array.nbytes) for e in entries), from_cache))
        try:
            if resp.response_type == ResponseType.ALLREDUCE:
                results = cpu_backend.allreduce(self, entries, resp)
            elif resp.response_type == ResponseType.ALLGATHER:
                results = cpu_backend.allgather(self, entries, resp)
            elif resp.response_type == ResponseType.BROADCAST:
                results = cpu_backend.broadcast(self, entries, resp)
            elif resp.response_type == ResponseType.ALLTOALL:
                results = cpu_backend.alltoall(self, entries, resp)
            elif resp.response_type == ResponseType.REDUCESCATTER:
                results = cpu_backend.reducescatter(self, entries, resp)
            elif resp.response_type == ResponseType.BARRIER:
                cpu_backend.barrier(self, resp)
                results = [None] * len(entries)
            else:
                raise RuntimeError(f"bad response type {resp.response_type}")
            status = Status.ok()
        except Exception as e:
            # A WireCorruptionError (the ladder exhausted every rung on a
            # link) lands here too: with no collective deadline (the port
            # has none yet) it is the collective's error on this rank, as
            # in the JAX engine.
            self.log.error("collective %s failed: %r", op_name, e)
            results = [None] * len(entries)
            status = Status.unknown_error(str(e))
        self.timeline.end(resp.tensor_names[0])
        for e, res in zip(entries, results):
            self._release_name(e.name)
            if e.handle >= 0:
                self.handles.mark_done(e.handle, status, res)

    def cache_stats(self) -> Dict[str, int]:
        return self._cache.stats()

    def _abort(self, reason: str) -> None:
        self._aborted = True
        self._abort_reason = reason
        self._shutdown_flag.set()
