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
one gang.

The control plane heals itself, each part under its knob:

* liveness (``HVD_HEARTBEAT_TIMEOUT``, alias ``HOROVOD_HEARTBEAT_TIMEOUT``):
  an idle worker sends ``TAG_HEARTBEAT`` every ``HVD_HEARTBEAT_INTERVAL``
  seconds, any frame counts as proof of life, and the coordinator evicts a
  rank silent past the timeout or whose control link dropped.  Evicted
  ranks become joined ranks, so that the in-flight step completes over the
  survivors (an ``EVICT`` response heads that cycle's list), and the next
  submission raises ``RanksFailedError``.  A collective that completed on
  the coordinator is proof of life of its whole group as well: no frame
  of theirs can flow while their background threads run it;
* collective deadlines (``HVD_COLLECTIVE_TIMEOUT``): every hop honours
  the collective's deadline (``ops/cpu_backend.py``); a rank whose hop
  blows it reports the peer it was blocked on (``TAG_ABORT_REPORT``), the
  coordinator probes the gang (``TAG_PROBE``, answered from each worker's
  receive thread with how long its collective has run), rules which ranks
  are wedged, and broadcasts ``TAG_ABORT_VERDICT``, so that every survivor
  fails the step with the same ``CollectiveTimeoutError``.  A
  ``WireCorruptionError`` (the ladder's last rung) takes the same road.
  The aborted allreduce's inputs are kept (:func:`take_retained_batch`),
  and ``@hvd.elastic.run`` replays them over the re-formed gang.  A
  failed ``torch.distributed`` collective under the wrapper takes the
  same agreement (:meth:`PyEngine.group_abort`), the process group's own
  error naming no rank: the report names the failed group, the verdict
  blames only its silent members, and the ranks outside it, waiting on
  the engine, apply the broadcast verdict.  Until a
  gang is re-formed its links may still hold the aborted collective's
  frames, so every later collective of the incarnation fails with the
  same error without touching them (an allreduce's inputs join the
  retained batch), and a survivor re-forms (or stops);
* the control tree (``HVD_CTRL_TREE``, default on; ``HVD_CTRL_FANOUT``): on
  a multi-host block topology the lowest local rank of every host but the
  root's folds its host's request and heartbeat frames into one
  ``TAG_TREE_UP``, the root routes probes down through ``TAG_TREE_DOWN``,
  and a child whose sub-coordinator died adopts itself to the root with
  ``TAG_REPARENT`` over the direct link every rank keeps
  (``SUBCOORD_REPARENT`` on the timeline).  A single-host gang plans no
  tree.

With every one of these knobs off (or on one host) the frames and threads
are the engine's core's.

Observability and tuning (``telemetry/``, ``autotune/``), the JAX engine's
hooks at the same sites:

* telemetry (``HVD_METRICS``, ``HVD_METRICS_PORT``, ``HVD_METRICS_FILE``):
  the cycle, queue-depth, negotiation, fusion and cache series, the
  liveness and abort counters, and on the coordinator the straggler
  detector (``HVD_STRAGGLER_WARN_MS``: a ``STRAGGLER`` timeline record when
  one rank is consistently last);
* the trace (``HVD_TRACE``): every rank writes ``negotiate``, ``pack``,
  ``hop``, ``unpack``, ``callback`` and ``collective`` spans under one
  collective seq, and a worker pings the coordinator's clock
  (``TAG_CLOCK_PING``, answered from the coordinator's receive thread);
* the flight recorder (on unless ``HVD_BLACKBOX=0``): collective begin and
  end, evictions, verdicts, corruption and aborts go into its ring, a
  terminal failure dumps it, and after an abort verdict the coordinator
  pulls the live workers' rings (``TAG_BLACKBOX``);
* the autotuner (``HVD_AUTOTUNE``): rank 0 scores each cycle's allreduced
  bytes and broadcasts new knobs in the next response list, which every
  rank, the coordinator included, applies before that frame's cached hits.

With the metrics, the trace and the autotuner off, each hook is one global
load and a ``None`` check: no thread, no clock read, no allocation, and the
same wire bytes.

The data plane: same-host peers pair over a shm ring unless
``HVD_SHM_DISABLE``, the others over TCP (``utils/transport.py``); with
``HVD_WIRE_CRC=1`` every pair is a self-healing ``LadderLink``
(``utils/ladder.py``) and the bootstrap listener stays open for its
re-dials.  ``HVD_HIERARCHICAL_ALLREDUCE``/``ALLGATHER`` turn on the
two-level collectives at a block topology
(:meth:`PyEngine.hierarchical_topology_ok`).  ``HVD_TIMELINE`` makes rank
0 write a Chrome-tracing timeline (``utils/timeline.py``), and
``HOROVOD_FAULT_PLAN`` arms the fault sites (``common/fault_injection.py``;
``engine.cycle``, ``ctrl.worker.send``, ``ctrl.coord.send``,
``ctrl.subcoord.send`` and ``ctrl.reparent`` here).

Membership epochs (``elastic/``): the engine's epoch is
``HVD_ELASTIC_EPOCH`` (0 unset), stamped on every list frame.  A worker
drops a response frame of another epoch; the coordinator answers a request
frame of another epoch with ``TAG_FENCE`` (counted in
``hvd_fenced_writes_total``, noted ``epoch.fence`` on the recorder), and
the fenced worker's next cycle aborts with the typed ``FencedError``,
which its next submission and its pending handles raise: a rank the gang
re-formed without exits instead of corrupting it.  Rank 0's timeline
records ``ELASTIC_EPOCH_<n>`` at a nonzero epoch.

The serving loop's channel (``serving/loop.py``): rank 0's
``serve_broadcast`` pushes one ``TAG_SERVE`` frame (``wire``'s serve delta)
to every live worker and into its own inbox, and every rank's
``serve_recv`` takes the next frame.  A loop parked in ``serve_recv`` wakes
on an abort, a fence, a lost coordinator and a shutdown; after an eviction
``serve_recv`` raises ``RanksFailedError``, so that the loop re-forms as a
failed collective does.  Each engine object has its own inbox, so that a
re-formed gang (a new engine) starts with an empty one.  A
``SingleProcessEngine`` has the same pair: its broadcast is a local
enqueue.
"""

from __future__ import annotations

import logging
import os
import select
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from horovod_tpu_torch import telemetry as _telemetry
from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common import floats
from horovod_tpu_torch.common import response_cache as rcache
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common.types import (
    CollectiveTimeoutError,
    DataType,
    FencedError,
    RanksFailedError,
    ReduceOp,
    Request,
    RequestType,
    Response,
    ResponseType,
    Status,
    StatusType,
    TensorShape,
    dtype_from_numpy,
)
from horovod_tpu_torch.telemetry import blackbox as blackbox_mod
from horovod_tpu_torch.telemetry import registry as _tmx
from horovod_tpu_torch.telemetry import trace as trace_mod
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

# The abort agreement's name for a failed torch.distributed collective
# (PyEngine.group_abort): the elastic wrapper's, apart from any tensor's.
# A report names the failed group's ranks after a colon
# ("__torch.distributed:0,1"); bare, the group is the whole gang.
GROUP_ABORT = "__torch.distributed"


def _group_abort_name(ranks: Optional[Sequence[int]]) -> str:
    if ranks is None:
        return GROUP_ABORT
    return GROUP_ABORT + ":" + ",".join(str(r) for r in sorted(set(ranks)))


def _group_abort_members(name: str) -> Optional[Set[int]]:
    """The ranks of the group a :data:`GROUP_ABORT` report names (None:
    the whole gang)."""
    _head, _, tail = name.partition(":")
    return {int(r) for r in tail.split(",")} if tail else None


def _is_group_abort(name: str) -> bool:
    return name.partition(":")[0] == GROUP_ABORT


def _merge_group_abort(a: str, b: str) -> str:
    """One name for the reports of two failed groups: their union."""
    ma, mb = _group_abort_members(a), _group_abort_members(b)
    return _group_abort_name(None if ma is None or mb is None
                             else ma | mb)


def _same_abort(a: str, b: str) -> bool:
    """Two reports of one agreement: the same collective, or failures of
    process-group collectives, whichever groups (one verdict rules them
    all)."""
    return a == b or (_is_group_abort(a) and _is_group_abort(b))

# Knobs that turn on a feature the port has not ported yet: (variable,
# when it is on: "bool" true, "positive" > 0, "set" non-empty; the
# ROADMAP Queue 1 item that brings it).  Every engine knob is ported.
_LEFT_OUT: tuple = ()


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


# The retention of an aborted batch: when the gang aborts an allreduce
# (CollectiveTimeoutError), each survivor keeps copies of its original
# inputs here (the ring works on the fusion buffer, never on the entries'
# arrays).  Module-level, so that it outlives the engine: elastic's replay
# tears the engine down and replays them on the next one.
_replay_lock = threading.Lock()
_replay_batch: Optional[List[dict]] = None


def retain_aborted_batch(batch: List[dict]) -> None:
    global _replay_batch
    with _replay_lock:
        _replay_batch = batch


def take_retained_batch() -> Optional[List[dict]]:
    """Pop the retained aborted batch (None when nothing was aborted).
    Each item: {name, array (a copy of the input), op, prescale,
    postscale}."""
    global _replay_batch
    with _replay_lock:
        batch, _replay_batch = _replay_batch, None
    return batch


class HandleManager:
    """Async handle table.  A failed status raises its typed exception
    (``Status.exc``, a ``CollectiveTimeoutError`` for instance) where it
    has one."""

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
    (in the storage type of ``request.tensor_type``).  ``enqueue_ns`` is
    its enqueue's monotonic clock, read only with the trace on (0 off)."""

    name: str
    array: np.ndarray
    handle: int
    request: Request
    root_rank: int = -1
    splits: Optional[List[int]] = None
    enqueue_ns: int = 0


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
        _telemetry.init_from_env(0, 0)
        self._tracer = None  # the trace needs a gang
        # The serving loop's channel: a broadcast to a gang of one is a
        # local enqueue, so that the loop's drive and apply run unchanged.
        self.epoch = 0
        self._aborted = False
        self._serve_inbox: List[bytes] = []
        self._serve_cv = threading.Condition()
        self._shutdown_requested = threading.Event()
        self._shutdown_flag = threading.Event()

    def shutdown(self):
        self._shutdown_flag.set()
        with self._serve_cv:
            self._serve_cv.notify_all()
        self.timeline.shutdown()

    def serve_broadcast(self, payload: bytes) -> None:
        with self._serve_cv:
            self._serve_inbox.append(payload)
            self._serve_cv.notify_all()

    def serve_recv(self, timeout: float) -> Optional[bytes]:
        deadline = time.monotonic() + timeout
        with self._serve_cv:
            while True:
                if self._serve_inbox:
                    return self._serve_inbox.pop(0)
                if self._shutdown_flag.is_set() \
                        or self._shutdown_requested.is_set():
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._serve_cv.wait(min(0.05, remaining))

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

    # Set by ``free_groups_on_failure`` (an elastic rank on an NCCL
    # group): the groups' abort, and eviction on a dropped link.
    _abort_groups: Optional[Callable[[str], object]] = None
    _evict_on_lost_link = False

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
        # Why ``hvd.init()`` started this engine and not the native one
        # (set by ``basics``), or None.
        self.native_fallback_reason = None
        # The elastic membership epoch, stamped on every list frame: a
        # frame of another incarnation is dropped (worker) or fenced
        # (coordinator), so that a zombie cannot touch this gang.
        self.epoch = env_util.get_int(env_util.ELASTIC_EPOCH, 0)
        # When a list, every executed response appends (type, tensors,
        # bytes, from_cache) to it: the card's engine phase reads it.
        self.response_log: Optional[list] = None

        # Telemetry: the hooks cost a None check when it is off; call
        # sites whose arguments allocate guard on this flag.  The
        # straggler detector is the coordinator's: it folds the ready
        # ticks it sees into a skew histogram.
        self._metrics_on = _telemetry.init_from_env(rank, local_rank,
                                                    size=size)
        self._straggler = None
        if self._metrics_on:
            _tmx.set_gauge("hvd_elastic_epoch", self.epoch)
            if rank == 0:
                self._straggler = _telemetry.StragglerDetector(
                    env_util.get_float(env_util.STRAGGLER_WARN_MS, 0.0),
                    size)

        # The gang-wide trace: every rank's spans; None with HVD_TRACE
        # unset, and every hot-path hook is then a None check.
        self._tracer = trace_mod.from_env(rank)
        self._clock_sync_cycles = env_util.trace_clock_sync_cycles()
        self._clock_ping_countdown = 0  # 0 = ping on the next cycle
        if self._tracer is not None and rank == 0:
            # The coordinator's clock is the gang's axis: offset 0.
            self._tracer.clock(0, 0)

        # The always-on flight recorder, process-global so that its ring
        # outlives the engine; every terminal failure below dumps it.
        self._blackbox = blackbox_mod.from_env(rank, epoch=self.epoch)
        self._blackbox_seq = 0
        if self._blackbox is not None:
            self._blackbox.note("engine.init", 0,
                                {"rank": rank, "size": size,
                                 "epoch": self.epoch})

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
        self._abort_exc = None  # a typed abort (FencedError)
        self._ctrl_conn_lost = False
        self._fenced: Optional[tuple] = None  # a worker's TAG_FENCE

        # coordinator state
        self._msg_table = _MessageTable(size) if rank == 0 else None
        self._joined_ranks: set = set()
        self._ctrl_inbox: list = []
        self._ctrl_lock = threading.Lock()
        # Control sends leave the background thread and, for probe acks and
        # routed frames, the receive threads, and on the coordinator the
        # serving loop's thread (TAG_SERVE): one lock keeps frames whole.
        self._ctrl_send_lock = threading.Lock()
        # The serving loop's inbox (TAG_SERVE frames; the coordinator
        # delivers its own directly), drained by serve_recv().
        self._serve_inbox: List[bytes] = []
        self._serve_cv = threading.Condition()
        self._last_stall_check = time.monotonic()

        # The control tree, planned from the block topology before the
        # bootstrap, which dials its links.
        self.ctrl_fanout = env_util.ctrl_fanout()
        self._tree_parent, self._tree_children, self._rank_route = \
            self._plan_tree()
        self._tree_parent_sock = None      # a child's link up
        self._tree_child_socks: Dict[int, socket.socket] = {}
        self._tree_up_buf: List[tuple] = []  # a sub-coordinator's backlog
        self._tree_up_lock = threading.Lock()
        self._tree_orphaned = False        # a child whose parent died
        # A child's last request payloads sent up the tree, resent after a
        # re-parent: the dead parent may not have relayed them (the
        # coordinator ignores a rank's second tick for a name).
        self._tree_unacked: List[bytes] = []
        self._reparented_ranks: set = set()  # the root's adopted orphans

        # Liveness (off at timeout 0: no heartbeat frames, no clock reads
        # on the receive threads).
        self.heartbeat_timeout = env_util.heartbeat_timeout_s()
        self.heartbeat_interval = env_util.heartbeat_interval_s(
            self.heartbeat_timeout)
        self._evicted_ranks: set = set()      # every rank
        self._ranks_failed: List[int] = []    # raised at the next enqueue
        self._conn_lost: set = set()          # the root's dropped links
        self._last_seen: Dict[int, float] = {}
        self._last_send = time.monotonic()
        # A worker's collective in flight, and the data plane's receive
        # count (socketutil.rx_chunks) at its start or its last beat: what
        # _busy_heartbeat reads.
        self._op_busy = False
        self._hb_mark = 0

        # Collective deadlines and the abort agreement (off at 0).
        self.collective_timeout = env_util.collective_timeout_s()
        self.collective_probe_timeout = env_util.collective_probe_timeout_s(
            self.collective_timeout)
        self._abort_inbox: List[tuple] = []   # the root's reports and acks
        self._abort_lock = threading.Lock()
        # A worker's verdict, handed from its receive thread to its
        # background thread.
        self._abort_verdict: Optional[tuple] = None
        self._abort_cv = threading.Condition(self._abort_lock)
        # The busy marker a probe ack reads: when the running collective
        # started (0.0 = idle), kept only with the deadline knob on.
        self._in_collective_since = 0.0
        # The root's last verdict, resent to a rank that reports late.
        self._last_verdict: Optional[tuple] = None
        # After an agreed abort: its error, which every later collective of
        # this incarnation fails with (the links may hold the aborted
        # one's frames), and the inputs retained for the replay.
        self._collective_err: Optional[CollectiveTimeoutError] = None
        self._retained: List[dict] = []
        # The root's pulled flight-recorder rings (TAG_BLACKBOX_DUMP),
        # captured by its receive threads after a verdict.
        self._blackbox_inbox: List[tuple] = []
        self._blackbox_lock = threading.Lock()

        # Response cache; touched only on the background thread.
        self._cache = rcache.ResponseCache(
            env_util.get_int(env_util.CACHE_CAPACITY, 1024))
        self._cache_classify_enabled = True
        self._resend_uncached: set = set()
        self._hit_ranks: Dict[str, set] = {}

        # The autotuner, the coordinator's alone: it tunes and broadcasts.
        self._pm = None
        if rank == 0:
            from horovod_tpu_torch.autotune import ParameterManager

            self._pm = ParameterManager.from_env(
                self.fusion_threshold, self.cycle_time,
                self.hierarchical_allreduce, self.hierarchical_allgather,
                hierarchical_ok=self.hierarchical_topology_ok(),
                ring_segment_bytes=self.ring_segment_bytes)
        self._pending_params = None

        try:
            self._bootstrap(rdv_addr, rdv_port)
        except BaseException:
            self.timeline.shutdown()
            trace_mod.release(self._tracer)
            raise
        if self.epoch and self.timeline.enabled:
            self.timeline.elastic_event(f"ELASTIC_EPOCH_{self.epoch}",
                                        size=self.size)
        self._bg = threading.Thread(
            target=self._background_loop, name="hvd-background", daemon=True)
        self._bg.start()

    # ------------------------------------------------------------------
    # the control tree
    # ------------------------------------------------------------------

    def _plan_tree(self):
        """``(parent, children, route)`` of the two-level control tree:
        ``parent`` is this rank's sub-coordinator (None: it talks to the
        root directly, as the root, the sub-coordinators, the root's host
        and a fan-out's overflow do), ``children`` the ranks this
        sub-coordinator folds, ``route`` the root's map child ->
        sub-coordinator.  Empty on one host, on a non-block layout and
        under ``HVD_CTRL_TREE=0``: the flat star."""
        none = (None, [], {})
        if self.size <= 1 or self.local_size <= 1 or self.cross_size <= 1:
            return none
        if not env_util.ctrl_tree_on():
            return none
        if not self.hierarchical_topology_ok():
            return none
        fanout = self.ctrl_fanout
        parent, children, route = None, [], {}
        ls = self.local_size
        for host in range(1, self.cross_size):
            sub = host * ls
            if sub >= self.size:
                break
            members = list(range(sub + 1, min((host + 1) * ls, self.size)))
            folded = members if fanout <= 0 else members[:fanout]
            for c in folded:
                route[c] = sub
                if c == self.rank:
                    parent = sub
            if self.rank == sub:
                children = folded
        return parent, children, route

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
        tree = {"parent": self._tree_parent,
                "children": self._tree_children}
        if ladder_on:
            (self._data, self._ctrl_sock, self._ctrl_socks, kv, kv_prefix,
             mesh_peers, mesh_listener) = bootstrap_mesh(
                self.rank, self.size, rdv_addr, rdv_port,
                keep_listener=True, tree=tree)
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
                                         rdv_port, tree=tree)
            self._transports = tpt.build_transports(
                self.rank, self.size, self._data, kv, kv_prefix)
            # A shm transport's sender thread lives inside it: one sender
            # thread a peer either way.
            self._senders = {r: t.sender
                             for r, t in self._transports.items()
                             if t.kind == "tcp"}
        self._tree_parent_sock = tree.get("parent_sock")
        self._tree_child_socks = tree.get("child_socks") or {}
        self._fusion_buf = FusionBuffer()
        self._response_inbox: List[bytes] = []
        self._response_lock = threading.Lock()
        self._response_cv = threading.Condition(self._response_lock)
        if self.rank == 0:
            now = time.monotonic()
            self._last_seen = {r: now for r in self._ctrl_socks}
            for r, s in self._ctrl_socks.items():
                threading.Thread(target=self._ctrl_recv_loop,
                                 args=(r, s), daemon=True).start()
        else:
            threading.Thread(target=self._worker_recv_loop,
                             daemon=True).start()
            if self._tree_parent_sock is not None:
                threading.Thread(target=self._tree_parent_recv_loop,
                                 daemon=True).start()
            for r, s in self._tree_child_socks.items():
                threading.Thread(target=self._tree_child_recv_loop,
                                 args=(r, s), daemon=True).start()

    def _ctrl_recv_loop(self, peer_rank: int, sock: socket.socket) -> None:
        try:
            while not self._shutdown_flag.is_set():
                tag, payload = su.recv_frame(sock)
                self._dispatch_ctrl_frame(peer_rank, tag, payload)
        except (ConnectionError, OSError):
            # EOF or reset: a dead rank, acted on with liveness on or
            # after free_groups_on_failure (_check_dead_ranks).
            self._conn_lost.add(peer_rank)

    def _dispatch_ctrl_frame(self, peer_rank: int, tag: int,
                             payload: bytes) -> None:
        """The root's dispatch of one control frame, from a rank's own
        socket or unfolded from a ``TAG_TREE_UP`` (``peer_rank`` is then
        the entry's origin)."""
        if self.heartbeat_timeout > 0:
            # Any frame is proof of life; TAG_HEARTBEAT carries nothing
            # else.
            self._last_seen[peer_rank] = time.monotonic()
        if tag == su.TAG_REQUEST_LIST:
            with self._ctrl_lock:
                self._ctrl_inbox.append((peer_rank, payload))
        elif tag == su.TAG_TREE_UP:
            entries, _epoch = wire.decode_tree_up(payload)
            for origin, etag, epayload in entries:
                self._dispatch_ctrl_frame(origin, etag, epayload)
        elif tag == su.TAG_REPARENT:
            _rank, old_parent, _epoch = wire.decode_reparent(payload)
            self._note_reparent(peer_rank, old_parent)
        elif tag in (su.TAG_ABORT_REPORT, su.TAG_PROBE_ACK):
            with self._abort_lock:
                self._abort_inbox.append((peer_rank, tag, payload))
        elif tag == su.TAG_CLOCK_PING:
            # The trace's clock sync: echo the worker's t0 with our clock,
            # from this thread, so that the estimate never waits on a busy
            # background cycle.  Pings ride the worker's direct socket.
            t0_ns, pepoch = wire.decode_clock_ping(payload)
            pong = wire.encode_clock_pong(t0_ns, time.monotonic_ns(),
                                          pepoch)
            sock = self._ctrl_socks.get(peer_rank)
            if sock is not None:
                try:
                    with self._ctrl_send_lock:
                        su.send_frame(sock, su.TAG_CLOCK_PONG, pong)
                except (ConnectionError, OSError):
                    pass  # the liveness owns the eviction
        elif tag == su.TAG_BLACKBOX_DUMP:
            # A worker's recorder ring, answering the post-verdict pull.
            with self._blackbox_lock:
                self._blackbox_inbox.append((peer_rank, payload))

    def _note_reparent(self, rank: int, old_parent: int) -> None:
        """Root: an orphan of a dead sub-coordinator adopted itself to the
        star.  Only the dead parent is evicted; the orphan keeps its seat
        and its collectives ride on."""
        self._reparented_ranks.add(rank)
        self._rank_route.pop(rank, None)
        self.log.warning(
            "rank %d re-parented to the root (sub-coordinator %d died)",
            rank, old_parent)
        _tmx.inc_counter("hvd_subcoord_reparents_total")
        blackbox_mod.note("subcoord.reparent", time.monotonic_ns(),
                          rank=rank, old_parent=old_parent, epoch=self.epoch)
        if self.timeline.enabled:
            self.timeline.instant(timeline_mod.SUBCOORD_REPARENT,
                                  rank=rank, old_parent=old_parent)

    def _worker_recv_loop(self) -> None:
        # With liveness on, the loop wakes at half the heartbeat cadence
        # between frames to beat for a busy background thread.
        tick = self.heartbeat_interval / 2 if self.heartbeat_timeout > 0 \
            else None
        try:
            while not self._shutdown_flag.is_set():
                if tick is not None and not self._ctrl_readable(tick):
                    self._busy_heartbeat()
                    continue
                tag, payload = su.recv_frame(self._ctrl_sock)
                self._dispatch_worker_frame(tag, payload)
        except (ConnectionError, OSError):
            # Coordinator EOF: expected during a negotiated shutdown;
            # otherwise the next worker cycle drains any shutdown frame
            # already received and only then declares the hub lost.
            if not (self._shutdown_flag.is_set()
                    or self._shutdown_requested.is_set() or self._closed):
                self._ctrl_conn_lost = True
                # The abort fires from the next worker cycle; wake a
                # serving loop parked in serve_recv now, and a failed
                # hop's wait for a verdict that cannot come.
                self._wake_serve()
                with self._abort_cv:
                    self._abort_cv.notify_all()

    def _wake_serve(self) -> None:
        with self._serve_cv:
            self._serve_cv.notify_all()

    def _dispatch_worker_frame(self, tag: int, payload: bytes) -> None:
        """A worker's dispatch of one root frame, from its direct socket
        or forwarded down by its sub-coordinator.  Replies go up the
        direct socket, which stays live while a sub-coordinator dies."""
        if tag == su.TAG_TREE_DOWN:
            # A sub-coordinator: forward a root frame to one child or all.
            target, itag, ipayload = wire.decode_tree_down(payload)
            for r, s in list(self._tree_child_socks.items()):
                if target != -1 and r != target:
                    continue
                try:
                    _fi.fire("ctrl.subcoord.send", str(r))
                    with self._ctrl_send_lock:
                        su.send_frame(s, itag, ipayload)
                except (ConnectionError, OSError):
                    pass  # the root's liveness owns the eviction
            return
        if tag == su.TAG_FENCE:
            # The coordinator is at another membership epoch and this rank
            # has no seat there: the next worker cycle raises FencedError.
            self._fenced = wire.decode_fence(payload)
            self._wake_serve()
            return
        if tag == su.TAG_RESPONSE_LIST:
            with self._response_cv:
                self._response_inbox.append(payload)
                self._response_cv.notify_all()
        elif tag == su.TAG_PROBE:
            # Answered from this thread: the background thread may be the
            # one wedged in the data plane.
            since = self._in_collective_since
            busy_s = (time.monotonic() - since) if since else 0.0
            ack = wire.encode_probe_ack(since > 0.0, busy_s, self.epoch)
            try:
                with self._ctrl_send_lock:
                    su.send_frame(self._ctrl_sock, su.TAG_PROBE_ACK, ack)
            except (ConnectionError, OSError):
                pass
        elif tag == su.TAG_ABORT_VERDICT:
            vname, vranks, vepoch = wire.decode_abort_verdict(payload)
            if vepoch != self.epoch:
                return
            with self._abort_cv:
                self._abort_verdict = (vname, vranks)
                self._abort_cv.notify_all()
            if _is_group_abort(vname) and vranks and \
                    self.rank not in vranks:
                # A group's verdict reaches the ranks outside the failed
                # group too, which wait on the engine and report nothing.
                self._apply_group_verdict(vname, vranks, time.monotonic())
        elif tag == su.TAG_SERVE:
            with self._serve_cv:
                self._serve_inbox.append(payload)
                self._serve_cv.notify_all()
        elif tag == su.TAG_CLOCK_PONG:
            # The midpoint method: the offset maps this rank's monotonic
            # clock onto rank 0's.
            t1_ns = time.monotonic_ns()
            t0_ns, tc_ns, pepoch = wire.decode_clock_pong(payload)
            tr = self._tracer
            if tr is not None and pepoch == self.epoch:
                offset_ns = tc_ns - (t0_ns + t1_ns) // 2
                tr.clock(offset_ns, t1_ns - t0_ns)
                blackbox_mod.note_clock_offset(offset_ns)
                if self._metrics_on:
                    _tmx.set_gauge("hvd_trace_clock_skew_seconds",
                                   offset_ns / 1e9)
        elif tag == su.TAG_BLACKBOX:
            # The coordinator pulls our recorder's ring after a verdict:
            # answered from this thread, since the background thread may
            # be the wedged party.
            bb = blackbox_mod.get()
            if bb is not None:
                reply = wire.encode_blackbox_dump(
                    self.rank, self.epoch, bb.dump_bytes("coordinator_pull"))
                try:
                    with self._ctrl_send_lock:
                        su.send_frame(self._ctrl_sock,
                                      su.TAG_BLACKBOX_DUMP, reply)
                except (ConnectionError, OSError):
                    pass

    # -- the control tree's links -----------------------------------------
    #
    # A child sends its request and heartbeat frames to its host's
    # sub-coordinator, which folds them with its own into one TAG_TREE_UP
    # each cycle.  Responses always ride the direct star: nothing that
    # cannot be resent transits the tree.

    def _tree_parent_recv_loop(self) -> None:
        """A child: frames its sub-coordinator forwards down (routed
        probes).  EOF here makes it re-parent: its direct link to the root
        is still up."""
        sock = self._tree_parent_sock
        try:
            while not self._shutdown_flag.is_set():
                tag, payload = su.recv_frame(sock)
                self._dispatch_worker_frame(tag, payload)
        except (ConnectionError, OSError):
            if not (self._shutdown_flag.is_set()
                    or self._shutdown_requested.is_set() or self._closed):
                self._reparent_to_root()

    def _tree_child_recv_loop(self, child: int,
                              sock: socket.socket) -> None:
        """A sub-coordinator: buffer a child's frames for the next
        ``TAG_TREE_UP``.  A child's EOF is the root's to act on (its
        heartbeat timeout)."""
        try:
            while not self._shutdown_flag.is_set():
                tag, payload = su.recv_frame(sock)
                with self._tree_up_lock:
                    self._tree_up_buf.append((child, tag, payload))
        except (ConnectionError, OSError):
            pass

    def _reparent_to_root(self) -> None:
        """A child of a dead sub-coordinator: announce ``TAG_REPARENT`` on
        the direct link and resend the request payloads the parent may not
        have relayed.  From here on this rank speaks the flat star."""
        with self._ctrl_send_lock:
            if self._tree_orphaned or self._tree_parent is None:
                return
            self._tree_orphaned = True
        old = self._tree_parent
        self.log.warning(
            "sub-coordinator %d unreachable; re-parenting to the root", old)
        try:
            _fi.fire("ctrl.reparent", str(self.rank))
            with self._ctrl_send_lock:
                su.send_frame(self._ctrl_sock, su.TAG_REPARENT,
                              wire.encode_reparent(self.rank, old,
                                                   self.epoch))
                for payload in list(self._tree_unacked):
                    su.send_frame(self._ctrl_sock, su.TAG_REQUEST_LIST,
                                  payload)
            self._last_send = time.monotonic()
            _tmx.inc_counter("hvd_subcoord_reparents_total")
            blackbox_mod.note("subcoord.reparent", time.monotonic_ns(),
                              rank=self.rank, old_parent=old,
                              epoch=self.epoch)
        except (ConnectionError, OSError):
            # The direct link is gone too: a dead hub, which the lost-
            # coordinator abort owns.
            self._ctrl_conn_lost = True
            self._wake_serve()

    # -- the serving loop's channel (serving/loop.py) ----------------------

    def serve_broadcast(self, payload: bytes) -> None:
        """The coordinator: push one serve-delta frame to every live
        worker and into its own inbox.  Called from the serving loop's
        thread, hence the control send lock."""
        if self.rank != 0:
            raise RuntimeError("serve_broadcast is coordinator-only")
        for r, s in self._ctrl_socks.items():
            if r in self._evicted_ranks:
                continue
            try:
                with self._ctrl_send_lock:
                    su.send_frame(s, su.TAG_SERVE, payload)
            except (ConnectionError, OSError):
                pass  # the liveness machinery owns the eviction
        with self._serve_cv:
            self._serve_inbox.append(payload)
            self._serve_cv.notify_all()

    def serve_recv(self, timeout: float) -> Optional[bytes]:
        """The next serve-delta frame, waiting up to ``timeout`` s.  None
        on a timeout, an abort or a local shutdown; raises
        ``RanksFailedError`` once peers were evicted, so that the serving
        loop re-forms as a failed collective does."""
        deadline = time.monotonic() + timeout
        with self._serve_cv:
            while True:
                if self._serve_inbox:
                    return self._serve_inbox.pop(0)
                if self._ranks_failed:
                    raise RanksFailedError(self._ranks_failed)
                if self._aborted or self._shutdown_flag.is_set() \
                        or self._shutdown_requested.is_set():
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                # Short slices: a frame notifies, but an abort or a
                # shutdown must wake this thread too.
                self._serve_cv.wait(min(0.05, remaining))

    # ------------------------------------------------------------------
    # enqueue API (framework-thread side)
    # ------------------------------------------------------------------

    def _enqueue(self, entry: TensorTableEntry) -> int:
        if self._ranks_failed:
            # The in-flight steps completed over the survivors; the next
            # submission is where the training loop can react.
            raise RanksFailedError(self._ranks_failed)
        if self._abort_exc is not None:
            # A typed abort (FencedError): the class is the signal, which
            # the elastic wrapper lets through (a fenced rank exits).
            raise self._abort_exc
        if self._aborted or self._shutdown_flag.is_set() \
                or self._shutdown_requested.is_set():
            raise RuntimeError("horovod_tpu_torch runtime has been shut down")
        self._claim_name(entry.name)
        if self._tracer is not None:
            entry.enqueue_ns = time.monotonic_ns()
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
        self._wake_serve()
        self._loop_exited.wait(timeout=10)
        self._shutdown_flag.set()
        self._bg.join(timeout=10)
        self.timeline.shutdown()
        trace_mod.release(self._tracer)
        self._tracer = None
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
        # The tree's links too: closing them ends their receive threads
        # (``_closed`` keeps that EOF from reading as a dead parent).
        socks += list(self._tree_child_socks.values())
        if self._tree_parent_sock is not None:
            socks.append(self._tree_parent_sock)
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
                _tmx.inc_counter("hvd_cycles_total")
                _tmx.observe("hvd_cycle_duration_seconds", dt)
                if self.rank == 0:
                    # The root's coordination cost, keyed by gang size.
                    _tmx.observe("hvd_ctrl_cycle_seconds", dt,
                                 labels=(str(self.size),))
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
        """Fail the handles still pending when the loop stops.  After an
        eviction, a stop that is not an abort fails them with the
        eviction's ``RanksFailedError``: a collective submitted before this
        rank saw the ``EVICT`` is stranded when a survivor that saw it
        first stops the gang to re-form, and ``@hvd.elastic.run`` must
        re-form here too (the JAX package's engine fails it as a plain
        shutdown).  An abort (a lost coordinator) keeps its reason."""
        with self._queue_lock:
            entries = list(self._table.values())
            self._table.clear()
            self._request_queue.clear()
            jh, self._join_handle = self._join_handle, None
        reason = self._abort_reason or "Horovod has been shut down."
        if self._abort_exc is not None:
            status = Status(StatusType.ABORTED, reason, self._abort_exc)
        elif self._ranks_failed and not self._aborted:
            status = Status(StatusType.ABORTED, reason,
                            RanksFailedError(self._ranks_failed))
        else:
            status = Status.aborted(reason)
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
        _tmx.set_gauge("hvd_queue_depth", len(msgs))
        if self.rank == 0:
            return self._coordinator_cycle(msgs)
        return self._worker_cycle(msgs)

    # -- cache classification (both roles, background thread only) -------

    def _classify(self, msgs: List[Request]):
        """Split popped requests into (uncached requests, hit events)."""
        requests: List[Request] = []
        hits: List[tuple] = []
        misses = 0
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
                misses += 1
        if hits:
            _tmx.inc_counter("hvd_cache_hits_total", len(hits))
        if misses:
            _tmx.inc_counter("hvd_cache_misses_total", misses)
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

    def _uplink(self) -> Optional[socket.socket]:
        """A child's link to its live sub-coordinator, else None."""
        if self._tree_parent is not None and not self._tree_orphaned:
            return self._tree_parent_sock
        return None

    def _maybe_clock_ping(self) -> None:
        """The trace's clock sync: a ping on the direct control socket at
        the first cycle and every ``HVD_TRACE_CLOCK_SYNC_CYCLES`` cycles."""
        n = self._clock_ping_countdown
        if n > 0:
            self._clock_ping_countdown = n - 1
            return
        self._clock_ping_countdown = self._clock_sync_cycles
        try:
            ping = wire.encode_clock_ping(time.monotonic_ns(), self.epoch)
            with self._ctrl_send_lock:
                su.send_frame(self._ctrl_sock, su.TAG_CLOCK_PING, ping)
            self._last_send = time.monotonic()
        except (ConnectionError, OSError):
            pass  # a dead hub shows in the receive thread

    def _send_heartbeat(self) -> bool:
        """One ``TAG_HEARTBEAT`` up this rank's control path (a
        sub-coordinator's inside a ``TAG_TREE_UP``); False when the send
        failed."""
        try:
            with self._ctrl_send_lock:
                if self._tree_child_socks:
                    su.send_frame(self._ctrl_sock, su.TAG_TREE_UP,
                                  wire.encode_tree_up(
                                      [(self.rank, su.TAG_HEARTBEAT, b"")],
                                      epoch=self.epoch))
                else:
                    su.send_frame(self._uplink() or self._ctrl_sock,
                                  su.TAG_HEARTBEAT, b"")
            return True
        except (ConnectionError, OSError):
            return False

    def _ctrl_readable(self, timeout: float) -> bool:
        try:
            return bool(select.select([self._ctrl_sock], [], [],
                                      timeout)[0])
        except ValueError:  # the socket was closed under the wait
            raise ConnectionError("control socket closed") from None

    def _busy_heartbeat(self) -> None:
        """A worker's heartbeat while its background thread runs a
        collective, which sends no control frame until it ends; called by
        the worker's receive thread between frames.  The coordinator counts
        a collective as proof of life only when its own part completes,
        and a receiving rank may be busy long after that: a root's send
        ends once the payload sits in the socket buffers, and the receiver
        still reads, copies and hands it on.  A beat goes out at the
        cadence only while the collective's bytes still arrive (the data
        plane's receive count moved since the last beat), so that a rank
        wedged in a receive stays silent and is evicted as before.  Idle,
        the background loop beats itself.  A sub-coordinator's beat relays
        none of its children's."""
        if not self._op_busy or self._fenced is not None:
            return
        mark = su.rx_chunks
        if mark == self._hb_mark or \
                time.monotonic() - self._last_send < self.heartbeat_interval:
            return
        self._hb_mark = mark
        if self._send_heartbeat():
            self._last_send = time.monotonic()

    def _worker_cycle(self, msgs: List[Request]) -> bool:
        if self._fenced is not None:
            # The coordinator fenced this rank (TAG_FENCE): deliver the
            # typed error and stop before another frame of ours goes out.
            stale, current = self._fenced
            exc = FencedError("control", stale, current)
            self._abort(str(exc), exc=exc)
            return False
        if self._tracer is not None:
            self._maybe_clock_ping()
        requests, hit_events = self._classify(msgs)
        want_shutdown = self._shutdown_requested.is_set()
        send_failed = False
        # A sub-coordinator folds what its children sent since the last
        # cycle, and its own frame, into one TAG_TREE_UP.
        tree_entries: List[tuple] = []
        if self._tree_child_socks:
            with self._tree_up_lock:
                tree_entries = self._tree_up_buf
                self._tree_up_buf = []
        if requests or hit_events or want_shutdown:
            payload = wire.encode_request_list(requests,
                                               shutdown=want_shutdown,
                                               cache_hits=hit_events,
                                               epoch=self.epoch)
            if self._tree_child_socks:
                tree_entries.append(
                    (self.rank, su.TAG_REQUEST_LIST, payload))
            else:
                up = self._uplink()
                try:
                    _fi.fire("ctrl.worker.send", str(self.rank))
                    with self._ctrl_send_lock:
                        su.send_frame(up or self._ctrl_sock,
                                      su.TAG_REQUEST_LIST, payload)
                    if up is not None:
                        self._tree_unacked.append(payload)
                        del self._tree_unacked[:-8]
                    self._last_send = time.monotonic()
                except (ConnectionError, OSError):
                    if up is not None:
                        # A dead sub-coordinator, not a dead hub: adopt
                        # this rank to the star, which resends this frame.
                        self._tree_unacked.append(payload)
                        del self._tree_unacked[:-8]
                        self._reparent_to_root()
                    else:
                        # The coordinator may have closed right after its
                        # shutdown frame; the receiver may hold it already.
                        send_failed = True
        elif self.heartbeat_timeout > 0 and \
                time.monotonic() - self._last_send >= self.heartbeat_interval:
            # Idle past the cadence: prove liveness.  A lost coordinator
            # shows in the receive thread, not here.
            if self._tree_child_socks:
                tree_entries.append((self.rank, su.TAG_HEARTBEAT, b""))
            elif not self._send_heartbeat() and self._uplink() is not None:
                self._reparent_to_root()
            self._last_send = time.monotonic()
        if tree_entries:
            up_payload = wire.encode_tree_up(tree_entries, epoch=self.epoch)
            try:
                _fi.fire("ctrl.subcoord.send", str(self.rank))
                with self._ctrl_send_lock:
                    su.send_frame(self._ctrl_sock, su.TAG_TREE_UP,
                                  up_payload)
                self._last_send = time.monotonic()
            except (ConnectionError, OSError):
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
            if want_shutdown:
                # This rank is stopping itself: a hub that closed first is
                # the end of a clean teardown, not a lost coordinator (an
                # abort would dump the recorder and read as a dead hub).
                self._shutdown_flag.set()
                return False
            self._abort("lost connection to coordinator")
            return False
        return True

    def _apply_params(self, params) -> None:
        """The autotuner's knob broadcast (a port or a JAX coordinator's),
        applied before the frame's cached hits are fused.  A 5-tuple
        keeps the local ring segment."""
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
            if self._straggler is not None:
                self._straggler.note_ready(
                    _MessageTable.key_of(req), req.request_rank)
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
                # A zombie of another incarnation: its requests must not
                # touch the message table.  Tell it why (TAG_FENCE), so
                # that it raises FencedError and exits.
                self.log.warning(
                    "rejecting request frame from rank %d at epoch %d "
                    "(ours: %d)", peer, peer_epoch, self.epoch)
                _tmx.inc_counter("hvd_fenced_writes_total")
                blackbox_mod.note("epoch.fence", time.monotonic_ns(),
                                  rank=peer, stale_epoch=peer_epoch,
                                  epoch=self.epoch)
                fsock = self._ctrl_socks.get(peer)
                if fsock is not None:
                    try:
                        with self._ctrl_send_lock:
                            su.send_frame(
                                fsock, su.TAG_FENCE,
                                wire.encode_fence(peer_epoch, self.epoch))
                    except (ConnectionError, OSError):
                        pass
                continue
            shutdown = shutdown or peer_shutdown
            for req in reqs:
                _absorb(req)
            for name, pos in peer_hits:
                _absorb_hit(name, pos, peer)

        # A worker's hop deadline fired while this rank runs its cycles:
        # rule on the abort now.
        if self.collective_timeout > 0 or self._abort_inbox:
            self._drain_abort_reports()

        # Liveness: evict the ranks silent past the timeout or whose link
        # dropped, as joined ranks, so that the survivors complete what is
        # in flight.
        dead = self._check_dead_ranks()
        if dead and not shutdown:
            self._evict_ranks(dead, ready)

        responses: List[Response] = []
        hit_positions: List[int] = []
        for key in ready:
            t_first = self._msg_table.first_seen.get(key) \
                if self._metrics_on else None
            reqs = self._msg_table.pop(key)
            name = reqs[0].tensor_name  # the key may be set-scoped
            if self.timeline.enabled:
                self.timeline.negotiate_end(name)
            if t_first is not None:
                _tmx.observe("hvd_negotiation_seconds",
                             time.monotonic() - t_first)
            if self._straggler is not None:
                lagger = self._straggler.note_complete(key)
                if lagger is not None:
                    self._emit_straggler(name, *lagger)
            hit_ranks = self._hit_ranks.pop(key, set())
            contributors = {r.request_rank for r in reqs}
            ent_pos = -1
            # An eviction's cycle ships whole responses: a worker runs the
            # cached hits before the response list, so a hit would run
            # over the old group before the EVICT.
            if not dead and hit_ranks >= contributors:
                # Every contributor hit, so every request came from the
                # same cache entry: the response is the cached one.
                ent_pos = self._cache.position_of(name)
            if ent_pos >= 0:
                hit_positions.append(ent_pos)
            else:
                responses.append(self._construct_response(name, reqs))

        if dead and not shutdown:
            # First in the list: every rank applies the eviction before
            # it runs a collective the eviction made ready.
            responses.insert(0, Response(
                response_type=ResponseType.EVICT,
                tensor_sizes=sorted(dead)))

        if len(self._joined_ranks) == self.size:
            responses.append(Response(
                response_type=ResponseType.JOIN,
                tensor_sizes=[self._last_joined_rank]))
            # Evicted ranks never un-join.
            self._joined_ranks = set(self._evicted_ranks)

        if not self.stall_check_disable:
            shutdown = self._check_stalls() or shutdown

        tuned = self._pending_params
        if responses or hit_positions or resend_by_rank or shutdown \
                or tuned is not None:
            fused = self._fuse_responses(responses)
            if self._metrics_on:
                for resp in fused:
                    if resp.tensor_names and resp.tensor_type is not None:
                        _tmx.observe(
                            "hvd_fused_bytes",
                            sum(resp.tensor_sizes)
                            * resp.tensor_type.itemsize)
                        _tmx.observe("hvd_fused_tensors",
                                     len(resp.tensor_names))
            params = None
            if tuned is not None:
                params = (tuned.fusion_threshold, tuned.cycle_time_s,
                          tuned.cache_enabled,
                          tuned.hierarchical_allreduce,
                          tuned.hierarchical_allgather,
                          tuned.ring_segment_bytes)
                self._pending_params = None
            shared = None
            for r, s in self._ctrl_socks.items():
                resend = resend_by_rank.get(r, [])
                if resend:
                    payload = wire.encode_response_list(
                        fused, shutdown=shutdown,
                        hit_positions=hit_positions, resend_names=resend,
                        params=params, epoch=self.epoch)
                else:
                    if shared is None:
                        shared = wire.encode_response_list(
                            fused, shutdown=shutdown,
                            hit_positions=hit_positions, params=params,
                            epoch=self.epoch)
                    payload = shared
                try:
                    _fi.fire("ctrl.coord.send", str(r))
                    with self._ctrl_send_lock:
                        su.send_frame(s, su.TAG_RESPONSE_LIST, payload)
                except (ConnectionError, OSError):
                    pass
            if params is not None:
                # The workers' order: the knobs before this frame's hits.
                self._apply_params(params)
            self._execute_cached_hits(hit_positions)
            for resp in fused:
                self._perform_operation(resp)
            if self._pm is not None and not self._pm.done:
                # The tuner's score: this cycle's allreduced bytes, the
                # cached hits' included.
                nbytes = sum(
                    sum(r.tensor_sizes) * r.tensor_type.itemsize
                    for r in fused
                    if r.response_type == ResponseType.ALLREDUCE)
                nbytes += sum(
                    c.tensor_sizes[0] * c.tensor_type.itemsize
                    for c in map(self._cache.get_by_position, hit_positions)
                    if c is not None)
                new = self._pm.record_bytes(nbytes)
                if new is not None:
                    self._pending_params = new
            if shutdown:
                self._shutdown_flag.set()
                return False
        return True

    def free_groups_on_failure(self,
                               abort: Callable[[str], object]) -> None:
        """For an elastic rank, whose gang re-forms without a dead peer:
        evict a rank whose control link dropped even with liveness off (a
        peer that died before it joined a negotiation would hold it for
        good), take a hop that failed on a dropped link to the gang's
        agreement under a collective deadline (``_perform_operation``),
        and call ``abort(reason)`` on every eviction, agreed abort and
        abort of this engine (an NCCL group's abort; a no-op
        elsewhere)."""
        self._abort_groups = abort
        self._evict_on_lost_link = True

    def _check_dead_ranks(self) -> List[int]:
        """Ranks whose control link dropped or that have been silent past
        the heartbeat timeout.  With liveness off, only ranks whose link
        dropped, and only after ``free_groups_on_failure``; else none."""
        liveness = self.heartbeat_timeout > 0
        if not liveness and not self._evict_on_lost_link:
            return []
        now = time.monotonic()
        dead = []
        for r, t in self._last_seen.items():
            if r in self._evicted_ranks:
                continue
            if r in self._conn_lost or (
                    liveness and now - t > self.heartbeat_timeout):
                dead.append(r)
        # A dying sub-coordinator takes its children's uplink with it: a
        # child still routed through a parent that is dead this round gets
        # a whole timeout to re-parent, and only the parent is evicted.
        if dead and self._rank_route:
            dead_set = set(dead)
            for child, parent in list(self._rank_route.items()):
                if parent in dead_set and child in dead_set:
                    dead.remove(child)
                    self._last_seen[child] = now
                    self._conn_lost.discard(child)
        return dead

    def _evict_ranks(self, dead: List[int], ready: List[str]) -> None:
        """Make ``dead`` joined for good: drop their queued requests and
        rescan readiness, so that the survivors complete the in-flight
        negotiation with the dead ranks counted out."""
        for r in dead:
            self.log.error(
                "rank %d unresponsive (%s); evicting from the job", r,
                "connection lost" if r in self._conn_lost
                else f"no heartbeat for {self.heartbeat_timeout:.1f}s")
            if r not in self._conn_lost:
                _tmx.inc_counter("hvd_heartbeat_misses_total")
            _tmx.inc_counter("hvd_evictions_total")
            blackbox_mod.note("heartbeat.miss", time.monotonic_ns(),
                              rank=r, conn_lost=bool(r in self._conn_lost))
            self._evicted_ranks.add(r)
            self._joined_ranks.add(r)
        self._prune_evicted(ready)

    def _prune_evicted(self, ready: Optional[List[str]] = None) -> None:
        """Drop the evicted ranks' requests from the message table; a name
        only they had announced goes, and one that every survivor has
        announced becomes ready (with ``ready``)."""
        for nm, lst in list(self._msg_table.entries.items()):
            lst[:] = [q for q in lst
                      if q.request_rank not in self._evicted_ranks]
            if not lst:
                self._msg_table.pop(nm)
                self._hit_ranks.pop(nm, None)
                if self._straggler is not None:
                    self._straggler.forget(nm)
                if ready is not None and nm in ready:
                    ready.remove(nm)
            elif ready is not None and lst[0].process_set_id == 0 and \
                    len(lst) == self.size - len(self._joined_ranks) and \
                    nm not in ready:
                ready.append(nm)

    def _emit_straggler(self, name: str, lag_rank: int,
                        skew_s: float) -> None:
        """The straggler detector tripped: one rank was last to negotiate
        for several tensors in a row by more than
        ``HVD_STRAGGLER_WARN_MS``.  The detector re-arms, so the records
        are throttled."""
        self.log.warning(
            "straggler: rank %d consistently last to negotiate "
            "(skew %.1f ms on %s)", lag_rank, skew_s * 1e3, name)
        if self.timeline.enabled:
            self.timeline.instant(
                timeline_mod.STRAGGLER, rank=lag_rank,
                skew_ms=round(skew_s * 1e3, 3), tensor=name)
        blackbox_mod.note("straggler", 0, rank=lag_rank,
                          skew_ms=round(skew_s * 1e3, 3), name=name)

    # -- the collective-abort agreement -------------------------------------
    #
    # Heartbeats catch dead ranks; these frames catch hung ones.  A rank
    # whose hop blows HVD_COLLECTIVE_TIMEOUT reports the peer it was
    # blocked on (TAG_ABORT_REPORT); the coordinator probes the gang
    # (TAG_PROBE / TAG_PROBE_ACK, answered from the receive threads, which
    # stay responsive while a background thread is wedged), rules which
    # ranks are stuck, and broadcasts TAG_ABORT_VERDICT, so that every
    # survivor raises the same CollectiveTimeoutError for the same step.

    def _drain_abort_reports(self) -> None:
        """The coordinator, between cycles (not blocked in a collective
        itself): act on the hop-timeout reports that came meanwhile."""
        with self._abort_lock:
            if not self._abort_inbox:
                return
            inbox, self._abort_inbox = self._abort_inbox, []
        reports: Dict[int, int] = {}
        name = ""
        for peer, tag, payload in inbox:
            if tag != su.TAG_ABORT_REPORT:
                continue  # a stray ack of a finished probe round
            nm, suspect, epoch = wire.decode_abort_report(payload)
            if epoch != self.epoch:
                continue
            if self._last_verdict is not None and \
                    _same_abort(self._last_verdict[0], nm):
                # Ruled already: this rank's deadline fired after the
                # broadcast.
                self._send_verdict_to(peer)
                continue
            reports[peer] = suspect
            # Reports of several failed groups merge into one name.
            name = _merge_group_abort(name, nm) if _is_group_abort(name) \
                and _is_group_abort(nm) else nm
        if reports:
            self._coordinate_abort(name, reports)

    def _send_verdict_to(self, rank: int) -> None:
        vname, vranks = self._last_verdict
        sock = self._ctrl_socks.get(rank)
        if sock is None:
            return
        try:
            with self._ctrl_send_lock:
                su.send_frame(
                    sock, su.TAG_ABORT_VERDICT,
                    wire.encode_abort_verdict(vname, vranks, self.epoch))
        except (ConnectionError, OSError):
            pass

    def _send_probes(self, live: List[int]) -> None:
        for r in live:
            # A rank under a live sub-coordinator gets its probe routed
            # down the tree; its ack comes back on its direct link.
            parent = self._rank_route.get(r)
            if parent is not None and parent in self._ctrl_socks \
                    and parent not in self._evicted_ranks \
                    and parent not in self._conn_lost:
                down = wire.encode_tree_down(r, su.TAG_PROBE, b"")
                try:
                    with self._ctrl_send_lock:
                        su.send_frame(self._ctrl_socks[parent],
                                      su.TAG_TREE_DOWN, down)
                    continue
                except (ConnectionError, OSError):
                    pass
            try:
                with self._ctrl_send_lock:
                    su.send_frame(self._ctrl_socks[r], su.TAG_PROBE, b"")
            except (ConnectionError, OSError):
                pass

    def _coordinate_abort(self, name: str,
                          reports: Dict[int, int]) -> List[int]:
        """Probe the gang, rule which ranks are wedged, broadcast and apply
        the verdict; returns the wedged ranks.  On the coordinator's
        background thread, from :meth:`_drain_abort_reports` or from its
        own hop timeout.  ``reports``: reporter -> the peer it blamed."""
        t0 = time.monotonic()
        group = _is_group_abort(name)
        if group:
            self.log.error(
                "a process-group collective failed (reported by rank(s) "
                "%s); probing the gang", sorted(reports))
        else:
            self.log.error(
                "collective %r blew its %gs deadline (reported by rank(s) "
                "%s); probing the gang", name, self.collective_timeout,
                sorted(reports))
        live = [r for r in self._ctrl_socks if r not in self._evicted_ranks]
        acks: Dict[int, tuple] = {}
        self._send_probes(live)
        deadline = t0 + max(0.1, self.collective_probe_timeout)
        last_probe = t0
        while time.monotonic() < deadline:
            if group and (self._group_known_failed() or all(
                    r in reports for r in self._group_scope(name, live))):
                break
            with self._abort_lock:
                inbox, self._abort_inbox = self._abort_inbox, []
            for peer, tag, payload in inbox:
                if tag == su.TAG_PROBE_ACK:
                    busy, busy_s, ep = wire.decode_probe_ack(payload)
                    if ep == self.epoch:
                        acks[peer] = (busy, busy_s)
                elif tag == su.TAG_ABORT_REPORT:
                    nm, suspect, ep = wire.decode_abort_report(payload)
                    if ep == self.epoch:
                        reports[peer] = suspect
                        if group and _is_group_abort(nm):
                            name = _merge_group_abort(name, nm)
            # Every live worker has reported a timeout of its own (a
            # victim of the hang, not its cause), acked idle or dropped
            # its link (dead, never to ack): nothing more to learn from
            # the window.  (After a group collective an idle engine
            # proves nothing: the window runs out.)
            if not group and all(r in reports
                                 or (r in acks and not acks[r][0])
                                 or r in self._conn_lost
                                 for r in live):
                break
            now = time.monotonic()
            if now - last_probe >= 0.25:
                self._send_probes(live)  # refresh the busy durations
                last_probe = now
            time.sleep(0.02)

        # A live rank is wedged when it reported no timeout of its own and
        # its last word was "busy", or silence: every healthy rank's own
        # deadline fires within about one timeout of the first.
        wedged = sorted(r for r in live
                        if r not in reports and (r not in acks
                                                 or acks[r][0]))
        if group:
            # A process-group collective failed: the ranks this engine
            # knows dead, else every live member of the failed groups
            # that did not report a failure of its own within the window
            # (its peers were blocked on it; its engine, idle, acks as
            # healthy).  A rank outside those groups is not blamed: it
            # may be waiting on the engine, not on them.
            wedged = self._group_known_failed() or sorted(
                r for r in self._group_scope(name, live)
                if r not in reports)
        elif not wedged:
            # Nobody provably stuck (the hang healed, or the victim died
            # with its socket): the most-blamed suspect, non-reporters
            # first, ties to the lowest rank.
            blame: Dict[int, int] = {}
            for suspect in reports.values():
                if suspect >= 0 and suspect not in reports:
                    blame[suspect] = blame.get(suspect, 0) + 1
            if not blame:
                for suspect in reports.values():
                    if suspect >= 0:
                        blame[suspect] = blame.get(suspect, 0) + 1
            if blame:
                top = max(blame.values())
                wedged = [min(r for r, n in blame.items() if n == top)]

        if group and wedged:
            self._collective_err = CollectiveTimeoutError(
                wedged, name, self.collective_timeout)
        payload = wire.encode_abort_verdict(name, wedged, self.epoch)
        self._last_verdict = (name, wedged)
        for r in live:
            try:
                with self._ctrl_send_lock:
                    su.send_frame(self._ctrl_socks[r],
                                  su.TAG_ABORT_VERDICT, payload)
            except (ConnectionError, OSError):
                pass
        self._apply_abort_verdict(name, wedged, t0)
        # Archive the evidence: pull every live rank's recorder ring, the
        # wedged ones' too (their receive threads still answer), so that
        # one dump directory survives a rank whose own write never lands.
        self._pull_blackbox_dumps(live)
        return wedged

    def _pull_blackbox_dumps(self, ranks: List[int],
                             wait_s: float = 1.0) -> None:
        """The coordinator: ask ``ranks`` for their recorder rings
        (``TAG_BLACKBOX``) and write what arrives within ``wait_s`` as
        ``blackbox_rank<r>.pulled.json`` in our ``HVD_BLACKBOX_DIR``.
        Best effort; never raises."""
        bb = blackbox_mod.get()
        if bb is None or not ranks:
            return
        req = wire.encode_blackbox_request(self.epoch)
        asked = []
        for r in ranks:
            sock = self._ctrl_socks.get(r)
            if sock is None:
                continue
            try:
                with self._ctrl_send_lock:
                    su.send_frame(sock, su.TAG_BLACKBOX, req)
                asked.append(r)
            except (ConnectionError, OSError):
                pass
        got: set = set()
        deadline = time.monotonic() + wait_s
        while len(got) < len(asked) and time.monotonic() < deadline:
            with self._blackbox_lock:
                inbox, self._blackbox_inbox = self._blackbox_inbox, []
            for peer, payload in inbox:
                try:
                    drank, _depoch, blob = wire.decode_blackbox_dump(payload)
                    os.makedirs(bb.dir, exist_ok=True)
                    path = os.path.join(
                        bb.dir, f"blackbox_rank{drank}.pulled.json")
                    tmp = f"{path}.tmp.{os.getpid()}"
                    with open(tmp, "wb") as fh:
                        fh.write(blob)
                    os.replace(tmp, path)
                except Exception:
                    pass
                got.add(peer)
            if len(got) < len(asked):
                time.sleep(0.02)
        if asked:
            self.log.info(
                "flight-recorder archive: pulled %d/%d worker dumps into %s",
                len(got), len(asked), bb.dir)

    def _report_and_await_verdict(self, name: str,
                                  suspect: int) -> Optional[List[int]]:
        """A worker's half of the agreement: report the hop timeout, then
        wait (on the background thread: the collective is dead anyway) for
        the verdict.  None: no verdict in time, the coordinator is wedged
        or lost."""
        with self._abort_cv:
            if self._abort_verdict is not None:
                # The broadcast came while this rank was still blocked.
                ranks = self._abort_verdict[1]
                self._abort_verdict = None
                return ranks
        try:
            with self._ctrl_send_lock:
                su.send_frame(
                    self._ctrl_sock, su.TAG_ABORT_REPORT,
                    wire.encode_abort_report(name, suspect, self.epoch))
        except (ConnectionError, OSError):
            return None
        # The worst case: the coordinator starts probing only after its own
        # hop deadline (one timeout), then runs a whole probe window.
        deadline = time.monotonic() + max(
            2.0 * self.collective_timeout,
            self.collective_timeout + 2.0 * self.collective_probe_timeout)
        with self._abort_cv:
            while self._abort_verdict is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._ctrl_conn_lost:
                    return None
                self._abort_cv.wait(remaining)
            ranks = self._abort_verdict[1]
            self._abort_verdict = None
        return ranks

    @staticmethod
    def _group_scope(name: str, live: List[int]) -> List[int]:
        """The live ranks a group abort's verdict may name: the failed
        groups' members (every live rank when a report named none)."""
        members = _group_abort_members(name)
        return live if members is None else [r for r in live
                                             if r in members]

    def _group_known_failed(self) -> List[int]:
        """The coordinator: the ranks it already knows dead this
        incarnation (evicted, failed, or whose control link dropped)."""
        return sorted(set(self._ranks_failed) | self._evicted_ranks
                      | self._conn_lost)

    def group_abort(self, ranks: Optional[Sequence[int]] = None
                    ) -> Optional[List[int]]:
        """The gang's verdict on a failed ``torch.distributed``
        collective, for ``@hvd.elastic.run``: a process group's error says
        that a peer is gone or stalled, not which, and only the engine's
        agreement may name it.  Every rank whose group collective failed
        calls this with the failed group's ranks (None: the whole gang);
        it runs the hop deadline's agreement (``TAG_ABORT_REPORT``,
        probes, ``TAG_ABORT_VERDICT``) under :data:`GROUP_ABORT`, the
        report naming the group, where the coordinator rules wedged the
        ranks it knows dead, else every live member of the reported groups
        that reported no failure of its own within the probe window.
        Returns the wedged ranks (empty: none proven, and the caller
        re-raises), or None when the coordinator is lost (the engine
        aborts with that reason).  After a verdict every later collective
        of the incarnation fails with the same
        :class:`CollectiveTimeoutError`."""
        name = _group_abort_name(ranks)
        t0 = time.monotonic()
        if self.rank == 0:
            with self._abort_lock:
                self._abort_inbox.append((0, su.TAG_ABORT_REPORT,
                                          wire.encode_abort_report(
                                              name, -1, self.epoch)))
            # The probe window, and the background thread's way to it
            # (it drains reports between cycles).
            deadline = t0 + max(0.1, self.collective_probe_timeout) + 10.0
            while not (self._last_verdict is not None
                       and _same_abort(self._last_verdict[0], name)):
                if self._aborted or time.monotonic() > deadline:
                    return None
                time.sleep(0.02)
            wedged = list(self._last_verdict[1])
        else:
            if self._ctrl_conn_lost:
                self._abort("lost connection to coordinator")
                return None
            wedged = self._report_and_await_verdict(name, -1)
            if wedged is None:
                self._abort("a process-group collective failed and no "
                            "abort verdict arrived: coordinator wedged or "
                            "lost")
                return None
            if self.rank in wedged:
                raise RuntimeError(
                    "evicted by the coordinator (process-group collective "
                    "failure)")
            if wedged:
                self._apply_group_verdict(name, wedged, t0)
        return wedged

    def _apply_group_verdict(self, name: str, ranks: List[int],
                             t0: float) -> None:
        """A worker applies a group abort's verdict once, whether it
        reported the failure or only heard the broadcast: the eviction
        (``_ranks_failed``), so that a collective it has pending fails
        with ``RanksFailedError`` when a reporter stops the gang to
        re-form, and the typed error for every later collective."""
        with self._abort_cv:
            if self._collective_err is not None:
                return
            self._collective_err = CollectiveTimeoutError(
                ranks, name, self.collective_timeout)
        self._apply_abort_verdict(name, ranks, t0)

    def _apply_abort_verdict(self, name: str, ranks: List[int],
                             t0: float) -> None:
        """Record and apply an agreed abort: the timeline's record, and
        the eviction, so that the next submission raises on every
        survivor."""
        elapsed = time.monotonic() - t0
        _tmx.inc_counter("hvd_collective_timeouts_total")
        _tmx.observe("hvd_collective_abort_seconds", elapsed)
        if self.timeline.enabled:
            self.timeline.instant(
                timeline_mod.COLLECTIVE_ABORT, ranks=list(ranks),
                tensor=name, abort_ms=round(elapsed * 1e3, 3))
        self.log.error(
            "gang verdict: rank(s) %s wedged during %r; aborting the "
            "collective (%.0f ms after the local timeout)", ranks, name,
            elapsed * 1e3)
        # A terminal event: note the verdict and dump the recorder (a
        # failure path, where a clock read is free).
        blackbox_mod.note("abort.verdict", time.monotonic_ns(),
                          ranks=list(ranks), name=name,
                          abort_ms=round(elapsed * 1e3, 3))
        blackbox_mod.dump("collective_timeout",
                          f"wedged={list(ranks)} name={name}")
        self._evicted_ranks.update(ranks)
        self._ranks_failed = sorted(set(self._ranks_failed) | set(ranks))
        if self.rank == 0:
            # A heartbeat eviction's pruning, so that the cycles after the
            # abort cannot wait on the wedged ranks.
            self._joined_ranks.update(ranks)
            self._prune_evicted()
        self._notify_ranks_failed(
            f"gang verdict: rank(s) {list(ranks)} wedged during {name!r}")

    def _notify_ranks_failed(self, reason: str) -> None:
        """Abort the process groups, after ``free_groups_on_failure``,
        since peers are gone; its failure is logged, never raised into
        the engine's thread."""
        abort = self._abort_groups
        if abort is None:
            return
        try:
            abort(reason)
        except Exception:
            self.log.exception("aborting the process groups (%r) failed",
                               reason)

    def _retain_for_replay(self, resp: Response,
                           entries: List[TensorTableEntry]) -> None:
        """Keep copies of an aborted allreduce's original inputs, beside
        those of the collectives failed after it."""
        if resp.response_type != ResponseType.ALLREDUCE:
            return
        batch = [
            {"name": e.name, "array": np.array(e.array, copy=True),
             "op": resp.reduce_op, "prescale": resp.prescale_factor,
             "postscale": resp.postscale_factor}
            for e in entries if e.handle >= 0]
        if batch:
            self._retained += batch
            retain_aborted_batch(list(self._retained))

    def _collective_abort(self, resp: Response,
                          entries: List[TensorTableEntry],
                          hop: Exception) -> Status:
        """A hop deadline fired here, or (an elastic rank) a hop's link
        dropped: run the gang-wide agreement and build the typed status
        every survivor shares."""
        name = resp.tensor_names[0]
        suspect = int(getattr(hop, "peer", -1))
        # The blame edge: whom this rank was blocked on when its deadline
        # fired, from which the postmortem finds the first cause.
        blackbox_mod.note("collective.timeout", time.monotonic_ns(),
                          name=name, peer=suspect,
                          phase=str(getattr(hop, "phase", "recv")))
        if self.rank == 0:
            wedged = self._coordinate_abort(name, {0: suspect})
        else:
            t0 = time.monotonic()
            wedged = self._report_and_await_verdict(name, suspect)
            if wedged is None:
                reason = ("lost connection to coordinator"
                          if self._ctrl_conn_lost else
                          "collective timed out and no abort verdict "
                          "arrived: coordinator wedged or lost")
                self._abort(reason)
                return Status.aborted(reason)
            if self.rank in wedged:
                # Ruled wedged ourselves: the gang moved on without us.
                raise RuntimeError(
                    "evicted by the coordinator (collective timeout)")
            self._apply_abort_verdict(name, wedged, t0)
        self._retain_for_replay(resp, entries)
        err = CollectiveTimeoutError(wedged, name, self.collective_timeout)
        self._collective_err = err
        return Status(StatusType.ABORTED, str(err), err)

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
                _tmx.inc_counter("hvd_stall_warnings_total")
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
            ranks = [int(x) for x in resp.tensor_sizes]
            blackbox_mod.note("evict", time.monotonic_ns(), ranks=ranks)
            if self.rank in ranks:
                # Declared dead (a long pause): the gang has moved on
                # without this rank; stop before desyncing it.
                blackbox_mod.dump("evicted",
                                  "declared dead by the coordinator")
                raise RuntimeError(
                    "evicted by the coordinator (missed heartbeats)")
            self._evicted_ranks.update(ranks)
            self._ranks_failed = sorted(set(self._ranks_failed) | set(ranks))
            self.log.error(
                "rank(s) %s evicted; completing in-flight collectives on "
                "the survivors", ranks)
            blackbox_mod.dump("ranks_failed", f"evicted={ranks}")
            self._notify_ranks_failed(f"rank(s) {ranks} evicted")
            return

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
        tracer = self._tracer
        if tracer is not None:
            # One seq per executed response: responses run in the same
            # order on every rank, so the seqs agree with no wire traffic.
            seq = tracer.begin_collective()
            t_exec0 = time.monotonic_ns()
            first_enq = min((e.enqueue_ns for e in entries
                             if e.handle >= 0), default=0)
            if first_enq:
                # The first local enqueue to the execution.
                tracer.span("negotiate", first_enq, t_exec0, seq=seq,
                            name=resp.tensor_names[0], op=op_name,
                            tensors=len(entries))
        deadline_on = self.collective_timeout > 0
        if deadline_on:
            # The busy marker a probe ack reads while this thread is
            # blocked in the ring.
            self._in_collective_since = time.monotonic()
        self._hb_mark = su.rx_chunks
        self._op_busy = True
        bb = self._blackbox
        if bb is not None:
            # The recorder's begin record, stamped with a clock an enabled
            # layer already read (the trace's or the deadline's), else 0.
            self._blackbox_seq += 1
            bb_t0 = (t_exec0 if tracer is not None
                     else int(self._in_collective_since * 1e9)
                     if deadline_on else 0)
            peer = (self.rank - 1) % self.size
            tp = getattr(self._transports.get(peer), "kind", "")
            bb.collective_begin(
                bb_t0, self._blackbox_seq, resp.tensor_names[0], op_name,
                sum(e.array.nbytes for e in entries), peer, tp)
        try:
            if self._collective_err is not None:
                raise self._collective_err
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
        except CollectiveTimeoutError as e:
            # An earlier collective of this incarnation was aborted: its
            # frames may still sit on the links, so nothing runs on them
            # again.  Every survivor runs the same responses in the same
            # order, so all fail the same ones with the same error, and an
            # allreduce's inputs join the retained batch.
            results = [None] * len(entries)
            status = Status(StatusType.ABORTED, str(e), e)
            self._retain_for_replay(resp, entries)
        except (cpu_backend.HopTimeout, wire.WireCorruptionError) as e:
            # A hop past its deadline, or a link the ladder gave up on:
            # with deadlines on, the gang-wide agreement; without, the
            # collective's error on this rank (the send-wait cap tripped,
            # or the corruption).
            results = [None] * len(entries)
            corrupt = isinstance(e, wire.WireCorruptionError)
            if corrupt:
                blackbox_mod.note("wire.corruption", time.monotonic_ns(),
                                  peer=int(getattr(e, "peer", -1)),
                                  cause=str(getattr(e, "cause", "")))
            if deadline_on:
                self._in_collective_since = 0.0
                status = self._collective_abort(resp, entries, e)
            else:
                self.log.error("collective %s failed: %r", op_name, e)
                status = Status.unknown_error(str(e))
                if corrupt:
                    blackbox_mod.dump("wire_corruption", str(e))
        except ConnectionError as e:
            # A link that dropped mid-hop: its peer died.  On an elastic
            # rank under a deadline, the gang's agreement names it, as at
            # a hop's deadline; elsewhere, the collective's error here.
            results = [None] * len(entries)
            if deadline_on and self._evict_on_lost_link and \
                    not self._shutdown_flag.is_set():
                self.log.error("collective %s: a link dropped mid-hop "
                               "(%r); asking the gang", op_name, e)
                self._in_collective_since = 0.0
                status = self._collective_abort(resp, entries, e)
            else:
                self.log.error("collective %s failed: %r", op_name, e)
                status = Status.unknown_error(str(e))
        except Exception as e:
            self.log.error("collective %s failed: %r", op_name, e)
            results = [None] * len(entries)
            status = Status.unknown_error(str(e))
        self._op_busy = False
        if deadline_on:
            self._in_collective_since = 0.0
        if self.rank == 0 and self.heartbeat_timeout > 0 and status.ok_():
            # The collective's whole group was alive through it, though
            # no frame of theirs could flow while they ran it.
            now = time.monotonic()
            for r in cpu_backend.resp_group(self, resp)[0]:
                if r in self._last_seen:
                    self._last_seen[r] = now
        if bb is not None:
            # The end record closes the in-flight marker; untimed when the
            # collective succeeded.
            bb.collective_end(0 if status.ok_() else time.monotonic_ns(),
                              self._blackbox_seq, status.ok_())
        self.timeline.end(resp.tensor_names[0])
        if tracer is not None:
            t_cb0 = time.monotonic_ns()
        for e, res in zip(entries, results):
            self._release_name(e.name)
            if e.handle >= 0:
                self.handles.mark_done(e.handle, status, res)
        if tracer is not None:
            t_end = time.monotonic_ns()
            tracer.span("callback", t_cb0, t_end, seq=seq,
                        tensors=len(entries))
            # The envelope of pack, hops, unpack and callback.
            tracer.span("collective", t_exec0, t_end, seq=seq,
                        name=resp.tensor_names[0], op=op_name,
                        ok=status.ok_())

    def cache_stats(self) -> Dict[str, int]:
        return self._cache.stats()

    def _abort(self, reason: str,
               exc: Optional[BaseException] = None) -> None:
        self._aborted = True
        # Read by the elastic wrapper: a worker's lost-coordinator abort is
        # a failure of rank 0, which re-forms the gang.
        self._abort_reason = reason
        # A typed abort keeps its class up to the training loop: the
        # pending handles and the next submission raise this object.
        self._abort_exc = exc
        blackbox_mod.dump("engine_abort", reason)
        self._shutdown_flag.set()
        self._wake_serve()
        self._notify_ranks_failed(f"engine aborted: {reason}")
