"""Chrome-tracing timeline: the port of ``horovod_tpu/utils/timeline.py``
(Horovod's ``HOROVOD_TIMELINE``).

Rank 0 writes a ``chrome://tracing`` JSON stream of per-tensor phases:
``NEGOTIATE_<OP>`` with a ``RANK_<r>_READY`` tick per rank, the top-level
op, and instants on the process lane (the recovery ladder's
``HOP_RETRY``/``TRANSPORT_FAILOVER``, the engine's ``COLLECTIVE_ABORT``
and ``SUBCOORD_REPARENT``, the telemetry's ``STRAGGLER`` and ``ALERT``, the
integrity modules'
``NONFINITE_SKIP``/``DIVERGENCE_DETECTED``/``CKPT_VERIFY_FAIL``, and
elastic's ``ELASTIC_EPOCH_<n>``, ``ELASTIC_RESET``, ``ELASTIC_REFORM``,
``ELASTIC_REPLAY``, ``LEADER_FAILOVER`` and ``PARTITION_MINORITY``).
Enabled by ``HVD_TIMELINE=<path>``; ``HVD_TIMELINE_MARK_CYCLES=1`` adds a
``CYCLE_START`` instant per background cycle.  The hot path only enqueues;
a writer thread formats and flushes, and a clean shutdown closes the array
with a ``{}]`` footer, so that the file is valid JSON.  The events are the
JAX package's, field for field.

Under elastic (``HVD_ELASTIC_EPOCH`` set) the timeline is persistent: it
is opened for appending, an engine's shutdown leaves it open, and the next
incarnation's engine in the same process re-attaches to it, so that one
file spans the incarnations on one time axis, and a rank promoted to rank
0 by a re-form appends to the file its predecessor wrote.  The process's
exit closes it (:func:`close_live`).
"""

from __future__ import annotations

import atexit
import json
import queue
import threading
import time
from typing import Optional

from horovod_tpu_torch.utils import env as env_util

# The activity names (Horovod's common.h).
NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
NEGOTIATE_ALLTOALL = "NEGOTIATE_ALLTOALL"
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
ALLTOALL = "ALLTOALL"
QUEUE = "QUEUE"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
CPU_RING_ALLREDUCE = "CPU_RING_ALLREDUCE"
CYCLE_START = "CYCLE_START"

# The integrity records (integrity/, utils/checkpoint.py).
NONFINITE_SKIP = "NONFINITE_SKIP"
DIVERGENCE_DETECTED = "DIVERGENCE_DETECTED"
CKPT_VERIFY_FAIL = "CKPT_VERIFY_FAIL"

# The recovery ladder's records (utils/ladder.py): a data frame was
# retransmitted on one link (args: the peer and the cause, corrupt, reset
# or failover), and a peer pair was demoted from shm to TCP in place.
# Both are instants on the rank that healed.
HOP_RETRY = "HOP_RETRY"
TRANSPORT_FAILOVER = "TRANSPORT_FAILOVER"

# The engine's self-healing records (runtime_py.py): the gang agreed to
# abort a collective that blew HVD_COLLECTIVE_TIMEOUT (args: the wedged
# ranks, the tensor, the agreement's milliseconds), and a child of a dead
# sub-coordinator re-attached to the root (args: the child and the dead
# parent).
COLLECTIVE_ABORT = "COLLECTIVE_ABORT"
SUBCOORD_REPARENT = "SUBCOORD_REPARENT"
# This side of a membership split holds no strict majority of the
# last-committed roster, so it stops instead of re-forming (elastic/).
PARTITION_MINORITY = "PARTITION_MINORITY"

# The telemetry records (telemetry/): one rank was consistently last to
# negotiate (args: the rank, its skew in ms, the tensor), and the gang
# fold's anomaly engine tripped a rule (args: the rule, the rank, the value
# and its baseline).
STRAGGLER = "STRAGGLER"
ALERT = "ALERT"

# Events are flushed when the queue runs dry, or every _FLUSH_EVERY events
# in a burst.
_FLUSH_EVERY = 64

# One monotonic base per process, captured at import, and the wall clock
# beside it (the CLOCK_ANCHOR instant), so that files from several hosts
# can be aligned.
MONO_ANCHOR_NS = time.monotonic_ns()
WALL_ANCHOR_NS = time.time_ns()

# Live persistent timelines by path, re-attached across elastic
# incarnations in one process.
_live: dict = {}
_live_lock = threading.Lock()


class Timeline:
    """A process's timeline; a no-op unless :meth:`initialize` is called
    with a file name (only rank 0 does)."""

    def __init__(self):
        self._q: Optional[queue.SimpleQueue] = None
        self._writer: Optional[threading.Thread] = None
        self._f = None
        self._start_ns = 0
        self._tensor_tids = {}
        self._mark_cycles = False
        self._persistent = False  # outlives its engine (elastic)

    @property
    def enabled(self) -> bool:
        return self._q is not None

    def initialize(self, filename: str, mark_cycles: bool = False,
                   persistent: bool = False) -> None:
        if self.enabled or not filename:
            return
        self._persistent = persistent
        # A persistent timeline appends: after a re-form the new rank 0 may
        # be a process that never wrote the file, and "w" would erase the
        # history before the re-form.
        self._f = open(filename, "a" if persistent else "w")
        self._f.write("[\n")
        self._start_ns = MONO_ANCHOR_NS
        self._mark_cycles = mark_cycles
        self._q = queue.SimpleQueue()
        self._writer = threading.Thread(
            target=self._drain, name="hvd-timeline", daemon=True)
        self._writer.start()
        self.instant("CLOCK_ANCHOR", mono_ns=MONO_ANCHOR_NS,
                     wall_ns=WALL_ANCHOR_NS)

    def shutdown(self) -> None:
        if not self.enabled or self._persistent:
            # An elastic engine's shutdown is not the end: the next
            # incarnation re-attaches (events are flushed as they drain).
            return
        self._close()

    def _close(self) -> None:
        self._q.put(None)
        self._writer.join(timeout=5)
        try:
            # Every event line ends with ",\n": a "{}" object closes the
            # array into valid JSON.
            self._f.write("{}]\n")
            self._f.close()
        except Exception:
            pass
        self._q = None

    # -- event emission (the hot path only enqueues) ---------------------

    def _ts_us(self) -> float:
        return (time.monotonic_ns() - self._start_ns) / 1e3

    def _tid(self, tensor_name: str) -> int:
        if tensor_name not in self._tensor_tids:
            tid = len(self._tensor_tids) + 1
            self._tensor_tids[tensor_name] = tid
            # Name the lane after the tensor (chrome-tracing metadata).
            self._q.put({"ph": "M", "pid": 0, "tid": tid,
                         "name": "thread_name",
                         "args": {"name": tensor_name}})
        return self._tensor_tids[tensor_name]

    def _emit(self, ph, name, tensor_name, args=None):
        if not self.enabled:
            return
        ev = {
            "ph": ph,
            "ts": self._ts_us(),
            "pid": 0,
            "tid": self._tid(tensor_name) if tensor_name else 0,
        }
        if name is not None:
            ev["name"] = name
        if args:
            ev["args"] = args
        self._q.put(ev)

    def negotiate_start(self, tensor_name: str, op_name: str) -> None:
        self._emit("B", f"NEGOTIATE_{op_name}", tensor_name)

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        self._emit("i", f"RANK_{rank}_READY", tensor_name)

    def negotiate_end(self, tensor_name: str) -> None:
        self._emit("E", None, tensor_name)

    def start(self, tensor_name: str, op_name: str) -> None:
        self._emit("B", op_name, tensor_name)

    def end(self, tensor_name: str) -> None:
        self._emit("E", None, tensor_name)

    def mark_cycle_start(self) -> None:
        if self._mark_cycles:
            self._emit("i", CYCLE_START, "")

    def instant(self, name: str, **args) -> None:
        """A named instant on the process lane (tid 0): a record tied to
        no tensor."""
        self._emit("i", name, "", args=args or None)

    # The JAX package's name for elastic's records; the same event.
    elastic_event = instant

    # -- writer thread ---------------------------------------------------

    def _drain(self) -> None:
        unflushed = 0
        while True:
            if unflushed:
                try:
                    ev = self._q.get_nowait()
                except queue.Empty:
                    self._f.flush()
                    unflushed = 0
                    ev = self._q.get()
            else:
                ev = self._q.get()
            if ev is None:
                if unflushed:
                    self._f.flush()
                break
            self._f.write(json.dumps(ev) + ",\n")
            unflushed += 1
            if unflushed >= _FLUSH_EVERY:
                self._f.flush()
                unflushed = 0


def engine_event(name: str, **args) -> None:
    """An instant on the running engine's timeline, if it has one: the
    helper of modules that record events but own no timeline (the guard,
    the audit, checkpoints, the ladder).  A no-op without an engine or
    with the timeline off."""
    from horovod_tpu_torch import basics

    eng = basics._engine_obj
    tl = getattr(eng, "timeline", None) if eng is not None else None
    if tl is not None and tl.enabled:
        tl.instant(name, **args)


def from_env(rank: int) -> Timeline:
    """The timeline ``HVD_TIMELINE`` asks for: written on rank 0 only;
    under elastic, the process's live one for that path."""
    path = env_util.get_str(env_util.TIMELINE, "")
    mark = env_util.get_str(env_util.TIMELINE_MARK_CYCLES, "0") in (
        "1", "true")
    if path and rank == 0 and env_util.get_str(env_util.ELASTIC_EPOCH, ""):
        with _live_lock:
            t = _live.get(path)
            if t is None or not t.enabled:
                t = Timeline()
                t.initialize(path, mark_cycles=mark, persistent=True)
                _live[path] = t
        return t
    t = Timeline()
    if path and rank == 0:
        t.initialize(path, mark_cycles=mark)
    return t


def close_live() -> None:
    """Close every live persistent timeline with its footer (at the
    process's exit), so that each file is valid JSON."""
    with _live_lock:
        live = [t for t in _live.values() if t.enabled]
        _live.clear()
    for t in live:
        t._close()


atexit.register(close_live)
