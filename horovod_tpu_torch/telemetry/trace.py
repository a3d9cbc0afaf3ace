"""Gang-wide distributed tracing, every rank streams structured spans: the
port of ``horovod_tpu/telemetry/trace.py``, record for record, so that
the JAX package's ``hvd_trace`` merges a port rank's file.

The timeline (utils/timeline.py) is rank-0-only and records *that* a
collective ran; this module records *where the time went on every rank*:
one span stream per rank covering the full life of each fused collective
— ``negotiate`` (enqueue to execution start), ``pack``,
``hop[i]{send_wait, recv, reduce}``, ``unpack``, ``callback`` — plus the
serving lockstep steps (``serve.apply`` / ``serve.confirm``, and
``serve.engine`` per incarnation), elastic
``elastic.reform`` / ``elastic.replay``, and recovery-ladder
``hop.retry`` / ``transport.failover`` events, each tagged with (rank,
collective seq, transport kind, peer).

On-disk format is JSONL, one record per line (append-safe across elastic
re-forms, truncation-safe on crash):

* ``{"k": "meta", "rank": R, "epoch": E, "mono_anchor_ns": ...,
  "wall_anchor_ns": ...}`` — once per incarnation; the anchors are the
  process-wide pair from utils/timeline.py, the coarse (NTP-grade)
  cross-host alignment fallback.
* ``{"k": "clock", "offset_ns": ..., "rtt_ns": ..., "t_ns": ...}`` —
  one midpoint-method estimate of (rank-0 clock − this rank's clock),
  fed by the TAG_CLOCK_PING/PONG exchange the worker piggybacks on the
  control channel (runtime_py).  The JAX package's ``tools/hvd_trace.py merge`` uses the
  median estimate to fuse the per-rank streams onto rank 0's clock.
* ``{"k": "span", "ph": <phase>, "t0": ..., "t1": ..., "seq": ...,
  ...args}`` — timestamps are raw ``time.monotonic_ns()`` reads.

Collective ``seq`` is a per-tracer counter bumped by
``begin_collective()``; responses execute serially in response-stream
order on every rank, so the same seq names the same fused collective
gang-wide — no seq needs to cross the wire.

Zero-cost contract (same discipline as the metrics registry and the
fault-injection hooks): with ``HVD_TRACE`` unset, ``from_env`` returns
``None`` and every call site guards on a single attribute/global load +
``None`` check — no allocation, no clock read, no syscall (pinned by
tests/test_torch_trace.py and tests/test_torch_blackbox.py).  Span
file writes are wrapped in the ``trace.emit`` chaos site and swallow
every error: a full disk or injected fault drops spans, never training.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.telemetry import registry as _tmx
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import timeline as _tl

# Records buffered per flush: spans are tiny and bursty (one per ring
# hop), so batching keeps the writer off the hot path's syscall budget.
_FLUSH_EVERY = 64


class Tracer:
    """One rank's span stream.  Thread-safe: the background loop, the
    ctrl recv thread (clock records), and the serving thread all emit."""

    def __init__(self, rank: int, path: str, epoch: int = 0):
        self.rank = rank
        self.path = path
        self.epoch = epoch
        self._lock = threading.Lock()
        self._buf: list = []
        self._seq = -1
        self._closed = False
        self._f = None
        try:
            # Append: an elastic re-form re-opens the same rank file and
            # adds a fresh meta record; JSONL makes that well-formed.
            self._f = open(path, "a")
        except OSError:
            self._f = None  # tracing silently off; training unaffected
        self._push({"k": "meta", "rank": rank, "epoch": epoch,
                    "pid": os.getpid(),
                    "mono_anchor_ns": _tl.MONO_ANCHOR_NS,
                    "wall_anchor_ns": _tl.WALL_ANCHOR_NS})

    # -- collective sequencing ------------------------------------------

    def begin_collective(self) -> int:
        """Bump and return the collective seq.  Called once per executed
        response, in response-stream order — identical on every rank."""
        self._seq += 1
        return self._seq

    @property
    def seq(self) -> int:
        return self._seq

    # -- record emission -------------------------------------------------

    def span(self, phase: str, t0_ns: int, t1_ns: int,
             seq: Optional[int] = None, **args) -> None:
        rec = {"k": "span", "ph": phase, "t0": int(t0_ns),
               "t1": int(t1_ns),
               "seq": self._seq if seq is None else seq}
        if args:
            rec.update(args)
        self._push(rec)
        if _tmx.enabled():
            _tmx.inc_counter("hvd_trace_spans_total", 1, (phase,))

    def instant(self, phase: str, **args) -> None:
        t = time.monotonic_ns()
        self.span(phase, t, t, **args)

    def clock(self, offset_ns: int, rtt_ns: int) -> None:
        """Record one clock-offset estimate: (rank-0 clock − ours)."""
        self._push({"k": "clock", "offset_ns": int(offset_ns),
                    "rtt_ns": int(rtt_ns),
                    "t_ns": time.monotonic_ns()})

    # -- buffered writer -------------------------------------------------

    def _push(self, rec: dict) -> None:
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) >= _FLUSH_EVERY:
                self._flush_locked()

    def _flush_locked(self) -> None:
        buf, self._buf = self._buf, []
        if not buf or self._f is None or self._closed:
            return
        try:
            # Chaos site: an injected error here models a full disk /
            # dead NFS mount — the batch is dropped, training continues.
            _fi.fire("trace.emit", self.path)
            self._f.write("".join(
                json.dumps(r, separators=(",", ":")) + "\n" for r in buf))
            self._f.flush()
        except Exception:
            pass

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            self._closed = True
            if self._f is not None:
                try:
                    self._f.close()
                except Exception:
                    pass
                self._f = None


# The process-global tracer: the hook for call sites that have no engine
# handle (transport build, recovery ladder, elastic re-form).  Valid in
# production (one rank per process); in-process multi-rank test harnesses
# attach per-engine Tracer instances to ``engine._tracer`` instead.
_TR: Optional[Tracer] = None


def enabled_in_env() -> bool:
    return env_util.trace_enabled()


def from_env(rank: int) -> Optional[Tracer]:
    """Engine-construction hook: a Tracer when ``HVD_TRACE`` is set
    (every rank — that is the point), else None.  Also installs the
    process-global tracer for engine-less call sites."""
    global _TR
    if not enabled_in_env():
        return None
    d = env_util.trace_dir()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        pass
    tr = Tracer(rank, os.path.join(d, f"trace_rank{rank}.jsonl"),
                epoch=env_util.get_int(env_util.ELASTIC_EPOCH, 0))
    _TR = tr
    return tr


def get() -> Optional[Tracer]:
    return _TR


def active() -> bool:
    return _TR is not None


def emit(phase: str, t0_ns: int, t1_ns: int, **args) -> None:
    """Global-hook span: one global load + None check when off."""
    tr = _TR
    if tr is not None:
        tr.span(phase, t0_ns, t1_ns, **args)


def emit_instant(phase: str, **args) -> None:
    tr = _TR
    if tr is not None:
        tr.instant(phase, **args)


def release(tr: Optional[Tracer]) -> None:
    """Engine-shutdown hook: flush + close an engine's tracer and clear
    the global hook if it points at the same instance."""
    global _TR
    if tr is None:
        return
    tr.close()
    if _TR is tr:
        _TR = None


def reset() -> None:
    """Test helper: drop the global tracer."""
    global _TR
    tr, _TR = _TR, None
    if tr is not None:
        tr.close()
