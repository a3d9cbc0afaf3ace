"""Continuous-batching admission scheduler (rank 0 only): the port of
``horovod_tpu/serving/scheduler.py``, stdlib only.

The scheduler owns the request lifecycle on the coordinator: HTTP
handler threads ``submit()`` prompts into a bounded FIFO queue, the
serving loop moves queued requests into free decode slots at token
boundaries (``take_admissions``), appends sampled tokens
(``on_token``), and completes or replays them.  Worker ranks never see
this class — they reconstruct identical slot state from the broadcast
deltas (loop.py).

Thread-safety: handler threads and the serving-loop thread share one
lock; completion is signalled per-request through an Event the handler
blocks on.

Telemetry: the queue-depth, occupancy and staleness gauges, the request
counters by status and the TTFT histogram, from which :meth:`stats` gives
``ttft_p50_ms``/``ttft_p99_ms`` with the registry on, and ``step_*`` from
the serving loop's decode-step histogram (``loop.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.telemetry import registry as _tmx

# Completed requests kept around for join-by-id (a client re-POSTing an
# id after a leader fail-over must get the finished answer, not a
# duplicate decode).  Bounded so serving forever never grows memory.
_RECENT_CAP = 256


class QueueFull(Exception):
    """Admission queue is at HVD_SERVE_MAX_QUEUE — shed (HTTP 503)."""


class Request:
    """One /generate request through its life: queued -> active (slot
    assigned) -> done.  ``tokens`` holds only the generated tail, never
    the prompt."""

    def __init__(self, req_id: str, prompt: List[int], max_new: int):
        self.id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        # Bumped on each replay admission: a re-formed gang decodes the
        # request from the prompt again (at-least-once), so the token
        # tail is rebuilt from scratch.
        self.attempts = 0


class Scheduler:
    def __init__(self, max_batch: int, max_queue: int, cache_len: int):
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.cache_len = cache_len
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._ids = itertools.count()
        self._completed = 0
        self._recent: "OrderedDict[str, Request]" = OrderedDict()
        # Monotonic stamp of the last gang-confirmed decode step, fed
        # by the serving loop (loop.py reuses the latency read it
        # already takes).  /stats derives last_step_age_s from it so an
        # external router can spot a wedged gang before clients time
        # out; 0.0 = no step confirmed yet this incarnation.
        self._last_step_t = 0.0

    def _find(self, req_id: str) -> Optional[Request]:
        """A live or recently-completed request with this id, else None.
        Caller holds the lock."""
        for r in self._queue:
            if r.id == req_id:
                return r
        for r in self._slots:
            if r is not None and r.id == req_id:
                return r
        return self._recent.get(req_id)

    # -- handler-thread side -------------------------------------------

    def submit(self, prompt: List[int], max_new: int,
               req_id: Optional[str] = None) -> Request:
        """Queue a request; raises ValueError on an unservable shape and
        QueueFull when the admission queue is at its bound.

        ``req_id`` (optional, client-supplied) makes the submit
        idempotent: when a request with that id is already queued,
        active, or recently completed, the existing Request is returned
        instead of a duplicate — the re-POST a client issues after a
        leader fail-over joins the shadow-replayed original."""
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new > self.cache_len:
            raise ValueError(
                f"prompt + max_new_tokens ({len(prompt) + max_new}) "
                f"exceeds the serving cache length ({self.cache_len})")
        with self._lock:
            if req_id is not None:
                existing = self._find(req_id)
                if existing is not None:
                    return existing
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"admission queue full ({self.max_queue})")
            req = Request(req_id or f"r{next(self._ids)}",
                          list(prompt), max_new)
            self._queue.append(req)
            _tmx.set_gauge("hvd_serve_queue_depth", len(self._queue))
        return req

    # -- leader fail-over (promoted rank) -------------------------------

    def adopt_shadow(self, entries: List[Tuple[int, Dict]]) -> int:
        """Seed a fresh scheduler (on a worker just promoted to rank 0)
        with the dead leader's in-flight slot table, reconstructed from
        the broadcast delta frames: ``entries`` is a ``(slot, {"id",
        "prompt", "max_new", ...})`` list.  Each becomes a queued
        Request with ``attempts=1`` — the lost incarnation's decode was
        attempt 1, so the replay the new leader admits reports
        ``attempts >= 2`` (at-least-once, like requeue_inflight).
        Returns how many were adopted."""
        adopted = 0
        with self._lock:
            for slot, st in sorted(entries, key=lambda e: e[0]):
                if self._find(st["id"]) is not None:
                    continue  # already known (e.g. client re-POST won)
                req = Request(st["id"], list(st["prompt"]),
                              int(st["max_new"]))
                req.attempts = 1
                self._queue.append(req)
                adopted += 1
            if adopted:
                _tmx.set_gauge("hvd_serve_queue_depth", len(self._queue))
        for _ in range(adopted):
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("replayed",))
        return adopted

    # -- serving-loop side ---------------------------------------------

    def take_admissions(self) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots (FIFO, as many as fit);
        returns the (slot, request) pairs admitted this step."""
        out: List[Tuple[int, Request]] = []
        with self._lock:
            for slot in range(self.max_batch):
                if self._slots[slot] is not None or not self._queue:
                    continue
                req = self._queue.popleft()
                req.slot = slot
                req.attempts += 1
                self._slots[slot] = req
                out.append((slot, req))
            if out:
                _tmx.set_gauge("hvd_serve_queue_depth", len(self._queue))
                _tmx.set_gauge("hvd_serve_batch_occupancy",
                               self.active_count())
        return out

    def on_token(self, slot: int, token: int) -> Request:
        """Append one sampled token to the slot's request (first token
        records TTFT)."""
        with self._lock:
            req = self._slots[slot]
            assert req is not None, f"token for empty slot {slot}"
            if not req.tokens:
                req.t_first_token = time.monotonic()
                _tmx.observe("hvd_serve_ttft_seconds",
                             req.t_first_token - req.t_submit)
            req.tokens.append(token)
        return req

    def complete(self, slot: int) -> None:
        """Retire the slot's request and wake its handler thread."""
        with self._lock:
            req = self._slots[slot]
            assert req is not None, f"complete() on empty slot {slot}"
            self._slots[slot] = None
            self._completed += 1
            self._recent[req.id] = req
            while len(self._recent) > _RECENT_CAP:
                self._recent.popitem(last=False)
            _tmx.set_gauge("hvd_serve_batch_occupancy",
                           self.active_count())
        _tmx.inc_counter("hvd_serve_requests_total", labels=("ok",))
        req.done.set()

    def requeue_inflight(self) -> int:
        """At-least-once replay after a gang re-form: every active
        request goes back to the FRONT of the queue (original admission
        order) with its token tail cleared — the re-formed gang decodes
        it from the prompt again.  Returns how many were requeued."""
        with self._lock:
            inflight = [r for r in self._slots if r is not None]
            inflight.sort(key=lambda r: r.t_submit)
            for req in reversed(inflight):
                req.tokens = []
                req.slot = None
                self._queue.appendleft(req)
            self._slots = [None] * self.max_batch
            if inflight:
                _tmx.set_gauge("hvd_serve_queue_depth", len(self._queue))
                _tmx.set_gauge("hvd_serve_batch_occupancy", 0)
        for _ in inflight:
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("replayed",))
        return len(inflight)

    def fail_all(self, reason: str) -> None:
        """Unrecoverable serving failure: error out every queued and
        active request so no handler thread blocks forever."""
        with self._lock:
            pending = [r for r in self._slots if r is not None]
            pending.extend(self._queue)
            self._queue.clear()
            self._slots = [None] * self.max_batch
        for req in pending:
            req.error = reason
            req.done.set()

    # -- introspection ---------------------------------------------------

    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def active_slots(self) -> Dict[int, Request]:
        with self._lock:
            return {i: r for i, r in enumerate(self._slots)
                    if r is not None}

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or \
                any(r is not None for r in self._slots)

    def note_step(self, t: float) -> None:
        """The serving loop confirmed a decode step at monotonic time
        ``t`` (a read the loop already took for its latency metric)."""
        self._last_step_t = t

    def stats(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            oldest = min((r.t_submit for r in self._queue), default=now)
            out = {
                "queued": len(self._queue),
                "active": sum(1 for r in self._slots if r is not None),
                "slots": self.max_batch,
                "completed": self._completed,
                # Staleness surface for external probes: how long since
                # the gang last stepped, and how long the oldest queued
                # request has been starving.
                "last_step_age_s": round(
                    now - self._last_step_t, 3)
                    if self._last_step_t else 0.0,
                "oldest_queued_age_s": round(now - oldest, 3),
            }
        _tmx.set_gauge("hvd_serve_last_step_age_seconds",
                       out["last_step_age_s"])
        _tmx.set_gauge("hvd_serve_oldest_queued_age_seconds",
                       out["oldest_queued_age_s"])
        # SLO rollups from the registry's serve histograms (the same
        # bucket math the gang aggregator uses), when telemetry is on.
        if _tmx.enabled():
            hists = _tmx.snapshot().get("histograms", {})
            for metric, key in (("hvd_serve_ttft_seconds", "ttft"),
                                ("hvd_serve_token_latency_seconds",
                                 "step")):
                h = hists.get(metric)
                if h and h.get("count"):
                    out[f"{key}_p50_ms"] = round(
                        1e3 * _tmx.histogram_quantile(h, 0.50), 3)
                    out[f"{key}_p99_ms"] = round(
                        1e3 * _tmx.histogram_quantile(h, 0.99), 3)
        return out
