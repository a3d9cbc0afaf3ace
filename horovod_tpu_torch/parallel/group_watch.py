"""The collective watch: the collective deadline over an elastic NCCL rank's
group collectives.

An NCCL collective returns to the host once it is queued; its kernel waits
on the card until every member of the group joins.  A peer that is alive
but never joins (stalled before its step's collectives, its control link
up) holds that kernel, and the host's next sync with the card (a decode
step's copy of its tokens) waits behind it.  No eager-engine operation is
pending then, so nothing reaches the gang's abort agreement.  The JAX
engine bounds its collectives by the hop deadline's agreement; this watch
is the port's bound on its process-group collectives, whose kernels the
host cannot time itself without a sync per collective.

After each group collective (``ops/collective.py``'s ``_on``, the
pipeline's exchange) the rank records a CUDA event on the current stream
(:func:`record`), with the time it was queued and the group's ranks.  A
thread polls the oldest pending event (``query()``: no host sync).  Once it
has been pending past the deadline (``HVD_COLLECTIVE_TIMEOUT``), the thread
calls the watch's ``on_expired(ranks, age_s)`` once and ends:
``hvd.init`` makes that :func:`horovod_tpu_torch.basics.abort_process_groups`
naming the group, which ends the kernel, so that the host's sync returns
and the next collective, or the serving engine's check after its copy,
raises ``parallel.mesh.GroupAbortedError`` carrying the group's ranks;
``@hvd.elastic.run`` then asks the gang's verdict on that group.

``hvd.init`` arms one watch for each incarnation of an elastic rank on an
NCCL group with a deadline (:func:`arm`), whichever eager engine runs, and
``hvd.shutdown()`` (which every re-form runs) stops it.  Elsewhere nothing
is armed and :func:`record` is one module-global ``None`` check.  A handle
is anything with ``query() -> bool`` (True once the collective completed):
``current().add`` takes one that the caller made.

The watch's thread never releases a CUDA event: on two H100s (torch 2.11)
destroying the pending ones at the deadline waited, holding the GIL, while
the main thread's copy of a step's tokens to pageable host memory was
blocked behind the stalled collective, so the watch never fired.  A
completed event goes back to a free list that :func:`record` draws from;
the events a watch holds when it stops on its own thread (its firing) are
released by the next :func:`arm` or :func:`disarm` on another thread.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

Ranks = Tuple[int, ...]
WATCH_THREAD = "hvd-group-watch"


def poll_interval_s(deadline_s: float) -> float:
    """How often the watch queries the oldest pending handle: a fiftieth
    of the deadline, within [5 ms, 100 ms]."""
    return min(0.1, max(0.005, deadline_s / 50.0))


class GroupWatch:
    """Pending collectives, oldest first, and the thread that watches the
    oldest.  ``on_expired(ranks, age_s)`` runs on the watch's thread, at
    most once: for the first handle still pending ``deadline_s`` after it
    was added.  ``device``: the card whose events the handles are (the
    thread makes it current), or None."""

    def __init__(self, deadline_s: float,
                 on_expired: Callable[[Ranks, float], None], *,
                 device: Optional[torch.device] = None):
        if deadline_s <= 0:
            raise ValueError(f"the watch needs a deadline > 0, got "
                             f"{deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = poll_interval_s(deadline_s)
        self._on_expired = on_expired
        self._device = device
        self._pending = collections.deque()  # (handle, t_added, ranks,
        #                                        reusable)
        self._free = []  # completed reusable handles
        self._cv = threading.Condition()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # The expired group's ranks, and how long its handle was pending.
        self.fired: Optional[Ranks] = None
        self.fired_age_s: Optional[float] = None

    def add(self, handle, ranks: Sequence[int],
            reusable: bool = False) -> None:
        """Watch ``handle``, a collective over ``ranks`` queued now;
        ``reusable``: once it completed, :meth:`reuse` may hand it out
        again."""
        with self._cv:
            if self._stopped or self.fired is not None:
                return
            self._pending.append((handle, time.monotonic(), tuple(ranks),
                                  reusable))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=WATCH_THREAD, daemon=True)
                self._thread.start()
            elif len(self._pending) == 1:
                self._cv.notify()

    def reuse(self):
        """A completed reusable handle, or None."""
        with self._cv:
            return self._free.pop() if self._free else None

    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the thread and drop every handle and the callback; joins
        the thread unless called on it, where the handles go to
        :func:`_retire` instead.  Idempotent."""
        with self._cv:
            self._stopped = True
            handles = [h for h, _, _, _ in self._pending] + self._free
            self._pending.clear()
            self._free = []
            self._on_expired = None
            self._cv.notify_all()
            t = self._thread
        if t is threading.current_thread():
            _retire(handles)
        elif t is not None:
            t.join(timeout)

    def _run(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                handle, t_added, ranks, reusable = self._pending[0]
            if handle.query():
                with self._cv:
                    if self._pending and self._pending[0][0] is handle:
                        self._pending.popleft()
                        if reusable:
                            self._free.append(handle)
                continue
            age = time.monotonic() - t_added
            if age >= self.deadline_s:
                with self._cv:
                    if self._stopped:
                        return
                    self.fired, self.fired_age_s = ranks, age
                    on_expired = self._on_expired
                del handle
                on_expired(ranks, age)
                # The handles are released by stop() (the abort's, or
                # the next disarm), never here.
                return
            del handle
            with self._cv:
                if not self._stopped:
                    self._cv.wait(min(self.poll_s, self.deadline_s - age))


_watch: Optional[GroupWatch] = None
_lock = threading.Lock()
# Handles of a watch stopped on its own thread, until another thread's
# arm() or disarm() releases them.
_retired: list = []


def _retire(handles) -> None:
    with _lock:
        _retired.extend(handles)


def _release_retired() -> None:
    if threading.current_thread().name == WATCH_THREAD:
        return
    with _lock:
        done = list(_retired)
        _retired.clear()
    del done


def arm(deadline_s: float, on_expired: Callable[[Ranks, float], None],
        device: torch.device) -> GroupWatch:
    """This incarnation's watch, replacing (and stopping) any earlier
    one.  On a card, :func:`record` records an event after each group
    collective; on the CPU (a collective there returns complete) only
    handles given to :func:`watch` are watched."""
    global _watch
    w = GroupWatch(deadline_s, on_expired, device=device)
    with _lock:
        old, _watch = _watch, w
    if old is not None:
        old.stop()
    _release_retired()
    return w


def disarm() -> None:
    """Stop and drop this incarnation's watch (a no-op without one)."""
    global _watch
    with _lock:
        w, _watch = _watch, None
    if w is not None:
        w.stop()
    _release_retired()


def current() -> Optional[GroupWatch]:
    return _watch


def record(ranks: Sequence[int]) -> None:
    """After a group collective over ``ranks`` was queued: watch a CUDA
    event recorded on the current stream behind it, where a watch is
    armed on a card."""
    w = _watch
    if w is None or w._device is None or w._device.type != "cuda":
        return
    ev = w.reuse() or torch.cuda.Event()
    ev.record()
    w.add(ev, ranks, reusable=True)
