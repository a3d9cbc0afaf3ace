"""Always-on flight recorder, every failure ships its own evidence: the port
of ``horovod_tpu/telemetry/blackbox.py`` (the dump schema
``hvd-blackbox-v1``, which the JAX package's ``hvd_postmortem`` reads).

Gang-wide tracing (trace.py) is opt-in, so the 3 a.m. production
failure is exactly the run nobody traced.  This module is the black
box: a per-rank, fixed-capacity, in-memory ring of the event points the
codebase already pays for — collective begin/end, recovery-ladder rung
climbs, heartbeat misses, KV retries, elastic epoch changes, serving
step confirms, straggler records — that costs one global load + ``None``
check plus an O(1) deque append per event, and is dumped to disk only
when something terminal happens.

Recording contract (pinned by tests/test_torch_blackbox.py, with a
steady-state collective's allocation pin):

* **Always on** unless ``HVD_BLACKBOX=0``; capacity is
  ``HVD_BLACKBOX_EVENTS`` (default 512, floor 16).
* **No extra clock reads**: ``note()`` never touches ``time`` — call
  sites pass a timestamp they already took (tracer span reads, deadline
  bookkeeping), or 0 when the site has none.  Ring order disambiguates
  untimed events.
* **Zero steady-state allocations** beyond the small per-event tuple
  the bounded deque recycles capacity for — the recorder lives in the
  tracemalloc plane of test_dataplane's steady-state pin.

Dump contract:

* On any terminal event (collective-timeout verdict, eviction, wire
  corruption, engine abort, leader failover, SIGTERM) every rank
  atomically writes ``blackbox_rank<r>.json`` — ring + metrics snapshot
  + env fingerprint (secrets redacted) + last clock-offset estimate +
  in-flight collective state — into ``HVD_BLACKBOX_DIR`` (temp file +
  ``os.replace``, so a crash mid-dump leaves no torn file).
* The write is wrapped in the ``blackbox.dump`` chaos site and swallows
  every error: a full disk drops the black box, never rethrows over the
  original failure.
* The coordinator additionally pulls still-live workers' rings over the
  control channel (TAG_BLACKBOX / TAG_BLACKBOX_DUMP, runtime_py) into
  ``blackbox_rank<r>.pulled.json`` so one archive survives even when a
  rank's disk doesn't.

The JAX package's ``tools/hvd_postmortem.py`` ingests a dump directory and names the
first-cause rank; ``GET /debug/blackbox`` on the metrics debug server
returns the live ring of a wedged-but-alive rank.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.telemetry import registry as _tmx
from horovod_tpu_torch.utils import env as env_util

SCHEMA = "hvd-blackbox-v1"

# Env keys whose values never belong in a dump (the fingerprint is
# evidence, not a credential store).
_REDACT = ("SECRET", "TOKEN", "PASSWORD", "KEY")


class Blackbox:
    """One rank's flight recorder.  Appends are GIL-atomic deque writes;
    the lock only serializes dumps against snapshot reads."""

    def __init__(self, rank: int, capacity: int, out_dir: str,
                 epoch: int = 0):
        self.rank = rank
        self.capacity = capacity
        self.dir = out_dir
        self.epoch = epoch
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._clock_offset_ns = 0
        self._in_flight_name = ""
        self._in_flight_since_ns = 0
        self._dump_count = 0

    # -- O(1) recording hooks (never read the clock) ---------------------

    def note(self, kind: str, t_ns: int, fields: Optional[dict] = None
             ) -> None:
        """Append one event.  ``t_ns`` is a ``time.monotonic_ns()``-axis
        stamp the CALLER already had (0 = untimed; ring order still
        sequences it)."""
        self._ring.append((kind, t_ns, fields))

    def collective_begin(self, t_ns: int, seq: int, name: str, op: str,
                         nbytes: int, peer: int, transport: str) -> None:
        self._in_flight_name = name
        self._in_flight_since_ns = t_ns
        self._ring.append(("collective.begin", t_ns,
                           {"seq": seq, "name": name, "op": op,
                            "bytes": nbytes, "peer": peer,
                            "tp": transport}))

    def collective_end(self, t_ns: int, seq: int, ok: bool) -> None:
        self._in_flight_name = ""
        self._in_flight_since_ns = 0
        self._ring.append(("collective.end", t_ns, {"seq": seq, "ok": ok}))

    def note_clock_offset(self, offset_ns: int) -> None:
        """Latest midpoint-method estimate of (rank-0 clock − ours),
        piggybacked off the TAG_CLOCK_PONG handler.  Stored, not rung:
        the postmortem wants only the freshest value."""
        self._clock_offset_ns = int(offset_ns)

    @property
    def clock_offset_ns(self) -> int:
        return self._clock_offset_ns

    # -- snapshot + dump -------------------------------------------------

    def snapshot(self) -> dict:
        """The dump payload as a dict (also the /debug/blackbox body and
        the TAG_BLACKBOX_DUMP wire payload)."""
        events = [dict({"kind": k, "t_ns": t}, **(f or {}))
                  for k, t, f in list(self._ring)]
        in_flight = None
        name = self._in_flight_name
        if name:
            in_flight = {"name": name,
                         "since_ns": self._in_flight_since_ns}
        env = {}
        for k in sorted(os.environ):
            if not k.startswith(("HVD_", "HOROVOD_")):
                continue
            env[k] = ("<redacted>"
                      if any(s in k for s in _REDACT)
                      else os.environ[k])
        return {
            "schema": SCHEMA,
            "rank": self.rank,
            "epoch": self.epoch,
            "capacity": self.capacity,
            "wall_ns": time.time_ns(),
            "mono_ns": time.monotonic_ns(),
            "clock_offset_ns": self._clock_offset_ns,
            "in_flight": in_flight,
            "events": events,
            "metrics": _tmx.snapshot() if _tmx.enabled() else {},
            "env": env,
        }

    def dump(self, reason: str, detail: str = "") -> Optional[str]:
        """Atomically write ``blackbox_rank<r>.json``; returns the path,
        or None when the write failed.  NEVER raises — a failed dump
        must not mask the error that triggered it (``blackbox.dump``
        chaos site)."""
        with self._lock:
            try:
                doc = self.snapshot()
                doc["reason"] = reason
                doc["detail"] = detail
                path = os.path.join(self.dir,
                                    f"blackbox_rank{self.rank}.json")
                _fi.fire("blackbox.dump", path)
                os.makedirs(self.dir, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as fh:
                    json.dump(doc, fh, separators=(",", ":"))
                os.replace(tmp, path)
                self._dump_count += 1
                _tmx.inc_counter("hvd_blackbox_dumps_total")
                return path
            except Exception:
                return None

    def dump_bytes(self, reason: str, detail: str = "") -> bytes:
        """The dump as wire payload (coordinator pull).  Never raises;
        an encoding failure degrades to a minimal valid document."""
        try:
            doc = self.snapshot()
            doc["reason"] = reason
            doc["detail"] = detail
            return json.dumps(doc, separators=(",", ":")).encode("utf-8")
        except Exception:
            return json.dumps({"schema": SCHEMA, "rank": self.rank,
                               "epoch": self.epoch, "reason": reason,
                               "events": []}).encode("utf-8")


# Process-global recorder, module-level like runtime_py's retained replay
# batch so it survives engine teardown and elastic re-forms (an abort
# tears the engine down; the evidence must not go with it).
_BB: Optional[Blackbox] = None
_SIGTERM_HOOKED = False


def from_env(rank: int, epoch: int = 0) -> Optional[Blackbox]:
    """Engine-construction hook: create (or re-adopt) the process-global
    recorder.  Re-forms keep the ring — only rank/epoch are restamped —
    so pre-failure history survives engine incarnations."""
    global _BB
    if not env_util.blackbox_enabled():
        _BB = None
        return None
    bb = _BB
    if bb is None:
        bb = Blackbox(rank, env_util.blackbox_events(),
                      env_util.blackbox_dir(), epoch=epoch)
        _BB = bb
        _install_sigterm_hook()
    else:
        bb.rank = rank
        bb.epoch = epoch
        bb.dir = env_util.blackbox_dir()
    return bb


def _install_sigterm_hook() -> None:
    """Chain a dump onto SIGTERM (the launcher's fail-fast teardown
    signal) without stealing anyone's handler.  Best-effort: off the
    main thread (or under a non-default disposition we cannot chain)
    the terminal-event dumps still cover the failure."""
    global _SIGTERM_HOOKED
    if _SIGTERM_HOOKED:
        return
    try:
        import signal

        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            dump("sigterm")
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
        _SIGTERM_HOOKED = True
    except (ValueError, OSError, RuntimeError):
        pass


def get() -> Optional[Blackbox]:
    return _BB


def active() -> bool:
    return _BB is not None


def note(kind: str, t_ns: int = 0, **fields) -> None:
    """Global recording hook: one global load + None check when off."""
    bb = _BB
    if bb is not None:
        bb.note(kind, t_ns, fields or None)


def note_clock_offset(offset_ns: int) -> None:
    bb = _BB
    if bb is not None:
        bb.note_clock_offset(offset_ns)


def dump(reason: str, detail: str = "") -> Optional[str]:
    """Global dump hook for terminal events; no-op when off, never
    raises."""
    bb = _BB
    if bb is None:
        return None
    return bb.dump(reason, detail)


def reset() -> None:
    """Test helper: drop the global recorder (and re-arm from_env)."""
    global _BB
    _BB = None
