"""Deterministic fault injection: the port of
``horovod_tpu/common/fault_injection.py``.

A process-global *fault plan* names injection **sites** threaded through
the port's engine (socket helpers, the rendezvous KV client and server,
the bootstrap, the engine's loops, the data plane's links) and its
integrity, checkpoint and serving modules, and says what to do when
execution passes one: drop the operation (raise), delay it, raise, kill
the process, corrupt data, stall, or hold a half-open socket.  Faults are
one-shot (``times`` / ``after``) or probabilistic (``prob`` under the
plan's ``seed``); both replay exactly, and the same plan fires the same
sequence as the JAX package's module.

The plan comes from ``HOROVOD_FAULT_PLAN`` (inline JSON, a path to a JSON
file, or ``random:<seed>:<rate>``, see :func:`random_schedule`), read at
import, or from :func:`configure`.  With no plan, :func:`fire` is one
module-global ``None`` check.

Plan format::

    {"seed": 123, "faults": [
        {"site": "kv.put", "kind": "error", "times": 3},
        {"site": "sock.connect", "kind": "delay", "delay_s": 0.2,
         "prob": 0.5},
        {"site": "train.step", "kind": "kill", "after": 2},
        {"site": "ctrl.worker.send", "kind": "drop", "match": "1"}
    ]}

Fault fields:

* ``site``: the injection site's name (required).
* ``kind``: ``drop`` | ``error`` (both raise :class:`InjectedFault`, a
  ``ConnectionError``), ``delay`` (sleep ``delay_s``), ``kill``
  (``os._exit(137)``), ``corrupt`` (fires only at :func:`should_corrupt`
  sites, which apply the corruption themselves), ``stall`` (sleep
  ``stall_s``, then go on), ``halfopen`` (sleep ``stall_s``, then raise),
  ``partition`` (raise for every frame whose pair of ranks crosses
  ``groups``).
* ``match``: a substring the call's ``detail`` must hold.
* ``times``: fire at most this many times (default: no limit).
* ``after``: skip the first N matching passes (default 0).
* ``prob``: fire with this probability, drawn from the plan's PRNG.
* ``delay_s``: the ``delay`` (default 0.1 s).
* ``stall_s``: the ``stall`` / ``halfopen`` hang (default 3600 s).
* ``groups``: for ``partition``, two lists of ranks.  This process's rank
  is ``HVD_RANK``; a ``detail`` naming this rank itself (the
  ``ctrl.worker.send`` convention) stands for the root, rank 0.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import List, Optional

ENV_VAR = "HOROVOD_FAULT_PLAN"

# The site registry: every site literal the port passes to :func:`fire` /
# :func:`should_corrupt`, plus the user-level ``train.step`` a training
# script fires itself (tests/test_torch_fault_injection.py holds the
# package's literals to it).
KNOWN_SITES = {
    # control plane and data plane (fire)
    "sock.send": "mesh socket frame send",
    "sock.recv": "mesh socket exact receive",
    "sock.connect": "mesh bootstrap connect",
    "kv.put": "rendezvous KV client put",
    "kv.get": "rendezvous KV client get",
    "kv.list": "rendezvous KV client prefix list (the elastic leader's "
               "pending joiners)",
    "kv.delete": "rendezvous KV client delete",
    "kv.server.request": "rendezvous server request handling",
    "kv.mirror": "rendezvous primary->standby write-through mirroring",
    "metrics.server.request": "metrics debug-server request handling",
    "agg.scrape": "gang aggregator per-rank snapshot read (KV entry + "
                  "HTTP scrape fallback; detail = the rank)",
    "bootstrap.start": "worker bootstrap entry",
    "bootstrap.accept": "mesh listener accept loop",
    "engine.cycle": "PyEngine background cycle",
    "ctrl.worker.send": "worker->coordinator control send",
    "ctrl.coord.send": "coordinator->worker control send",
    "ctrl.subcoord.send": "sub-coordinator control forward (TREE_UP "
                          "aggregate to root / routed frame to a child)",
    "ctrl.reparent": "orphaned child's TAG_REPARENT adoption back to "
                     "the root after its sub-coordinator died",
    "sock.stall": "data-plane ring-hop receive (hang simulation)",
    "sock.halfopen": "persistent sender thread send (half-open sim)",
    "sock.corrupt": "flip one wire byte of a ladder data frame (CRC)",
    "sock.reset": "hard-reset a ladder data socket mid-collective",
    "shm.lost": "shm ring faults mid-gang (reader gone / attach lost)",
    "shm.stall": "data-plane shm ring receive (hang simulation)",
    "shm.attach": "shm segment attach during transport pairing",
    "trace.emit": "trace span-file write (a dropped/failed write must "
                  "never affect training)",
    "blackbox.dump": "flight-recorder dump at a terminal failure (a "
                     "failed dump must never mask the original error)",
    "train.step": "user-level per-step site (training scripts)",
    "serve.admit": "serving front-door admission (HTTP 503 shedding)",
    "serve.step": "serving decode step, every rank (stall/delay sim)",
    # data plane (should_corrupt)
    "grad.nonfinite": "poison local gradients with NaN (the guard)",
    "state.bitflip": "flip one bit of the audited replica state",
    "ckpt.corrupt": "corrupt one file of a just-written checkpoint",
}


def known_sites() -> dict:
    """Copy of the site registry (site name -> short description)."""
    return dict(KNOWN_SITES)


class InjectedFault(ConnectionError):
    """An artificial failure raised at a fault-injection site."""


class _Fault:
    __slots__ = ("site", "kind", "match", "times", "after", "prob",
                 "delay_s", "stall_s", "groups", "hits", "fired")

    def __init__(self, spec: dict):
        self.site = spec["site"]
        self.kind = spec.get("kind", "error")
        if self.kind not in ("drop", "error", "delay", "kill", "corrupt",
                             "stall", "halfopen", "partition"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        self.match = spec.get("match")
        self.times = spec.get("times")
        self.after = int(spec.get("after", 0))
        self.prob = spec.get("prob")
        self.delay_s = float(spec.get("delay_s", 0.1))
        self.stall_s = float(spec.get("stall_s", 3600.0))
        groups = spec.get("groups")
        if self.kind == "partition":
            if (not isinstance(groups, (list, tuple)) or len(groups) != 2
                    or not all(isinstance(g, (list, tuple))
                               for g in groups)):
                raise ValueError(
                    "partition fault needs groups: [[ranks...], "
                    "[ranks...]]")
            groups = (frozenset(int(r) for r in groups[0]),
                      frozenset(int(r) for r in groups[1]))
        self.groups = groups
        self.hits = 0    # matching passes seen
        self.fired = 0   # faults actually injected


class _Plan:
    def __init__(self, spec: dict):
        self.faults: List[_Fault] = [
            _Fault(f) for f in spec.get("faults", [])]
        self.rng = random.Random(spec.get("seed", 0))
        self.lock = threading.Lock()


# None = fault injection disabled; the single hot-path flag.
_PLAN: Optional[_Plan] = None


def fire(site: str, detail: str = "") -> None:
    """Injection-site hook.  No-op (one global load and an ``is`` check)
    unless a fault plan is active and names ``site``."""
    plan = _PLAN
    if plan is None:
        return
    _fire_slow(plan, site, detail)


def _matches_and_arms(plan: _Plan, f: _Fault, detail: str) -> bool:
    """Shared pass/fire bookkeeping for one site-matched fault."""
    if f.match is not None and f.match not in detail:
        return False
    with plan.lock:
        f.hits += 1
        if f.hits <= f.after:
            return False
        if f.times is not None and f.fired >= f.times:
            return False
        if f.prob is not None and plan.rng.random() >= f.prob:
            return False
        f.fired += 1
    return True


def _partition_crosses(f: _Fault, detail: str) -> bool:
    """True when this frame crosses the partition's two groups: the
    local process rank (HVD_RANK) on one side, the peer rank named by
    ``detail`` on the other.  Sites that pass the sender's OWN rank as
    detail (ctrl.worker.send, a sub-coordinator's TREE_UP) are talking
    to the root — rank 0 stands in as the remote."""
    try:
        me = int(os.environ.get("HVD_RANK", "0"))
        other = int(detail)
    except ValueError:
        return False  # non-rank detail: not a peer-addressed frame
    if other == me:
        other = 0
    g0, g1 = f.groups
    return (me in g0 and other in g1) or (me in g1 and other in g0)


def _fire_slow(plan: _Plan, site: str, detail: str) -> None:
    for f in plan.faults:
        if f.site != site or f.kind == "corrupt":
            # corrupt faults only arm at should_corrupt() sites — a
            # fire() site cannot apply a data corruption.
            continue
        if f.kind == "partition" and not _partition_crosses(f, detail):
            # Same-side traffic flows; only cross-group frames are cut
            # (and only those count against times/prob bookkeeping).
            continue
        if not _matches_and_arms(plan, f, detail):
            continue
        if f.kind == "delay":
            time.sleep(f.delay_s)
            continue
        if f.kind == "stall":
            time.sleep(f.stall_s)
            continue
        if f.kind == "halfopen":
            time.sleep(f.stall_s)
            raise InjectedFault(
                f"injected halfopen at {site!r}"
                + (f" ({detail})" if detail else ""))
        if f.kind == "kill":
            os._exit(137)
        raise InjectedFault(
            f"injected {f.kind} at {site!r}"
            + (f" ({detail})" if detail else ""))


def should_corrupt(site: str, detail: str = "") -> bool:
    """Data-corruption hook.  Returns True when an armed ``corrupt``
    fault names ``site`` — the call site then applies the actual
    corruption (it knows what a NaN gradient / flipped bit / torn file
    looks like).  Same zero-cost contract as :func:`fire` when no plan
    is active."""
    plan = _PLAN
    if plan is None:
        return False
    for f in plan.faults:
        if f.site != site or f.kind != "corrupt":
            continue
        if _matches_and_arms(plan, f, detail):
            return True
    return False


def configure(spec: Optional[dict]) -> None:
    """Install a fault plan programmatically (``None`` clears it)."""
    global _PLAN
    _PLAN = _Plan(spec) if spec else None


def clear() -> None:
    configure(None)


def active() -> bool:
    return _PLAN is not None


# The transient fault kinds the `random:` schedule sweeps — exactly the
# faults the recovery ladder (docs/fault_tolerance.md) must self-heal
# without an eviction.  sock.corrupt is a `corrupt` kind (the ladder
# sender flips a wire byte); the other two are `error` kinds whose
# InjectedFault the ladder treats as a dead socket / dead segment.
RANDOM_SCHEDULE_FAULTS = (
    ("sock.corrupt", "corrupt"),
    ("sock.reset", "error"),
    ("shm.lost", "error"),
)


def random_schedule(seed: int, rate: float) -> dict:
    """Expand ``random:<seed>:<rate>`` into a plan spec: each transient
    fault kind fires independently with probability ``rate`` per pass,
    from one PRNG seeded with ``seed`` — deterministic, so a chaos soak
    replays exactly under the same plan string."""
    return {"seed": int(seed), "faults": [
        {"site": site, "kind": kind, "prob": float(rate)}
        for site, kind in RANDOM_SCHEDULE_FAULTS]}


def _load_from_env() -> None:
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return
    raw = raw.strip()
    if raw.startswith("random:"):
        # Seedable randomized chaos soak: "random:<seed>:<rate>".
        _, seed, rate = raw.split(":")
        configure(random_schedule(int(seed), float(rate)))
        return
    if not raw.startswith("{"):
        with open(raw) as fh:
            raw = fh.read()
    configure(json.loads(raw))


_load_from_env()
