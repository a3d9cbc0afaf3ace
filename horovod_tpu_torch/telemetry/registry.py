"""Lock-cheap metrics registry: counters, gauges, log2 histograms.  The port
of ``horovod_tpu/telemetry/registry.py``: the same 45 series, names, kinds,
labels, help and buckets, and the same snapshot and Prometheus text, so
that a gang of port and JAX ranks folds into one view.

Design goals, in order:

1. **Provably zero-cost when off.**  The module-level hooks
   (``inc_counter`` / ``set_gauge`` / ``observe``) do a single global
   load + ``None`` check and return — the same contract as
   ``fault_injection.fire`` — so instrumenting a hot path costs one
   function call and zero allocations when ``HVD_METRICS`` is unset
   (pinned by tests/test_torch_telemetry.py, mirroring the chaos harness pin).
   Call sites whose *arguments* would allocate (dynamic label values,
   byte counts) guard on ``enabled()`` first.
2. **Central registry.**  Every metric name must be declared in
   ``KNOWN_METRICS`` before use — an undeclared name raises when the
   registry is on.  The port declares exactly the JAX package's series
   (tests/test_torch_telemetry.py holds the two tables equal), which
   docs/metrics.md documents, the four elastic series
   (``hvd_elastic_epoch``, ``hvd_elastic_reforms_total``,
   ``hvd_fenced_writes_total``, ``hvd_leader_failovers_total``)
   included.
3. **One lock, fixed buckets.**  A single ``threading.Lock`` guards all
   series (contention is negligible next to the socket work the
   instrumented paths do).  Histograms use fixed log2 bucket bounds
   (``lo * 2**i``), so an observation is a ``bisect`` + increment — no
   per-observation allocation, and buckets line up across ranks for
   aggregation.

Prometheus text exposition follows the v0.0.4 format: ``# HELP`` /
``# TYPE`` headers, cumulative ``_bucket{le=...}`` series plus ``_sum`` /
``_count`` for histograms.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Optional, Tuple


def log2_buckets(lo: float, n: int) -> Tuple[float, ...]:
    """``n`` upper bounds ``lo * 2**i`` (the +Inf bucket is implicit)."""
    return tuple(lo * (2.0 ** i) for i in range(n))


def _counter(help_: str, labels: Tuple[str, ...] = ()) -> dict:
    return {"kind": "counter", "help": help_, "labels": labels}


def _gauge(help_: str, labels: Tuple[str, ...] = ()) -> dict:
    return {"kind": "gauge", "help": help_, "labels": labels}


def _hist(help_: str, lo: float, n: int,
          labels: Tuple[str, ...] = ()) -> dict:
    return {"kind": "histogram", "help": help_, "labels": labels,
            "buckets": log2_buckets(lo, n)}


# Bucket families: latencies span 0.5 ms .. ~16 s; sizes span
# 256 B .. 128 MB (the default fusion threshold is 64 MB).
_SECONDS = (0.0005, 16)
_BYTES = (256.0, 20)

# The registry: every metric the package emits, with kind, help text,
# label names, and (for histograms) bucket bounds.  Keep alphabetized
# within each group; the JAX package's table, entry for entry.
KNOWN_METRICS: Dict[str, dict] = {
    # -- engine coordination (runtime_py.py) --
    "hvd_cycles_total": _counter(
        "Background coordination cycles run."),
    "hvd_cycle_duration_seconds": _hist(
        "Wall time of one coordination cycle.", *_SECONDS),
    "hvd_negotiation_seconds": _hist(
        "Per-tensor negotiation latency: first rank ready to globally "
        "ready.", *_SECONDS),
    "hvd_queue_depth": _gauge(
        "Requests waiting in the engine message queue at cycle start."),
    "hvd_fused_bytes": _hist(
        "Payload bytes per fused response batch.", *_BYTES),
    "hvd_fused_tensors": _hist(
        "Tensors per fused response batch.", 1.0, 10),
    "hvd_stall_warnings_total": _counter(
        "Stalled-tensor warnings issued by the stall inspector."),
    # -- collectives (ops/eager.py; the jit bridge funnels through the
    #    same eager machinery, so these cover both entry points) --
    "hvd_collectives_total": _counter(
        "Collective operations completed.", ("op", "dtype")),
    "hvd_collective_bytes": _hist(
        "Input payload bytes per collective.", *_BYTES,
        labels=("op", "dtype")),
    "hvd_collective_latency_seconds": _hist(
        "Enqueue-to-completion latency per collective.", *_SECONDS,
        labels=("op", "dtype")),
    # -- eager data plane (ops/cpu_backend.py; docs/performance.md) --
    "hvd_ring_hop_seconds": _hist(
        "Wall time of one ring hop (send enqueue through receive+reduce "
        "and send completion), labeled by ring phase.", *_SECONDS,
        labels=("phase",)),
    "hvd_dataplane_alloc_bytes": _counter(
        "Bytes allocated growing the persistent data-plane buffers "
        "(fusion, hop, and fp32 scratch); flat in steady state."),
    "hvd_transport_bytes_total": _counter(
        "Payload bytes enqueued on the eager data plane, by transport "
        "(shm for same-host peers, tcp otherwise).",
        labels=("transport",)),
    # -- response cache (common/response_cache.py via the engine) --
    "hvd_cache_hits_total": _counter(
        "Response-cache hits in request classification."),
    "hvd_cache_misses_total": _counter(
        "Response-cache misses (full negotiation taken)."),
    # -- robustness layers --
    "hvd_heartbeat_misses_total": _counter(
        "Ranks declared dead by the heartbeat timeout."),
    "hvd_evictions_total": _counter(
        "Dead ranks evicted via the Join machinery."),
    "hvd_collective_timeouts_total": _counter(
        "Collectives aborted by the gang after blowing "
        "HVD_COLLECTIVE_TIMEOUT (hung-rank detection)."),
    "hvd_collective_abort_seconds": _hist(
        "Latency from a rank's local hop timeout to the applied "
        "gang-wide abort verdict.", *_SECONDS),
    "hvd_hop_retries_total": _counter(
        "Data frames retransmitted by the recovery ladder, by cause "
        "(corrupt = CRC mismatch NACK, reset = replay after a peer "
        "reset/reconnect, failover = replay after an shm->TCP "
        "demotion).", labels=("cause",)),
    "hvd_peer_reconnects_total": _counter(
        "Dropped data sockets re-dialed and resumed in place by the "
        "recovery ladder (no eviction)."),
    "hvd_transport_failovers_total": _counter(
        "Peer pairs demoted from a faulted shm ring to TCP in place by "
        "the recovery ladder."),
    "hvd_kv_retries_total": _counter(
        "Rendezvous KV client request retries."),
    "hvd_elastic_epoch": _gauge(
        "Current elastic membership epoch."),
    "hvd_elastic_reforms_total": _counter(
        "Successful elastic gang re-forms."),
    "hvd_leader_failovers_total": _counter(
        "Re-forms triggered by the death of rank 0 (the star "
        "coordinator / serving leader); the lowest surviving rank "
        "is promoted."),
    "hvd_nonfinite_skips_total": _counter(
        "Steps skipped by the agreed non-finite gradient guard."),
    # -- hierarchical control plane (runtime_py.py two-level tree;
    #    docs/fault_tolerance.md "Hierarchical control plane") --
    "hvd_ctrl_cycle_seconds": _hist(
        "Wall time of one root coordination cycle, labeled by gang "
        "size — the coordination-cycle-latency-vs-ranks curve the "
        "control-plane scale simulation (bench.py) exports.", *_SECONDS,
        labels=("ranks",)),
    "hvd_subcoord_reparents_total": _counter(
        "Children of a dead per-host sub-coordinator re-attached "
        "directly to the root (TAG_REPARENT) without a gang-wide "
        "abort."),
    "hvd_fenced_writes_total": _counter(
        "Stale-epoch writes rejected by the epoch fence: control "
        "frames answered with TAG_FENCE by the coordinator, and "
        "elastic/* KV writes answered with HTTP 409 by the rendezvous "
        "server."),
    # -- gang-wide tracing (telemetry/trace.py; docs/timeline.md) --
    "hvd_trace_clock_skew_seconds": _gauge(
        "Latest midpoint-method estimate of this rank's monotonic-clock "
        "offset from rank 0 (TAG_CLOCK_PING over the control channel)."),
    "hvd_trace_spans_total": _counter(
        "Trace spans recorded, by span phase (negotiate, pack, hop, "
        "unpack, callback, serve.*, elastic.*, ...).", ("phase",)),
    # -- straggler detection (telemetry/straggler.py) --
    "hvd_straggler_skew_seconds": _hist(
        "Negotiation skew: last rank ready minus first rank ready, "
        "labeled by the last rank.", *_SECONDS, labels=("rank",)),
    "hvd_straggler_events_total": _counter(
        "STRAGGLER records emitted (rank consistently last beyond "
        "HVD_STRAGGLER_WARN_MS).", ("rank",)),
    # -- inference serving (serving/) --
    "hvd_serve_requests_total": _counter(
        "Serving requests by terminal status (ok / shed / error / "
        "replayed — replayed counts re-admissions after a re-form, "
        "the same request later lands in ok).", ("status",)),
    "hvd_serve_queue_depth": _gauge(
        "Requests waiting for a decode slot (rank 0)."),
    "hvd_serve_batch_occupancy": _gauge(
        "Decode slots currently serving a request (rank 0)."),
    "hvd_serve_ttft_seconds": _hist(
        "Time to first token: submit to first sampled token.",
        *_SECONDS),
    "hvd_serve_token_latency_seconds": _hist(
        "Wall time of one gang decode step (prefills + batched step + "
        "token-agreement allreduce).", *_SECONDS),
    "hvd_serve_last_step_age_seconds": _gauge(
        "Seconds since the gang last confirmed a decode step (rank 0; "
        "refreshed on each /stats read — a growing value means the gang "
        "is wedged)."),
    "hvd_serve_oldest_queued_age_seconds": _gauge(
        "Age of the oldest request still waiting for a decode slot "
        "(rank 0; 0 when the queue is empty)."),
    # -- flight recorder (telemetry/blackbox.py; docs/fault_tolerance.md) --
    "hvd_blackbox_dumps_total": _counter(
        "Flight-recorder dumps written at terminal failures."),
    # -- gang aggregation & alerts (telemetry/aggregate.py) --
    "hvd_alerts_total": _counter(
        "Anomaly-engine alerts fired (rising edges), by rule.",
        ("rule",)),
    "hvd_gang_agg_fold_seconds": _hist(
        "Wall time of one gang aggregation fold on the coordinator "
        "(read every rank's snapshot, merge, evaluate alert rules).",
        *_SECONDS),
    "hvd_gang_stale_ranks": _gauge(
        "Ranks whose snapshot could not be read in the latest "
        "aggregation fold (missing/torn/old-epoch KV entry and "
        "unreachable scrape fallback)."),
}


class Registry:
    """All live series for one process.  Series are keyed by
    ``(name, label_values)``; label values arrive as a tuple ordered
    like the spec's label names."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, float] = {}
        self._gauges: Dict[tuple, float] = {}
        # (name, labels) -> [bucket_counts..., inf_count, sum, count]
        self._hists: Dict[tuple, list] = {}

    @staticmethod
    def _spec(name: str, kind: str) -> dict:
        spec = KNOWN_METRICS.get(name)
        if spec is None:
            raise KeyError(
                f"metric {name!r} is not declared in KNOWN_METRICS "
                "(horovod_tpu_torch/telemetry/registry.py) — declare it and "
                "document it in docs/metrics.md")
        if spec["kind"] != kind:
            raise TypeError(
                f"metric {name!r} is a {spec['kind']}, not a {kind}")
        return spec

    def inc_counter(self, name: str, value: float = 1.0,
                    labels: tuple = ()) -> None:
        self._spec(name, "counter")
        key = (name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: tuple = ()) -> None:
        self._spec(name, "gauge")
        with self._lock:
            self._gauges[(name, labels)] = float(value)

    def observe(self, name: str, value: float,
                labels: tuple = ()) -> None:
        spec = self._spec(name, "histogram")
        bounds = spec["buckets"]
        idx = bisect_left(bounds, value)  # == len(bounds) -> +Inf bucket
        key = (name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0] * (len(bounds) + 1) + [0.0, 0]
            h[idx] += 1
            h[-2] += value
            h[-1] += 1

    # -- export ----------------------------------------------------------

    @staticmethod
    def _series(name: str, labels: tuple) -> str:
        if not labels:
            return name
        names = KNOWN_METRICS[name]["labels"]
        inner = ",".join(f'{k}="{v}"' for k, v in zip(names, labels))
        return f"{name}{{{inner}}}"

    def snapshot(self) -> dict:
        """JSON-serializable view: Prometheus-style series keys so tests
        and offline analysis can match a labeled series by name."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), v in sorted(counters.items()):
            out["counters"][self._series(name, labels)] = v
        for (name, labels), v in sorted(gauges.items()):
            out["gauges"][self._series(name, labels)] = v
        for (name, labels), h in sorted(hists.items()):
            bounds = KNOWN_METRICS[name]["buckets"]
            buckets = {_fmt(b): h[i] for i, b in enumerate(bounds)}
            buckets["+Inf"] = h[len(bounds)]
            out["histograms"][self._series(name, labels)] = {
                "buckets": buckets, "sum": h[-2], "count": h[-1]}
        return out

    def render_prometheus(self) -> str:
        """Text exposition format v0.0.4."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
        lines = []
        for name in sorted(KNOWN_METRICS):
            spec = KNOWN_METRICS[name]
            kind = spec["kind"]
            store = {"counter": counters, "gauge": gauges,
                     "histogram": hists}[kind]
            series = sorted(k for k in store if k[0] == name)
            if not series:
                continue
            lines.append(f"# HELP {name} {spec['help']}")
            lines.append(f"# TYPE {name} {kind}")
            if kind != "histogram":
                for key in series:
                    lines.append(
                        f"{self._series(name, key[1])} {_fmt(store[key])}")
                continue
            bounds = spec["buckets"]
            label_names = spec["labels"]
            for key in series:
                h = store[key]
                extra = list(zip(label_names, key[1]))
                cum = 0
                for i, b in enumerate(bounds):
                    cum += h[i]
                    lines.append(
                        f"{_labeled(name + '_bucket', extra, ('le', _fmt(b)))}"
                        f" {cum}")
                cum += h[len(bounds)]
                lines.append(
                    f"{_labeled(name + '_bucket', extra, ('le', '+Inf'))}"
                    f" {cum}")
                base = self._series(name, key[1])
                suffix = base[len(name):]  # "{...}" or ""
                lines.append(f"{name}_sum{suffix} {_fmt(h[-2])}")
                lines.append(f"{name}_count{suffix} {h[-1]}")
        return "\n".join(lines) + "\n"


# -- quantile math (shared by aggregate.py, serving /stats, bench.py) ----


def quantile(samples, q: float) -> float:
    """The ``q``-quantile (``0 <= q <= 1``) of raw samples with linear
    interpolation between order statistics — numerically identical to
    ``np.percentile(samples, 100 * q)`` so bench.py's gated numbers do
    not move when it switches over.  Empty input -> 0.0."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    h = (len(xs) - 1) * q
    lo = int(h)
    if lo >= len(xs) - 1:
        return xs[-1]
    return xs[lo] + (h - lo) * (xs[lo + 1] - xs[lo])


def histogram_quantile(hist: dict, q: float) -> float:
    """The ``q``-quantile (``0 <= q <= 1``) of a snapshot-form histogram
    (``{"buckets": {bound: n, ..., "+Inf": n}, "sum": ..., "count": ...}``).

    Exact for the fixed log2 buckets this registry uses, in the sense
    that it returns the smallest bucket upper bound whose cumulative
    count reaches ``q * count`` — every observation in a bucket is ``<=``
    that bound, so the reported value is a true upper bound on the real
    quantile with at most one bucket (2x) of slack, and merged per-rank
    histograms give the same answer as one gang-wide histogram would.
    Mass landing in ``+Inf`` reports the last finite bound (the result
    must stay JSON-serializable).  Empty histogram -> 0.0."""
    buckets = hist.get("buckets", {})
    bounds = sorted((float(b), int(n)) for b, n in buckets.items()
                    if b not in ("+Inf", "inf"))
    total = sum(n for _, n in bounds)
    total += int(buckets.get("+Inf", buckets.get("inf", 0)))
    if total <= 0 or not bounds:
        return 0.0
    target = q * float(total)
    cum = 0
    for b, n in bounds:
        cum += n
        if cum >= target and cum > 0:
            return b
    return bounds[-1][0]


def _fmt(v) -> str:
    """Prometheus-friendly number: integral floats print without the
    trailing ``.0`` (``le="256"`` not ``le="256.0"``)."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _labeled(name: str, pairs: list, *extra: tuple) -> str:
    inner = ",".join(f'{k}="{v}"' for k, v in list(pairs) + list(extra))
    return f"{name}{{{inner}}}"


# -- module-level hooks (the instrumentation surface) ---------------------
#
# Exactly the fault_injection._PLAN shape: one global, checked inline.
# When telemetry is off, _REG is None and every hook is load+test+return.

_REG: Optional[Registry] = None


def enabled() -> bool:
    return _REG is not None


def inc_counter(name: str, value: float = 1.0, labels: tuple = ()) -> None:
    reg = _REG
    if reg is None:
        return
    reg.inc_counter(name, value, labels)


def set_gauge(name: str, value: float, labels: tuple = ()) -> None:
    reg = _REG
    if reg is None:
        return
    reg.set_gauge(name, value, labels)


def observe(name: str, value: float, labels: tuple = ()) -> None:
    reg = _REG
    if reg is None:
        return
    reg.observe(name, value, labels)


def configure(on: bool = True) -> None:
    """Turn the registry on/off.  Turning on when already on keeps the
    existing series (an elastic re-form re-initializes the engine in the
    same process; counters must survive it)."""
    global _REG
    if on:
        if _REG is None:
            _REG = Registry()
    else:
        _REG = None


def get() -> Optional[Registry]:
    return _REG


def snapshot() -> dict:
    reg = _REG
    return reg.snapshot() if reg is not None else {}


def render_prometheus() -> str:
    reg = _REG
    return reg.render_prometheus() if reg is not None else ""


def known_metrics() -> Dict[str, dict]:
    """Registry accessor for tools/check_metric_docs.py."""
    return dict(KNOWN_METRICS)
