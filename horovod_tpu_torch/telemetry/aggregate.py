"""Gang-wide telemetry aggregation and streaming anomaly alerts: the port
of ``horovod_tpu/telemetry/aggregate.py``.

Every rank already exports a full snapshot (per-rank ``/metrics``, the
JSONL flusher, the KV publication under ``metrics/<rank>``); this module
is the coordinator-side fold that turns them into ONE gang view — the
online half of the offline timeline/stall analysis, run continuously:

- counters are summed across ranks,
- gauges keep their per-rank values plus min/median/max rollups,
- histograms merge *exactly* bucket-by-bucket (the registry's fixed log2
  bounds line up across ranks by construction), so the gang-wide
  p50/p99 of ``hvd_ring_hop_seconds``, ``hvd_collective_latency_seconds``
  and the serve SLO histograms are real quantiles, not averages of
  per-rank averages.

The fold reads each rank's newest flushed record from the rendezvous KV
(``metrics/<rank>``) first and falls back to scraping the rank's own
debug server (``/metrics.json`` at the address the record advertises).
A missing, torn, or old-epoch record and an unreachable scrape degrade
that rank to ``stale_ranks`` — never an exception, never a hung fold
(chaos site ``agg.scrape``).  The result is served by the rank-0 debug
server as ``GET /gang/metrics`` (Prometheus text), ``/gang/metrics.json``
and ``/gang/health``, and mirrored into the KV under ``gang/metrics``
for the fleet router.

On top of the stream, an anomaly engine evaluates EWMA-based rules each
fold (``ALERT_RULES``; knobs ``HVD_ALERT_*`` in utils/env.py).  A rule's
rising edge emits an ``ALERT`` timeline record, a blackbox event, and
``hvd_alerts_total{rule}`` — so a throughput regression fires during
warmup steps, online, instead of days later in an offline bench diff.

Zero-cost when off: with ``HVD_METRICS`` unset nothing here is imported
on any hot path, no thread starts, and no clock is read — pinned by
tests/test_torch_aggregate.py the same way the registry hooks are.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.telemetry import registry as _reg
from horovod_tpu_torch.utils import env as _env

log = logging.getLogger("horovod_tpu_torch.telemetry")

# Every rule the anomaly engine can fire, in evaluation order.  Each
# name must appear in the docs/metrics.md rule table
# (tools/check_metric_docs.py enforces it, like the metric registry).
ALERT_RULES = (
    "throughput_collapse",
    "straggler_skew",
    "queue_growth",
    "retry_spike",
    "serve_p99_breach",
)

# A scrape must never hang the fold: the KV client has its own retry
# deadline, and the direct HTTP fallback gets this socket timeout.
_SCRAPE_TIMEOUT_S = 1.0

# Absolute floors below which the growth rules (queue_growth,
# retry_spike) never fire — a queue going 0 -> 2 or one stray KV retry
# is noise, not an anomaly.
_QUEUE_FLOOR = 4
_RETRY_FLOOR = 4.0

_RANK_LABEL_RE = re.compile(r'rank="([^"]+)"')


# -- pure fold machinery (no clocks, no I/O; unit-tested directly) --------


def _matches(series: str, name: str) -> bool:
    return series == name or series.startswith(name + "{")


def _sum_series(table: Dict[str, float], name: str) -> float:
    return sum(v for k, v in table.items() if _matches(k, name))


def merge_histograms(hists: List[dict]) -> dict:
    """Exact bucket-by-bucket merge of snapshot-form histograms with
    identical bounds (the registry guarantees that per metric name)."""
    buckets: Dict[str, int] = {}
    total_sum = 0.0
    count = 0
    for h in hists:
        for b, n in h.get("buckets", {}).items():
            buckets[b] = buckets.get(b, 0) + int(n)
        total_sum += float(h.get("sum", 0.0))
        count += int(h.get("count", 0))
    return {"buckets": buckets, "sum": total_sum, "count": count}


def _merged_series(hists: Dict[str, dict], name: str) -> dict:
    return merge_histograms(
        [h for k, h in hists.items() if _matches(k, name)])


def hist_delta(cur: dict, prev: Optional[dict]) -> dict:
    """The observations ``cur`` gained since ``prev`` (bucketwise; a
    counter reset clamps to the current value instead of going
    negative)."""
    if not prev:
        return dict(cur, buckets=dict(cur.get("buckets", {})))
    pb = prev.get("buckets", {})
    buckets = {b: max(0, int(n) - int(pb.get(b, 0)))
               for b, n in cur.get("buckets", {}).items()}
    return {
        "buckets": buckets,
        "sum": max(0.0, float(cur.get("sum", 0.0))
                   - float(prev.get("sum", 0.0))),
        "count": max(0, int(cur.get("count", 0))
                     - int(prev.get("count", 0))),
    }


def fold(snaps: Dict[int, dict]) -> dict:
    """Fold per-rank registry snapshots into the gang view: counters
    summed, gauges per-rank + min/median/max, histograms merged exactly
    with gang-wide p50/p99 attached.  Pure — callers own staleness,
    rates, and alerting."""
    counters: Dict[str, float] = {}
    gauge_ranks: Dict[str, Dict[int, float]] = {}
    hists: Dict[str, List[dict]] = {}
    for rank in sorted(snaps):
        snap = snaps[rank]
        for k, v in snap.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + float(v)
        for k, v in snap.get("gauges", {}).items():
            gauge_ranks.setdefault(k, {})[rank] = float(v)
        for k, h in snap.get("histograms", {}).items():
            hists.setdefault(k, []).append(h)
    gauges = {}
    for k, per in sorted(gauge_ranks.items()):
        vals = sorted(per.values())
        gauges[k] = {
            "per_rank": {str(r): per[r] for r in sorted(per)},
            "min": vals[0],
            "median": _reg.quantile(vals, 0.5),
            "max": vals[-1],
        }
    histograms = {}
    for k, hs in sorted(hists.items()):
        merged = merge_histograms(hs)
        merged["p50"] = _reg.histogram_quantile(merged, 0.50)
        merged["p99"] = _reg.histogram_quantile(merged, 0.99)
        histograms[k] = merged
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


def _with_rank(series: str, rank: str) -> str:
    if series.endswith("}"):
        return f'{series[:-1]},rank="{rank}"}}'
    return f'{series}{{rank="{rank}"}}'


def render_prometheus(view: dict) -> str:
    """Prometheus text exposition (v0.0.4) of a gang view: counters are
    the gang sums, gauges fan out per rank via an injected ``rank``
    label, histograms are the exact merges."""
    lines: List[str] = []

    def _header(base: str, kind: str) -> None:
        spec = _reg.KNOWN_METRICS.get(base)
        if spec is not None:
            lines.append(f"# HELP {base} {spec['help']}")
        lines.append(f"# TYPE {base} {kind}")

    seen = set()
    for key in sorted(view.get("counters", {})):
        base = key.split("{", 1)[0]
        if base not in seen:
            seen.add(base)
            _header(base, "counter")
        lines.append(f"{key} {_reg._fmt(view['counters'][key])}")
    for key in sorted(view.get("gauges", {})):
        base = key.split("{", 1)[0]
        if base not in seen:
            seen.add(base)
            _header(base, "gauge")
        for r, v in view["gauges"][key]["per_rank"].items():
            lines.append(f"{_with_rank(key, r)} {_reg._fmt(v)}")
    for key in sorted(view.get("histograms", {})):
        base = key.split("{", 1)[0]
        if base not in seen:
            seen.add(base)
            _header(base, "histogram")
        h = view["histograms"][key]
        finite = sorted(
            ((float(b), n) for b, n in h["buckets"].items()
             if b != "+Inf"))
        cum = 0
        suffix = key[len(base):]
        for b, n in finite:
            cum += n
            le = _reg._fmt(b)
            inner = (suffix[1:-1] + "," if suffix else "") + f'le="{le}"'
            lines.append(f"{base}_bucket{{{inner}}} {cum}")
        cum += h["buckets"].get("+Inf", 0)
        inner = (suffix[1:-1] + "," if suffix else "") + 'le="+Inf"'
        lines.append(f"{base}_bucket{{{inner}}} {cum}")
        lines.append(f"{base}_sum{suffix} {_reg._fmt(h['sum'])}")
        lines.append(f"{base}_count{suffix} {h['count']}")
    return "\n".join(lines) + "\n"


# -- anomaly engine -------------------------------------------------------


class _Ewma:
    """Trailing baseline: ``n`` counts the folds observed (the warmup
    gate), ``value`` the exponentially weighted mean."""

    __slots__ = ("alpha", "value", "n")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.value: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> None:
        self.n += 1
        if self.value is None:
            self.value = float(x)
        else:
            self.value += self.alpha * (float(x) - self.value)

    def ready(self, warmup: int) -> bool:
        return self.value is not None and self.n >= warmup


class GangAggregator:
    """Coordinator-side fold of every rank's metrics snapshot into one
    gang view, plus the streaming anomaly engine.

    ``poll_once`` is the synchronous unit the daemon thread loops on,
    exposed for tests (pass ``now`` for deterministic interval rates).
    """

    def __init__(self, size: int, kv=None,
                 scrape_addrs: Optional[Dict[int, str]] = None,
                 interval_s: Optional[float] = None, epoch: int = 0,
                 check_epoch: bool = True):
        self.size = int(size)
        self.kv = kv
        self.interval_s = (interval_s if interval_s is not None
                           else _env.agg_interval_s())
        self.epoch = int(epoch)
        self.check_epoch = check_epoch
        self._addrs: Dict[int, str] = dict(scrape_addrs or {})
        self._lock = threading.Lock()
        self._view: dict = {}
        self._prev_snaps: Dict[int, dict] = {}
        self._prev_t: Optional[float] = None
        self._seq = 0
        self._warned: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Anomaly state: one EWMA per rule stream (straggler_skew keys
        # per rank), active-breach map for edge detection.
        self._alpha = _env.alert_ewma_alpha()
        self._warmup = _env.alert_warmup()
        self._ewma: Dict[str, _Ewma] = {}
        self._active: Dict[str, dict] = {}

    # -- per-rank snapshot acquisition -----------------------------------

    def _read_rank(self, rank: int) -> Optional[dict]:
        """The rank's newest snapshot record, or ``None`` (-> stale).
        KV ``metrics/<rank>`` first; direct ``/metrics.json`` scrape of
        the rank's debug server second.  Never raises, never hangs."""
        try:
            _fi.fire("agg.scrape", str(rank))
        except Exception:
            return None
        rec = None
        if self.kv is not None:
            try:
                raw = self.kv.get(f"metrics/{rank}")
            except Exception:
                raw = None
            if raw:
                try:
                    rec = json.loads(raw)
                except ValueError:
                    rec = None  # torn write
        if isinstance(rec, dict) and rec.get("scrape"):
            self._addrs[rank] = str(rec["scrape"])
        if isinstance(rec, dict) and self.check_epoch and \
                "epoch" in rec and int(rec["epoch"]) != self.epoch:
            rec = None  # a pre-re-form incarnation's numbers
        if not isinstance(rec, dict) or "counters" not in rec:
            rec = self._scrape(rank)
        return rec if isinstance(rec, dict) else None

    def _scrape(self, rank: int) -> Optional[dict]:
        addr = self._addrs.get(rank)
        if not addr:
            return None
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/metrics.json",
                    timeout=_SCRAPE_TIMEOUT_S) as resp:
                snap = json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None
        if not isinstance(snap, dict) or "counters" not in snap:
            return None
        return {"rank": rank, **snap}

    # -- the fold --------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> dict:
        t0 = time.monotonic()
        if now is None:
            now = t0
        snaps: Dict[int, dict] = {}
        stale: List[int] = []
        for r in range(self.size):
            rec = self._read_rank(r)
            if rec is None:
                stale.append(r)
            else:
                snaps[r] = rec
        view = fold(snaps)
        dt = (now - self._prev_t) if self._prev_t is not None else None
        rows = self._per_rank_rows(snaps, stale, dt)
        self._evaluate_rules(snaps, rows, dt)
        for row in rows:
            row["alerts"] = sorted(
                rule for rule, info in self._active.items()
                if info.get("rank") == row["rank"])
        self._seq += 1
        view.update({
            "seq": self._seq,
            "epoch": self.epoch,
            "size": self.size,
            "ranks": sorted(snaps),
            "stale_ranks": stale,
            "per_rank": rows,
            "alerts": [dict(info, rule=rule) for rule, info
                       in sorted(self._active.items())],
        })
        _reg.set_gauge("hvd_gang_stale_ranks", len(stale))
        with self._lock:
            self._view = view
            self._prev_snaps = snaps
            self._prev_t = now
        if self.kv is not None:
            try:
                self.kv.put("gang/metrics", json.dumps(view))
            except Exception as e:
                self._warn_once("mirror", str(e))
        _reg.observe("hvd_gang_agg_fold_seconds", time.monotonic() - t0)
        return view

    def _per_rank_rows(self, snaps: Dict[int, dict], stale: List[int],
                       dt: Optional[float]) -> List[dict]:
        """The hvd_top table: one row per rank with interval step rate,
        collective p50/p99, straggler skew, transport bytes, and queue
        depth."""
        skew_ms = self._skew_by_rank(snaps)
        rows = []
        for r in range(self.size):
            if r in stale:
                rows.append({"rank": r, "stale": True, "step_rate": 0.0,
                             "coll_p50_ms": 0.0, "coll_p99_ms": 0.0,
                             "skew_ms": 0.0, "transport_mb": 0.0,
                             "queue": 0, "alerts": []})
                continue
            snap = snaps[r]
            counters = snap.get("counters", {})
            gauges = snap.get("gauges", {})
            hists = snap.get("histograms", {})
            coll = _sum_series(counters, "hvd_collectives_total")
            prev = self._prev_snaps.get(r)
            rate = 0.0
            if dt and prev is not None:
                prev_coll = _sum_series(prev.get("counters", {}),
                                        "hvd_collectives_total")
                rate = max(0.0, coll - prev_coll) / dt
            lat = _merged_series(hists, "hvd_collective_latency_seconds")
            if prev is not None:
                lat_d = hist_delta(lat, _merged_series(
                    prev.get("histograms", {}),
                    "hvd_collective_latency_seconds"))
                if lat_d["count"]:
                    lat = lat_d
            rows.append({
                "rank": r,
                "stale": False,
                "step_rate": round(rate, 2),
                "coll_p50_ms": round(
                    1e3 * _reg.histogram_quantile(lat, 0.50), 3),
                "coll_p99_ms": round(
                    1e3 * _reg.histogram_quantile(lat, 0.99), 3),
                "skew_ms": round(skew_ms.get(r, 0.0), 3),
                "transport_mb": round(_sum_series(
                    counters, "hvd_transport_bytes_total") / 1e6, 3),
                "queue": int(gauges.get("hvd_queue_depth", 0)
                             + gauges.get("hvd_serve_queue_depth", 0)),
                "alerts": [],
            })
        return rows

    def _skew_by_rank(self, snaps: Dict[int, dict]) -> Dict[int, float]:
        """Interval mean negotiation skew per implicated rank, in ms,
        from the coordinator's labeled ``hvd_straggler_skew_seconds``
        histogram (the straggler detector runs on rank 0 only)."""
        snap = snaps.get(0)
        if snap is None:
            return {}
        prev = self._prev_snaps.get(0) or {}
        out: Dict[int, float] = {}
        for k, h in snap.get("histograms", {}).items():
            if not _matches(k, "hvd_straggler_skew_seconds"):
                continue
            m = _RANK_LABEL_RE.search(k)
            if m is None:
                continue
            d = hist_delta(h, prev.get("histograms", {}).get(k))
            use = d if d["count"] else h
            if use["count"]:
                out[int(m.group(1))] = 1e3 * use["sum"] / use["count"]
        return out

    # -- anomaly rules ---------------------------------------------------

    def _stream(self, key: str) -> _Ewma:
        e = self._ewma.get(key)
        if e is None:
            e = self._ewma[key] = _Ewma(self._alpha)
        return e

    def _check(self, key: str, value: float, breach) -> Tuple[bool, float]:
        """Evaluate ``value`` against the stream's pre-update baseline;
        a breach freezes the baseline (a collapsed interval must not
        drag the EWMA down to meet it).  Returns (breached, baseline)."""
        e = self._stream(key)
        if e.ready(self._warmup) and breach(value, e.value):
            return True, e.value
        e.update(value)
        return False, e.value if e.value is not None else value

    def _evaluate_rules(self, snaps: Dict[int, dict], rows: List[dict],
                        dt: Optional[float]) -> None:
        breaches: Dict[str, dict] = {}

        if dt and dt > 0:
            # throughput_collapse: gang collective rate vs baseline;
            # names the slowest rank.
            rates = {row["rank"]: row["step_rate"] for row in rows
                     if not row["stale"]}
            gang_rate = sum(rates.values())
            frac = _env.alert_collapse_frac()
            hit, base = self._check(
                "throughput", gang_rate,
                lambda v, b: b > 0 and v < frac * b)
            if hit:
                slowest = min(rates, key=rates.get) if rates else -1
                breaches["throughput_collapse"] = {
                    "rank": slowest, "value": round(gang_rate, 2),
                    "baseline": round(base, 2)}

            # retry_spike: gang-wide ladder + KV retry count this fold.
            retries = 0.0
            for snap in snaps.values():
                c = snap.get("counters", {})
                retries += (_sum_series(c, "hvd_kv_retries_total")
                            + _sum_series(c, "hvd_hop_retries_total"))
            prev_retries = 0.0
            for snap in self._prev_snaps.values():
                c = snap.get("counters", {})
                prev_retries += (
                    _sum_series(c, "hvd_kv_retries_total")
                    + _sum_series(c, "hvd_hop_retries_total"))
            d_retries = max(0.0, retries - prev_retries)
            rfac = _env.alert_retry_factor()
            hit, base = self._check(
                "retry", d_retries,
                lambda v, b: v >= _RETRY_FLOOR and v > rfac * max(b, 1.0))
            if hit:
                breaches["retry_spike"] = {
                    "rank": -1, "value": d_retries,
                    "baseline": round(base, 2)}

        # straggler_skew: per implicated rank, interval mean skew vs
        # that rank's own baseline, gated by the absolute floor.
        sfac = _env.alert_skew_factor()
        floor = _env.alert_skew_floor_ms()
        worst = None
        for row in rows:
            if row["stale"] or row["skew_ms"] <= 0:
                continue
            hit, base = self._check(
                f"skew/{row['rank']}", row["skew_ms"],
                lambda v, b: v > floor and v > sfac * max(b, 1e-9))
            if hit and (worst is None or row["skew_ms"] > worst["value"]):
                worst = {"rank": row["rank"], "value": row["skew_ms"],
                         "baseline": round(base, 3)}
        if worst is not None:
            breaches["straggler_skew"] = worst

        # queue_growth: deepest admission queue across ranks.
        depths = {row["rank"]: row["queue"] for row in rows
                  if not row["stale"]}
        if depths:
            deepest = max(depths, key=depths.get)
            qfac = _env.alert_queue_factor()
            hit, base = self._check(
                "queue", float(depths[deepest]),
                lambda v, b: v >= _QUEUE_FLOOR and v > qfac * max(b, 1.0))
            if hit:
                breaches["queue_growth"] = {
                    "rank": deepest, "value": depths[deepest],
                    "baseline": round(base, 2)}

        # serve_p99_breach: fixed SLO ceiling on the interval's merged
        # decode-step p99 (0 = off; no baseline needed).
        slo_ms = _env.alert_serve_p99_ms()
        if slo_ms > 0:
            cur = fold(snaps)["histograms"].get(
                "hvd_serve_token_latency_seconds")
            prev = fold(self._prev_snaps)["histograms"].get(
                "hvd_serve_token_latency_seconds") \
                if self._prev_snaps else None
            if cur is not None:
                d = hist_delta(cur, prev)
                use = d if d["count"] else cur
                p99_ms = 1e3 * _reg.histogram_quantile(use, 0.99)
                if use["count"] and p99_ms > slo_ms:
                    breaches["serve_p99_breach"] = {
                        "rank": 0, "value": round(p99_ms, 3),
                        "baseline": slo_ms}

        for rule, info in breaches.items():
            if rule not in self._active:  # rising edge
                self._fire(rule, info)
            info["since_seq"] = self._active.get(
                rule, {}).get("since_seq", self._seq + 1)
        self._active = {rule: info for rule, info in breaches.items()}

    def _fire(self, rule: str, info: dict) -> None:
        from horovod_tpu_torch.telemetry import blackbox as _bb
        from horovod_tpu_torch.utils import timeline as _tl

        _reg.inc_counter("hvd_alerts_total", labels=(rule,))
        _tl.engine_event(_tl.ALERT, rule=rule, rank=info["rank"],
                         value=info["value"], baseline=info["baseline"])
        _bb.note("alert", 0, rule=rule, rank=info["rank"],
                 value=info["value"])
        log.warning("gang alert: %s (rank %s, value %s, baseline %s)",
                    rule, info["rank"], info["value"], info["baseline"])

    # -- serving surface -------------------------------------------------

    def view(self) -> dict:
        with self._lock:
            return self._view

    def health(self) -> dict:
        with self._lock:
            view = self._view
        alerts = view.get("alerts", [])
        stale = view.get("stale_ranks", [])
        status = "ok"
        if stale:
            status = "degraded"
        if alerts:
            status = "alerting"
        return {"status": status, "seq": view.get("seq", 0),
                "epoch": self.epoch, "size": self.size,
                "stale_ranks": stale, "alerts": alerts}

    def render(self) -> str:
        return render_prometheus(self.view())

    # -- lifecycle -------------------------------------------------------

    def _warn_once(self, kind: str, detail: str) -> None:
        if kind not in self._warned:
            self._warned.add(kind)
            log.warning("gang aggregator (%s) failing: %s", kind, detail)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception as e:  # observability never kills training
                self._warn_once("fold", repr(e))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="hvd-gang-agg", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- module surface (the blackbox.get() pattern: one global, the debug
#    server reaches the live aggregator through it) -----------------------

_AGG: Optional[GangAggregator] = None


def get() -> Optional[GangAggregator]:
    return _AGG


def configure(agg: Optional[GangAggregator]) -> None:
    global _AGG
    _AGG = agg


def start_from_env(size: int, kv=None) -> Optional[GangAggregator]:
    """Rank-0 hook: build, register, and start the aggregator thread.
    Idempotent across elastic re-entry (a live aggregator is kept)."""
    global _AGG
    if _AGG is not None:
        return _AGG
    epoch = _env.get_int(_env.ELASTIC_EPOCH, 0)
    agg = GangAggregator(size, kv=kv, epoch=epoch)
    _AGG = agg
    agg.start()
    return agg


def stop() -> None:
    global _AGG
    agg = _AGG
    _AGG = None
    if agg is not None:
        agg.stop()
