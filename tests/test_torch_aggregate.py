"""The port's gang fold and alerts (``horovod_tpu_torch/telemetry/
aggregate.py``) against the JAX package's.

* The same fixed per-rank records in a KV give the same view from both
  packages' ``GangAggregator.poll_once``: counters summed, gauges per rank
  with min, median and max, histograms merged bucket by bucket with their
  p50 and p99, and ``stale_ranks`` for a missing, torn or old-epoch record,
  a KV that raises and the ``agg.scrape`` fault site; the same Prometheus
  text of the view.
* The five alert rules fire on the same folds of the same sequences, with
  the same ``hvd_alerts_total`` and the same health.
* Mixed gangs of three, both ways (``tests/torch_port_engine_worker.py
  gang_view``, ``HVD_METRICS_PORT`` and the flusher's KV publication on):
  the root's ``/gang/metrics.json`` folds the other package's ranks, its
  ``hvd_collectives_total`` the sum of the folded ranks' own snapshots; in
  the port-rooted gang an ``agg.scrape`` fault on rank 2 makes it stale,
  and nothing raises.
"""

import json
import os
import socket
import time

import pytest

from horovod_tpu.common import fault_injection as jfi
from horovod_tpu.telemetry import aggregate as jagg
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu_torch.common import fault_injection as pfi
from horovod_tpu_torch.telemetry import aggregate as pagg
from horovod_tpu_torch.telemetry import registry as preg

from test_torch_engine import _finish, _start


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in list(os.environ):
        if var.startswith("HVD_ALERT_") or var == "HVD_AGG_INTERVAL":
            monkeypatch.delenv(var)
    for reg, fi in ((preg, pfi), (jreg, jfi)):
        reg.configure(False)
        fi.clear()
    yield
    for reg, fi in ((preg, pfi), (jreg, jfi)):
        reg.configure(False)
        fi.clear()


class _KV:
    def __init__(self, data=None, boom=False):
        self.data = dict(data or {})
        self.puts = {}
        self.boom = boom

    def get(self, key):
        if self.boom:
            raise ConnectionError("kv down")
        return self.data.get(key)

    def put(self, key, value):
        self.puts[key] = value


def _record(rank, step, epoch=0, straggler=0.0, queue=0, retries=0,
            serve_s=0.001, rate=100):
    """One rank's flushed record after ``step`` folds: a fresh registry fed
    a deterministic history."""
    reg = jreg.Registry()
    reg.inc_counter("hvd_collectives_total", float(rate * step),
                    ("allreduce", "float32"))
    reg.inc_counter("hvd_cycles_total", float(10 * step + rank))
    reg.set_gauge("hvd_queue_depth", float(queue))
    reg.set_gauge("hvd_trace_clock_skew_seconds", 0.001 * rank)
    if retries:
        reg.inc_counter("hvd_hop_retries_total", float(retries),
                        ("corrupt",))
    for i in range(step):
        reg.observe("hvd_collective_latency_seconds",
                    0.002 * (1 + (i + rank) % 5), ("allreduce", "float32"))
        reg.observe("hvd_ring_hop_seconds", 0.0007 * (1 + i % 3),
                    ("reduce_scatter",))
        if rank == 0:
            reg.observe("hvd_serve_token_latency_seconds", serve_s)
            if straggler:
                reg.observe("hvd_straggler_skew_seconds", straggler,
                            ("2",))
    return {"rank": rank, "seq": step, "epoch": epoch, **reg.snapshot()}


def _view_json(view):
    return json.loads(json.dumps(view))


def _poll_both(kvs, size, now, aggs, epoch=0):
    out = []
    for mod in (pagg, jagg):
        agg = aggs.setdefault(mod, mod.GangAggregator(
            size, kv=kvs[mod], interval_s=999.0, epoch=epoch))
        out.append(_view_json(agg.poll_once(now=now)))
    return out


def test_fold_and_degrade_equal_jax():
    recs = {f"metrics/{r}": json.dumps(_record(r, 5, epoch=1))
            for r in range(5)}
    recs["metrics/1"] = json.dumps(_record(1, 5, epoch=0))  # old epoch
    recs["metrics/2"] = '{"rank": 2, "coun'                 # torn
    del recs["metrics/3"]                                   # missing
    kvs = {pagg: _KV(recs), jagg: _KV(recs)}
    port, jax = _poll_both(kvs, 5, 1.0, {}, epoch=1)
    assert port == jax
    assert port["stale_ranks"] == [1, 2, 3] and port["ranks"] == [0, 4]
    assert port["counters"][
        'hvd_collectives_total{op="allreduce",dtype="float32"}'] == 1000
    g = port["gauges"]["hvd_trace_clock_skew_seconds"]
    assert g["per_rank"] == {"0": 0.0, "4": 0.004} and g["max"] == 0.004
    h = port["histograms"][
        'hvd_collective_latency_seconds{op="allreduce",dtype="float32"}']
    assert h["count"] == 10 and h["p50"] > 0
    assert kvs[pagg].puts["gang/metrics"] == kvs[jagg].puts["gang/metrics"]
    # The Prometheus text of the same view, byte for byte.
    assert pagg.render_prometheus(port) == jagg.render_prometheus(jax)
    # An agg.scrape fault and a KV that raises degrade, never raise.
    for fi in (pfi, jfi):
        fi.configure({"faults": [{"site": "agg.scrape", "kind": "error",
                                  "match": "4"}]})
    port, jax = _poll_both(kvs, 5, 2.0, {}, epoch=1)
    assert port == jax and port["stale_ranks"] == [1, 2, 3, 4]
    boom = {pagg: _KV(boom=True), jagg: _KV(boom=True)}
    port, jax = _poll_both(boom, 3, 1.0, {})
    assert port == jax and port["stale_ranks"] == [0, 1, 2]


def _sequence(n_polls, size=3):
    """Per-poll record sets: a steady warmup, then every rule's breach."""
    out = []
    total = {r: 0 for r in range(size)}
    for i in range(n_polls):
        late = i >= 6
        recs = {}
        for r in range(size):
            total[r] += 5 if (late and i == 6) else 100
            reg = _record(r, i + 1, rate=0,
                          straggler=(0.5 if late else 0.01),
                          queue=(40 if late and r == 1 else 1),
                          retries=(100 * i if late else 0),
                          serve_s=(0.9 if late else 0.001))
            reg["counters"][
                'hvd_collectives_total{op="allreduce",dtype="float32"}'] = \
                float(total[r])
            recs[f"metrics/{r}"] = json.dumps(reg)
        out.append(recs)
    return out


def test_alert_rules_fire_the_same(monkeypatch):
    monkeypatch.setenv("HVD_ALERT_SERVE_P99_MS", "100")
    monkeypatch.setenv("HVD_ALERT_WARMUP", "2")
    preg.configure(True)
    jreg.configure(True)
    kvs = {pagg: _KV(), jagg: _KV()}
    aggs = {}
    fired = set()
    for i, recs in enumerate(_sequence(9)):
        for kv in kvs.values():
            kv.data = recs
        port, jax = _poll_both(kvs, 3, float(i), aggs)
        assert port == jax, i
        fired |= {a["rule"] for a in port["alerts"]}
        assert aggs[pagg].health() == aggs[jagg].health()
    assert fired == set(pagg.ALERT_RULES) == set(jagg.ALERT_RULES)
    pc = {k: v for k, v in preg.snapshot()["counters"].items()
          if k.startswith("hvd_alerts_total")}
    jc = {k: v for k, v in jreg.snapshot()["counters"].items()
          if k.startswith("hvd_alerts_total")}
    assert pc == jc and len(pc) == 5
    assert aggs[pagg].health()["status"] == "alerting"


def test_endpoints_serve_the_live_fold():
    from horovod_tpu_torch.telemetry import server as pserver

    preg.configure(True)
    recs = {f"metrics/{r}": json.dumps(_record(r, 3)) for r in range(2)}
    agg = pagg.GangAggregator(2, kv=_KV(recs), interval_s=999.0)
    agg.poll_once(now=1.0)
    pagg.configure(agg)
    srv = pserver.MetricsServer(host="127.0.0.1", port=0)
    port = srv.start()
    try:
        import urllib.request

        base = f"http://127.0.0.1:{port}"
        view = json.load(urllib.request.urlopen(base + "/gang/metrics.json"))
        assert view == _view_json(agg.view())
        assert json.load(urllib.request.urlopen(
            base + "/gang/health"))["status"] == "ok"
        text = urllib.request.urlopen(base + "/gang/metrics").read().decode()
        assert text == agg.render()
    finally:
        srv.stop()
        pagg.configure(None)


# ---------------------------------------------------------------------------
# mixed gangs: each package's root folds the other's ranks
# ---------------------------------------------------------------------------

GANGS = {
    "jax_root": ["jax", "port-nogroup", "port-nogroup"],
    "port_root": ["port-nogroup", "jax", "jax"],
}
SCRAPE_FAULT = json.dumps({"faults": [
    {"site": "agg.scrape", "kind": "error", "match": "2"}]})


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    root = tmp_path_factory.mktemp("agg_gangs")
    started = {}
    for name, pkgs in GANGS.items():
        d = str(root / name)
        base = _free_port()

        def env(r, name=name, base=base):
            e = {"HVD_METRICS_PORT": str(base), "HVD_METRICS_INTERVAL": "0.2",
                 "HVD_AGG_INTERVAL": "0.2"}
            if name == "port_root" and r == 0:
                e["HOROVOD_FAULT_PLAN"] = SCRAPE_FAULT
            return e

        started[name] = _start(pkgs, ["gang_view"], d, env)
    deadline = time.monotonic() + 90.0
    out = {}
    for name, (server, procs) in started.items():
        runs = _finish(server, procs, deadline)
        d = root / name
        view = json.loads((d / "gang_view.json").read_text()) \
            if (d / "gang_view.json").exists() else {}
        snaps = [json.loads((d / f"snap{r}.json").read_text())
                 if (d / f"snap{r}.json").exists() else {}
                 for r in range(3)]
        out[name] = (runs, view, snaps)
    return out


@pytest.mark.parametrize("name", list(GANGS))
def test_root_folds_the_other_package(views, name):
    runs, view, snaps = views[name]
    for r, (code, text) in enumerate(runs):
        assert code == 0 and "SCENARIO_OK gang_view" in text, \
            f"rank {r} (exit {code}):\n{text[-3000:]}"
    fold = view["/gang/metrics.json"]
    want_stale = [2] if name == "port_root" else []
    assert fold["stale_ranks"] == want_stale, fold["stale_ranks"]
    folded = [r for r in range(3) if r not in want_stale]
    assert fold["ranks"] == folded
    assert view["/gang/health"]["stale_ranks"] == want_stale
    key = 'hvd_collectives_total{op="allreduce",dtype="bfloat16"}'
    assert fold["counters"][key] == sum(
        snaps[r]["counters"][key] for r in folded) == 3 * len(folded)
    total = sum(v for k, v in fold["counters"].items()
                if k.startswith("hvd_collectives_total"))
    assert total == sum(
        v for r in folded for k, v in snaps[r]["counters"].items()
        if k.startswith("hvd_collectives_total"))
    assert "hvd_cycles_total" in view["/gang/metrics"]
