"""The port's telemetry (``horovod_tpu_torch/telemetry/``) against the JAX
package's.

* The registry: ``known_metrics()`` is the JAX table; the same seeded
  script of observations gives the same ``snapshot()`` and the same
  Prometheus text, byte for byte; ``quantile`` and ``histogram_quantile``
  give the same values.
* The JAX package's unit cases (``tests/test_telemetry.py``), run on both
  packages and compared: the straggler detector's streaks, the flusher's
  JSONL and KV records, the debug server's endpoints (with the
  ``metrics.server.request`` fault site's 503) and the env lifecycle.
* Zero cost with the knobs off: the hooks allocate nothing, the eager
  layer's wrapper is the identity, and a two-rank gang with the registry
  on sends the same frames (request and response lists, no params) as the
  JAX codecs give.
* The dtype label is numpy's name: a torch bfloat16 tensor counts under
  ``dtype="bfloat16"``.
* A gang check: a port gang and a JAX gang of three run the same scripted
  workload (``tests/torch_port_engine_worker.py metrics``) with
  ``HVD_METRICS_FILE``; the series that do not depend on timing agree
  exactly: ``hvd_collectives_total`` and the ``hvd_collective_bytes``
  counts and sums per op and dtype, ``hvd_cache_hits_total``,
  ``hvd_cache_misses_total``, ``hvd_evictions_total`` and
  ``hvd_collective_timeouts_total``.
"""

import gc
import json
import logging
import os
import pickle
import socket
import time
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu import telemetry as jtel
from horovod_tpu.common import fault_injection as jfi
from horovod_tpu.telemetry import flush as jflush
from horovod_tpu.telemetry import registry as jtmx
from horovod_tpu.telemetry import straggler as jstr
from horovod_tpu_torch import telemetry as ptel
from horovod_tpu_torch.common import fault_injection as pfi
from horovod_tpu_torch.telemetry import flush as pflush
from horovod_tpu_torch.telemetry import registry as ptmx
from horovod_tpu_torch.telemetry import server as pserver
from horovod_tpu_torch.telemetry import straggler as pstr

from test_torch_engine import _finish, _start

PKGS = {"port": (ptel, ptmx, pstr, pflush, pfi),
        "jax": (jtel, jtmx, jstr, jflush, jfi)}


@pytest.fixture(autouse=True)
def _clean():
    for tel, _, _, _, fi in PKGS.values():
        tel.reset()
        fi.clear()
    yield
    for tel, _, _, _, fi in PKGS.values():
        tel.reset()
        fi.clear()


def _both(fn):
    """``fn(tel, tmx, straggler, flush)`` on each package, fresh; returns
    (port's result, JAX's)."""
    out = []
    for name in ("port", "jax"):
        tel, tmx, stg, fl, _ = PKGS[name]
        tel.reset()
        out.append(fn(tel, tmx, stg, fl))
        tel.reset()
    return tuple(out)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_known_metrics_equal_jax():
    assert ptmx.known_metrics() == jtmx.known_metrics()
    assert len(ptmx.KNOWN_METRICS) == 45


def _script(tmx):
    """A seeded script over every declared series: counters, gauges and
    histograms with label values, values on and between bucket bounds,
    in +Inf, and negative and zero."""
    rng = np.random.default_rng(11)
    tmx.configure(True)
    for name in sorted(tmx.KNOWN_METRICS):
        spec = tmx.KNOWN_METRICS[name]
        for k in range(3):
            labels = tuple(f"{lab}{(k + j) % 2}"
                           for j, lab in enumerate(spec["labels"]))
            if spec["kind"] == "counter":
                tmx.inc_counter(name, float(rng.integers(1, 9)), labels)
            elif spec["kind"] == "gauge":
                tmx.set_gauge(name, float(rng.standard_normal()), labels)
            else:
                bounds = spec["buckets"]
                for v in (bounds[0], bounds[3], bounds[-1] * 4, 0.0,
                          float(rng.uniform(0, bounds[-1])),
                          float(bounds[5]) * 1.5):
                    tmx.observe(name, v, labels)
    return tmx.snapshot(), tmx.render_prometheus()


def test_snapshot_and_prometheus_text_equal_jax():
    port, jax = _both(lambda tel, tmx, s, f: _script(tmx))
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[1].count("# TYPE") == 45


def test_quantiles_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        xs = rng.standard_normal(n).tolist()
        for q in (0.0, 0.1, 0.5, 0.99, 1.0):
            assert ptmx.quantile(xs, q) == jtmx.quantile(xs, q)
    snap = _both(lambda tel, tmx, s, f: _script(tmx)[0])[0]
    for h in snap["histograms"].values():
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert ptmx.histogram_quantile(h, q) == \
                jtmx.histogram_quantile(h, q)
    assert ptmx.histogram_quantile({}, 0.5) == 0.0


def test_registry_rejects_like_jax():
    for tmx in (ptmx, jtmx):
        tmx.configure(True)
        with pytest.raises(KeyError):
            tmx.inc_counter("hvd_not_a_metric")
        with pytest.raises(TypeError):
            tmx.observe("hvd_cycles_total", 1.0)
        tmx.configure(False)
        assert tmx.snapshot() == {} and tmx.render_prometheus() == ""


# ---------------------------------------------------------------------------
# the straggler detector: tests/test_telemetry.py's cases on both packages
# ---------------------------------------------------------------------------


def _complete(det, key, ticks):
    for rank, t in ticks.items():
        det.note_ready(key, rank, now=t)
    return det.note_complete(key)


STRAGGLER_CASES = {
    "histogram_only": (0.0, 2, [("t%d" % i, {0: 0.0, 1: 0.5})
                                for i in range(5)]),
    "streak_fires_and_rearms": (10.0, 2, [(k, {0: 0.0, 1: 0.05})
                                          for k in "abcdef"]),
    "rank_change_resets": (10.0, 3, [
        ("a", {0: 0.0, 1: 0.05}), ("b", {0: 0.0, 1: 0.05}),
        ("c", {0: 0.05, 1: 0.0}), ("d", {0: 0.0, 1: 0.05}),
        ("e", {0: 0.0, 1: 0.05}), ("f", {0: 0.0, 1: 0.05})]),
    "under_threshold_resets": (10.0, 2, [
        ("a", {0: 0.0, 1: 0.05}), ("b", {0: 0.0, 1: 0.05}),
        ("c", {0: 0.0, 1: 0.001}), ("d", {0: 0.0, 1: 0.05}),
        ("e", {0: 0.0, 1: 0.05}), ("f", {0: 0.0, 1: 0.05})]),
    "three_ranks_mixed": (20.0, 3, [
        (f"m{i}", {0: 0.0, 1: 0.03 * (i % 3), 2: 0.025 * (i % 4)})
        for i in range(24)]),
}


@pytest.mark.parametrize("case", list(STRAGGLER_CASES))
def test_straggler_cases_equal_jax(case):
    warn, size, seq = STRAGGLER_CASES[case]

    def run(tel, tmx, stg, fl):
        tmx.configure(True)
        det = stg.StragglerDetector(warn_ms=warn, size=size)
        out = [_complete(det, k, t) for k, t in seq]
        return out, tmx.snapshot()

    port, jax = _both(run)
    assert port == jax
    fired = [x for x in port[0] if x is not None]
    if case == "streak_fires_and_rearms":
        assert [r for r, _ in fired] == [1, 1]
    if case == "histogram_only":
        assert not fired


def test_straggler_first_tick_and_forget_equal_jax():
    def run(tel, tmx, stg, fl):
        det = stg.StragglerDetector(warn_ms=10.0, size=2)
        det.note_ready("t", 0, now=0.0)
        a = det.note_complete("t")
        det.note_ready("u", 0, now=0.0)
        det.note_ready("u", 1, now=0.2)
        det.note_ready("u", 1, now=9.9)
        det.note_ready("u", 0, now=9.9)
        tmx.configure(True)
        b = det.note_complete("u")
        det.note_ready("v", 0, now=0.0)
        det.note_ready("v", 1, now=5.0)
        det.forget("v")
        return a, b, det.note_complete("v"), tmx.snapshot()

    port, jax = _both(run)
    assert port == jax
    assert port[3]["histograms"][
        'hvd_straggler_skew_seconds{rank="1"}']["sum"] == pytest.approx(0.2)


# ---------------------------------------------------------------------------
# the flusher
# ---------------------------------------------------------------------------


class _FakeKV:
    def __init__(self, fail=False):
        self.puts = []
        self.fail = fail

    def put(self, key, value):
        if self.fail:
            raise ConnectionError("kv down")
        self.puts.append((key, value))


def test_flusher_records_equal_jax(tmp_path):
    def run(tel, tmx, stg, fl):
        d = tmp_path / tel.__name__
        d.mkdir()
        path = str(d / "metrics.jsonl")
        empty = fl.Flusher(rank=3, path=path, interval_s=60.0).flush_once()
        tmx.configure(True)
        kv = _FakeKV()
        f = fl.Flusher(rank=3, path=path, interval_s=60.0, kv=kv,
                       scrape="127.0.0.1:1", epoch=0)
        tmx.inc_counter("hvd_cycles_total")
        tmx.observe("hvd_cycle_duration_seconds", 0.003)
        f.flush_once()
        tmx.inc_counter("hvd_cycles_total")
        f.start()
        f.stop()  # the final flush lands although the interval never ran
        lines = open(path).read().splitlines()
        return (empty, [json.loads(x) for x in lines],
                [(k, json.loads(v)) for k, v in kv.puts])

    port, jax = _both(run)
    assert port == jax
    empty, recs, puts = port
    assert empty is None
    assert [r["seq"] for r in recs] == [0, 1]
    assert [r["counters"]["hvd_cycles_total"] for r in recs] == [1, 2]
    assert [k for k, _ in puts] == ["metrics/3", "metrics/3"]
    assert recs[0]["scrape"] == "127.0.0.1:1" and recs[0]["epoch"] == 0


def test_flusher_kv_failure_warns_once(tmp_path, caplog):
    ptmx.configure(True)
    ptmx.inc_counter("hvd_cycles_total")
    path = str(tmp_path / "metrics.jsonl")
    fl = pflush.Flusher(rank=0, path=path, kv=_FakeKV(fail=True),
                        interval_s=60.0)
    with caplog.at_level(logging.WARNING,
                         logger="horovod_tpu_torch.telemetry"):
        fl.flush_once()
        fl.flush_once()
    assert len([r for r in caplog.records
                if "flush" in r.getMessage()]) == 1
    assert len(open(path).read().splitlines()) == 2


def test_kv_from_env_outside_a_job(monkeypatch):
    monkeypatch.delenv("HVD_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.delenv("HVD_RENDEZVOUS_PORT", raising=False)
    assert pflush.kv_from_env() is None


# ---------------------------------------------------------------------------
# the debug server and the env lifecycle
# ---------------------------------------------------------------------------


def _get(port, path, timeout=5):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_server_endpoints_and_fault_site():
    _script(jtmx)
    want_text = jtmx.render_prometheus()
    want_json = jtmx.snapshot()
    _script(ptmx)
    srv = pserver.MetricsServer(host="127.0.0.1", port=0)
    port = srv.start()
    try:
        assert _get(port, "/health").read() == b"ok"
        resp = _get(port, "/metrics")
        assert "version=0.0.4" in resp.headers["Content-Type"]
        assert resp.read().decode() == want_text
        assert json.load(_get(port, "/metrics.json")) == \
            json.loads(json.dumps(want_json))
        for path in ("/nope", "/gang/metrics"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(port, path)
            assert ei.value.code == 404
        pfi.configure({"faults": [{"site": "metrics.server.request",
                                   "kind": "error", "times": 1}]})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/metrics")
        assert ei.value.code == 503
        assert _get(port, "/health").read() == b"ok"  # fired once
    finally:
        srv.stop()


def test_maybe_start_survives_taken_port(caplog):
    blocker = socket.socket()
    blocker.bind(("0.0.0.0", 0))
    taken = blocker.getsockname()[1]
    try:
        with caplog.at_level(logging.WARNING,
                             logger="horovod_tpu_torch.telemetry"):
            assert pserver.maybe_start(taken, 0) is None
        assert any("could not bind" in r.getMessage()
                   for r in caplog.records)
    finally:
        blocker.close()


def test_env_lifecycle(monkeypatch, tmp_path):
    for var in ("HVD_METRICS", "HVD_METRICS_PORT", "HVD_METRICS_FILE",
                "HVD_RENDEZVOUS_ADDR", "HVD_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not ptel.enabled_in_env() and ptel.init_from_env(0) is False
    assert not ptmx.enabled()
    monkeypatch.setenv("HVD_METRICS", "1")
    assert ptel.init_from_env(0) is True and ptel.server_port() is None
    ptmx.inc_counter("hvd_cycles_total")
    ptel.stop()  # the registry keeps counting across an engine's stop
    assert ptmx.snapshot()["counters"]["hvd_cycles_total"] == 1
    ptel.reset()
    port = _free_port()
    path = str(tmp_path / "m.jsonl")
    monkeypatch.setenv("HVD_METRICS_PORT", str(port))
    monkeypatch.setenv("HVD_METRICS_FILE", path)
    monkeypatch.setenv("HVD_METRICS_INTERVAL", "60")
    assert ptel.init_from_env(2, local_rank=0) is True
    try:
        assert ptel.server_port() == port
        ptmx.inc_counter("hvd_cycles_total")
        assert "hvd_cycles_total 1" in _get(port, "/metrics").read().decode()
        assert ptel.init_from_env(2) is True  # idempotent
        assert ptel.server_port() == port
    finally:
        ptel.reset()
    assert ptel.server_port() is None
    [line] = open(path).read().splitlines()
    assert json.loads(line)["rank"] == 2


def test_metrics_snapshot_at_top_level():
    import horovod_tpu_torch as hvd

    assert hvd.metrics_snapshot() == {}
    ptmx.configure(True)
    ptmx.inc_counter("hvd_cycles_total")
    assert hvd.metrics_snapshot()["counters"]["hvd_cycles_total"] == 1


# ---------------------------------------------------------------------------
# zero cost with the knobs off, and the eager layer's labels
# ---------------------------------------------------------------------------


def test_hooks_are_free_when_disabled():
    """With telemetry off every hook is a global load and a None check:
    no allocation (tracemalloc), as the JAX package pins it."""
    assert not ptmx.enabled()
    from horovod_tpu_torch.telemetry import blackbox as pbb
    from horovod_tpu_torch.telemetry import trace as ptr

    pbb.reset()
    ptmx.inc_counter("hvd_cycles_total")
    ptmx.observe("hvd_cycle_duration_seconds", 0.001)
    ptmx.set_gauge("hvd_queue_depth", 0)
    gc.collect()
    tracemalloc.start()
    before = tracemalloc.get_traced_memory()[0]
    for _ in range(10000):
        ptmx.inc_counter("hvd_cycles_total")
        ptmx.observe("hvd_cycle_duration_seconds", 0.001)
        ptmx.set_gauge("hvd_queue_depth", 0)
        ptr.emit("hop", 0, 0)
        pbb.note("x", 0)
    after = tracemalloc.get_traced_memory()[0]
    tracemalloc.stop()
    assert after - before < 512, (before, after)


def test_timed_post_identity_off_and_labels_on():
    from horovod_tpu.ops import eager as jeager
    from horovod_tpu_torch.common.types import DataType
    from horovod_tpu_torch.ops import eager as peager

    post = lambda raw: raw  # noqa: E731
    arr = np.ones(8, np.float32)
    assert peager._timed_post("allreduce", arr, None, post) is post
    assert peager._timed_post("allreduce", arr, None, None) is None
    for tmx in (ptmx, jtmx):
        tmx.configure(True)
    import ml_dtypes

    jb = np.ones(8, ml_dtypes.bfloat16)
    for kind, a in (("allreduce", arr), ("broadcast", jb)):
        assert jeager._timed_post(kind, a, None)("raw") == "raw"
    assert peager._timed_post("allreduce", arr, DataType.FLOAT32,
                              None)("raw") == "raw"
    assert peager._timed_post("broadcast", jb.view(np.uint16),
                              DataType.BFLOAT16, None)("raw") == "raw"
    ps, js = ptmx.snapshot(), jtmx.snapshot()
    assert ps["counters"] == js["counters"]
    for key, h in js["histograms"].items():
        if "bytes" in key:
            assert ps["histograms"][key] == h
        else:
            assert ps["histograms"][key]["count"] == h["count"]
    assert 'hvd_collectives_total{op="broadcast",dtype="bfloat16"}' in \
        ps["counters"]


def test_torch_bfloat16_counts_under_numpy_name(monkeypatch):
    """Through ``hvd.allreduce`` on a one-rank engine: a torch bfloat16
    tensor is ``dtype="bfloat16"``, never ``"torch.bfloat16"``."""
    import horovod_tpu_torch as hvd

    for k in ("HVD_RANK", "HVD_SIZE", "HVD_RENDEZVOUS_ADDR",
              "HVD_RENDEZVOUS_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_METRICS", "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(4, dtype=torch.bfloat16), op=hvd.Sum)
        hvd.allgather(torch.ones(2, 3), name="g")
        c = hvd.metrics_snapshot()["counters"]
    finally:
        hvd.shutdown()
    assert c['hvd_collectives_total{op="allreduce",dtype="bfloat16"}'] == 1
    assert c['hvd_collectives_total{op="allgather",dtype="float32"}'] == 1
    assert not any("torch." in k for k in c)


@pytest.mark.timeout(120)
def test_metrics_on_sends_the_same_frames(monkeypatch):
    """A two-rank gang with the registry on: its control frames are the
    request and response lists alone, each re-encoded byte for byte by
    the JAX codecs, with no knob broadcast; and the registry counted."""
    from horovod_tpu.common import wire as jwire
    from horovod_tpu_torch.utils import socketutil as su

    from test_torch_timeouts import _drive, _gang_of_two, _stop

    for k in ("HVD_HEARTBEAT_TIMEOUT", "HVD_COLLECTIVE_TIMEOUT",
              "HVD_TIMELINE", "HVD_WIRE_CRC", "HOROVOD_FAULT_PLAN",
              "HVD_TRACE", "HVD_AUTOTUNE", "HVD_METRICS_PORT",
              "HVD_METRICS_FILE"):
        monkeypatch.delenv(k, raising=False)
    engines, _threads, frames = _gang_of_two(monkeypatch,
                                             {"HVD_METRICS": "1"})
    try:
        _drive(engines)
    finally:
        _stop(engines)
    assert {t for t, _ in frames} == {su.TAG_REQUEST_LIST,
                                      su.TAG_RESPONSE_LIST}
    for tag, payload in frames:
        if tag == su.TAG_REQUEST_LIST:
            reqs, shutdown, hits, epoch = jwire.decode_request_list(payload)
            again = jwire.encode_request_list(reqs, shutdown=shutdown,
                                              cache_hits=hits, epoch=epoch)
        else:
            resps, shutdown, pos, resend, params, epoch = \
                jwire.decode_response_list(payload)
            assert params is None
            again = jwire.encode_response_list(
                resps, shutdown=shutdown, hit_positions=pos,
                resend_names=resend, params=params, epoch=epoch)
        assert again == payload
    c = ptmx.snapshot()["counters"]
    assert c["hvd_cycles_total"] > 0
    assert c["hvd_cache_misses_total"] == 6  # three names on two ranks


# ---------------------------------------------------------------------------
# a port gang and a JAX gang: the same counts
# ---------------------------------------------------------------------------

TIMING_FREE = ("hvd_collectives_total", "hvd_cache_hits_total",
               "hvd_cache_misses_total", "hvd_evictions_total",
               "hvd_collective_timeouts_total")


@pytest.fixture(scope="module")
def metric_gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("metric_gangs")
    started = {}
    for name, pkgs in (("port3", ["port-nogroup"] * 3),
                       ("jax3", ["jax"] * 3)):
        d = str(root / name)
        started[name] = _start(
            pkgs, ["metrics"], d,
            lambda r, d=d: {"HVD_METRICS_FILE":
                            os.path.join(d, f"metrics{r}.jsonl"),
                            "HVD_METRICS_INTERVAL": "60"})
    deadline = time.monotonic() + 90.0
    out = {}
    for name, (server, procs) in started.items():
        runs = _finish(server, procs, deadline)
        recs, results = [], []
        for r in range(3):
            lines = (root / name / f"metrics{r}.jsonl").read_text() \
                .splitlines() if (root / name / f"metrics{r}.jsonl") \
                .exists() else []
            recs.append(json.loads(lines[-1]) if lines else {})
            p = root / name / f"rank{r}.pkl"
            results.append(pickle.loads(p.read_bytes())
                           if p.exists() else {})
        out[name] = (runs, recs, results)
    return out


def _timing_free(rec):
    c = {k: v for k, v in rec.get("counters", {}).items()
         if k.split("{")[0] in TIMING_FREE}
    b = {k: (h["count"], h["sum"])
         for k, h in rec.get("histograms", {}).items()
         if k.startswith("hvd_collective_bytes")}
    return c, b


def test_gang_counters_equal_jax(metric_gangs):
    for name in ("port3", "jax3"):
        for r, (code, text) in enumerate(metric_gangs[name][0]):
            assert code == 0 and "SCENARIO_OK metrics" in text, \
                f"{name} rank {r} (exit {code}):\n{text[-3000:]}"
    port, jax = metric_gangs["port3"], metric_gangs["jax3"]
    for r in range(3):
        assert port[1][r]["rank"] == r
        assert _timing_free(port[1][r]) == _timing_free(jax[1][r]), r
        assert port[2][r]["metrics"] == jax[2][r]["metrics"], r
    c, b = _timing_free(port[1][1])
    assert c['hvd_collectives_total{op="allreduce",dtype="bfloat16"}'] == 3
    assert c['hvd_collectives_total{op="allgather",dtype="float32"}'] == 3
    # The cache holds allreduces only: two names, hit in steps 2 and 3.
    assert c["hvd_cache_hits_total"] == 4
    assert "hvd_evictions_total" not in c
    assert b['hvd_collective_bytes{op="broadcast",dtype="float32"}'] == \
        (3, 60.0)
