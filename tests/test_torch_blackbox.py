"""The port's flight recorder (``horovod_tpu_torch/telemetry/blackbox.py``)
against the JAX package's.

* The recorder: a bounded ring, begin and end records with the in-flight
  marker, the knobs' defaults and floors, ``HVD_BLACKBOX=0``, a ring kept
  across engines; the dump's JSON has the JAX schema (``hvd-blackbox-v1``,
  the same keys and events for the same notes), is written to a temp file
  and ``os.replace``d, redacts secrets, and a ``blackbox.dump`` fault makes
  it return None without raising; the SIGTERM hook dumps; recording reads
  no clock; ``GET /debug/blackbox`` serves the live ring.
* The steady-state pin of a collective with the recorder on (the JAX
  package's ``tests/test_dataplane.py`` pin, here through two in-process
  ``PyEngine`` ranks): no new thread, no payload-sized allocation.
* Gangs of three with PR 14's knobs: rank 2 killed after step 2 under
  heartbeats, and rank 2 stalled at step 1 under a collective deadline, in
  port, mixed and JAX gangs.  Every survivor has a schema-valid dump, the
  stalled rank's ring was pulled by the coordinator, and the JAX
  package's ``hvd_postmortem.analyze`` names the same first cause from
  the port's and mixed gangs' dump directories as from the JAX gang's.
  A port gang with ``HVD_BLACKBOX=0`` writes nothing.
"""

import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu.telemetry import blackbox as jbb
from horovod_tpu.tools import hvd_postmortem as pm
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch.common import fault_injection as pfi
from horovod_tpu_torch.telemetry import blackbox as pbb
from horovod_tpu_torch.telemetry import registry as ptmx
from horovod_tpu_torch.utils import env as penv

from test_torch_liveness import HEARTBEAT_ENV, KILL_PLAN, _finish, _start
from test_torch_timeouts import STALL_ENV

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def _clean():
    for m in (pbb, jbb):
        m.reset()
    pfi.clear()
    ptmx.configure(False)
    yield
    for m in (pbb, jbb):
        m.reset()
    pfi.clear()
    ptmx.configure(False)


def _notes(mod, bb):
    bb.note("engine.init", 0, {"rank": 1, "size": 3, "epoch": 0})
    for i in range(40):
        bb.collective_begin(1000 + i, i, f"grad.{i}", "ALLREDUCE", 4096,
                            0, "shm")
        bb.collective_end(0, i, True)
    bb.collective_begin(5000, 41, "grad.x", "ALLREDUCE", 64, 0, "tcp")
    bb.note("collective.timeout", 6000, {"name": "grad.x", "peer": 2,
                                         "phase": "recv"})
    bb.note_clock_offset(-777)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_ring_and_dump_equal_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_SECRET_KEY", "hunter2")
    docs = {}
    for name, mod in (("port", pbb), ("jax", jbb)):
        d = tmp_path / name
        bb = mod.Blackbox(1, 32, str(d))
        _notes(mod, bb)
        path = bb.dump("collective_timeout", "wedged=[2] name=grad.x")
        assert path == str(d / "blackbox_rank1.json")
        assert os.listdir(d) == ["blackbox_rank1.json"]  # no temp left
        docs[name] = json.loads((d / "blackbox_rank1.json").read_text())
        pulled = json.loads(bb.dump_bytes("coordinator_pull"))
        assert pulled["reason"] == "coordinator_pull"
    port, jax = docs["port"], docs["jax"]
    assert set(port) == set(jax)
    for k in ("schema", "rank", "epoch", "capacity", "clock_offset_ns",
              "in_flight", "events", "reason", "detail", "metrics"):
        assert port[k] == jax[k], k
    assert port["schema"] == "hvd-blackbox-v1"
    assert len(port["events"]) == 32  # bounded, newest kept
    assert port["in_flight"] == {"name": "grad.x", "since_ns": 5000}
    assert port["env"]["HVD_SECRET_KEY"] == "<redacted>"
    assert port["env"] == jax["env"]


def test_knobs_equal_jax(monkeypatch):
    for env in ({}, {"HVD_BLACKBOX": "0"}, {"HVD_BLACKBOX_EVENTS": "4"},
                {"HVD_BLACKBOX_EVENTS": "100", "HVD_BLACKBOX_DIR": "/x"},
                {"HVD_TRACE": "1", "HVD_TRACE_CLOCK_SYNC_CYCLES": "0"}):
        for k in ("HVD_BLACKBOX", "HVD_BLACKBOX_EVENTS", "HVD_BLACKBOX_DIR",
                  "HVD_TRACE", "HVD_TRACE_DIR",
                  "HVD_TRACE_CLOCK_SYNC_CYCLES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("blackbox_enabled", "blackbox_events", "blackbox_dir",
                   "trace_enabled", "trace_dir", "trace_clock_sync_cycles",
                   "agg_interval_s", "alert_ewma_alpha", "alert_warmup",
                   "alert_collapse_frac", "alert_skew_factor",
                   "alert_skew_floor_ms", "alert_queue_factor",
                   "alert_retry_factor", "alert_serve_p99_ms"):
            assert getattr(penv, fn)() == getattr(jenv, fn)(), (env, fn)


def test_disabled_writes_nothing_and_ring_outlives_engines(monkeypatch,
                                                           tmp_path):
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path))
    monkeypatch.setenv("HVD_BLACKBOX", "0")
    assert pbb.from_env(0) is None and not pbb.active()
    pbb.note("ev", 1, a=2)
    assert pbb.dump("engine_abort", "x") is None
    assert list(tmp_path.iterdir()) == []
    monkeypatch.delenv("HVD_BLACKBOX")
    bb = pbb.from_env(1, epoch=0)
    bb.note("before", 7)
    assert pbb.from_env(0, epoch=2) is bb and bb.rank == 0
    assert "before" in [e["kind"] for e in bb.snapshot()["events"]]


def test_dump_fault_never_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path))
    pbb.from_env(0)
    pfi.configure({"faults": [{"site": "blackbox.dump", "kind": "error"}]})
    assert pbb.dump("engine_abort", "boom") is None
    assert list(tmp_path.iterdir()) == []
    pfi.clear()
    ptmx.configure(True)
    assert pbb.dump("engine_abort", "boom") is not None
    assert ptmx.snapshot()["counters"]["hvd_blackbox_dumps_total"] == 1


class _CountingTime:
    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        return getattr(time, name)

    def monotonic_ns(self):
        self.calls += 1
        return time.monotonic_ns()

    def time_ns(self):
        self.calls += 1
        return time.time_ns()


def test_recording_reads_no_clock_and_allocates_flat(monkeypatch,
                                                     tmp_path):
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path))
    bb = pbb.from_env(0)
    ct = _CountingTime()
    monkeypatch.setattr(pbb, "time", ct)
    for i in range(100):
        pbb.note("ladder.retry", 0, peer=1, cause="corrupt")
        bb.collective_begin(i, i, "t", "SUM", 8, 1, "tcp")
        bb.collective_end(0, i, True)
        pbb.note_clock_offset(i)
    assert ct.calls == 0
    bb.dump("engine_abort")
    assert ct.calls > 0
    # The JAX pin's ring of 64: once it is full every append recycles an
    # evicted slot (a larger ring's survivors from before tracemalloc
    # started would count as new).
    pbb._BB = pbb.Blackbox(0, 64, str(tmp_path))
    for i in range(200):
        pbb.note("serve.confirm", 0, step=i, slots=8)
    gc.collect()
    tracemalloc.start()
    before = tracemalloc.get_traced_memory()[0]
    for i in range(1000):
        pbb.note("serve.confirm", 0, step=i, slots=8)
    after = tracemalloc.get_traced_memory()[0]
    tracemalloc.stop()
    assert after - before < 16384, (before, after)


@pytest.mark.timeout(60)
def test_sigterm_dumps_then_dies_by_sigterm(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["HVD_BLACKBOX_DIR"] = str(tmp_path)
    code = ("import os, signal\n"
            "from horovod_tpu_torch.telemetry import blackbox as bb\n"
            "bb.from_env(5)\n"
            "bb.note('engine.init', 0, rank=5)\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, timeout=50)
    assert res.returncode == -signal.SIGTERM, (res.returncode, res.stderr)
    doc = json.loads((tmp_path / "blackbox_rank5.json").read_text())
    assert doc["reason"] == "sigterm"
    assert doc["events"][0]["kind"] == "engine.init"


def test_debug_blackbox_endpoint(monkeypatch, tmp_path):
    from horovod_tpu_torch.telemetry import server as pserver

    srv = pserver.MetricsServer(host="127.0.0.1", port=0)
    port = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/blackbox")
        assert ei.value.code == 404
        monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path))
        bb = pbb.from_env(0)
        bb.collective_begin(10, 1, "grad.a", "ALLREDUCE", 8, 1, "shm")
        doc = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/blackbox"))
        assert doc["role"] == "coordinator"
        assert doc["in_flight"]["name"] == "grad.a"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the steady-state pin, with the recorder on
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_steady_state_collective_pin_with_recorder(monkeypatch, tmp_path):
    from horovod_tpu_torch.common.types import ReduceOp

    from test_torch_timeouts import _gang_of_two, _stop

    for k in ("HVD_METRICS", "HVD_TRACE", "HVD_AUTOTUNE", "HVD_BLACKBOX",
              "HVD_COLLECTIVE_TIMEOUT", "HVD_HEARTBEAT_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    n = 60_000  # 240 KB fp32, 120 KB chunks over two ranks
    chunk = (n // 2) * 4
    datas = {r: np.random.default_rng(r).standard_normal(n)
             .astype(np.float32) for r in (0, 1)}
    engines, _threads, _ = _gang_of_two(
        monkeypatch, {"HVD_BLACKBOX_DIR": str(tmp_path),
                      "HVD_RING_SEGMENT_BYTES": str(16 << 10)})
    try:
        assert all(e._blackbox is not None for e in engines.values())

        def step(i):
            hs = {r: e.allreduce_async(f"pin.{i % 2}", datas[r],
                                       op=ReduceOp.SUM)
                  for r, e in engines.items()}
            return {r: e.synchronize(hs[r]) for r, e in engines.items()}

        step(0)
        step(1)
        before = threading.active_count()
        gc.collect()
        tracemalloc.start()
        outs = step(2)
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
        after = threading.active_count()
        np.testing.assert_array_equal(outs[0], datas[0] + datas[1])
    finally:
        _stop(engines)
    assert after == before
    plane = ("cpu_backend.py", "socketutil.py", "fusion_buffer.py",
             "transport.py", "trace.py", "blackbox.py", "runtime_py.py")
    big = [(st.traceback[0].filename, st.traceback[0].lineno, st.size)
           for st in snap.statistics("traceback")
           if st.traceback[0].filename.endswith(plane)
           and st.size >= chunk // 2]
    # The one per-collective copy that detaches results from the fusion
    # buffer, on each of the two ranks, is the contract.
    others = [b for b in big if not b[0].endswith("cpu_backend.py")]
    assert not others, others
    assert len(big) <= 2, big
    assert list(tmp_path.iterdir()) == []  # a clean run dumps nothing


# ---------------------------------------------------------------------------
# gangs that fail: a killed rank and a stalled rank
# ---------------------------------------------------------------------------

KILL = {"kill_port": ["port"] * 3, "kill_mixed": ["jax", "port", "port"],
        "kill_jax": ["jax"] * 3, "kill_port_off": ["port"] * 3}
STALL = {"stall_port": ["port"] * 3, "stall_mixed": ["port", "jax", "jax"],
         "stall_jax": ["jax"] * 3}


@pytest.fixture(scope="module")
def failed(tmp_path_factory):
    root = tmp_path_factory.mktemp("blackbox_gangs")
    deadline = time.monotonic() + 150.0
    out = {}
    started = {}
    for name, pkgs in KILL.items():
        env = dict(HEARTBEAT_ENV)
        if name.endswith("_off"):
            env["HVD_BLACKBOX"] = "0"
        started[name] = _start(pkgs, "train_steps", str(root / name),
                               base_env=env,
                               rank_env={2: {"HOROVOD_FAULT_PLAN":
                                             KILL_PLAN}})
    for name, pkgs in STALL.items():
        started[name] = _start(
            pkgs, "stall_steps", str(root / name),
            base_env=dict(STALL_ENV, HVD_SHM_DISABLE="1"),
            rank_env={2: {"TIMEOUT_VICTIM": "1",
                          "TIMEOUT_SITE": "sock.stall"}})
    for name, gang in started.items():
        stalled = (2,) if name in STALL else ()
        runs = _finish(gang, deadline, stalled=stalled)
        out[name] = (runs, str(root / name / "hvd_blackbox"))
    return out


def _schema_valid(doc, rank):
    return (doc["schema"] == "hvd-blackbox-v1" and doc["rank"] == rank
            and isinstance(doc["events"], list) and doc["events"]
            and "reason" in doc)


@pytest.mark.parametrize("name", list(KILL) + list(STALL))
def test_failed_gang_ships_its_evidence(failed, name):
    runs, bb_dir = failed[name]
    for r in (0, 1):
        assert runs[r][0] == 0, (r, runs[r][1][-3000:])
    if name.endswith("_off"):
        assert not os.path.exists(bb_dir)
        return
    for r in (0, 1):
        doc = json.loads(open(os.path.join(
            bb_dir, f"blackbox_rank{r}.json")).read())
        assert _schema_valid(doc, r), doc
        kinds = {e["kind"] for e in doc["events"]}
        if name in KILL:
            assert doc["reason"] == "ranks_failed", doc["reason"]
            assert "evict" in kinds, kinds
        else:
            assert doc["reason"] == "collective_timeout", doc["reason"]
            assert {"collective.begin", "abort.verdict"} <= kinds, kinds
    if name in STALL:
        pulled = json.loads(open(os.path.join(
            bb_dir, "blackbox_rank2.pulled.json")).read())
        assert _schema_valid(pulled, 2)
        assert pulled["reason"] == "coordinator_pull"
        assert pulled["in_flight"]["name"].startswith("grad")
    verdict = pm.analyze(bb_dir)
    base = pm.analyze(failed[name.split("_")[0] + "_jax"][1])
    assert verdict["first_cause"] == base["first_cause"] == 2, verdict
    assert verdict["gang_ruled"] == base["gang_ruled"] == [2]
