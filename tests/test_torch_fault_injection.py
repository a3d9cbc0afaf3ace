"""The port's fault injection (``horovod_tpu_torch/common/
fault_injection.py``) against the JAX package's.

The same plan fires the same sequence in both packages: one seeded
sequence of ``(site, detail)`` passes goes through both packages' ``fire``
and ``should_corrupt``, recording at each pass whether it raised,
corrupted or slept (and how long), for plans given as inline JSON, as a
file and as ``random:<seed>:<rate>``, with every kind but ``kill`` and
every field (``match``, ``times``, ``after``, ``prob`` under the plan's
``seed``, ``groups``).  Also: ``random_schedule`` gives the JAX dicts,
``partition`` follows ``HVD_RANK``, ``fire`` does nothing with no plan,
and every site literal the port's code fires is in its ``known_sites()``.
The telemetry's sites fire where the JAX package's do
(``metrics.server.request``, ``agg.scrape``, ``trace.emit``,
``blackbox.dump``), and at ``init()`` no knob is left out any more (the
elastic epoch was the last).
"""

import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

from horovod_tpu.common import fault_injection as jfi
from horovod_tpu_torch.common import fault_injection as fi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SITES = ("sock.send", "sock.recv", "kv.put", "ctrl.worker.send",
         "sock.corrupt", "shm.lost", "grad.nonfinite", "serve.admit",
         "sock.reset", "train.step")
DETAILS = ("0", "1", "2", "3", "hvd/addr/1", "POST /generate", "read",
           "write")

PLAN = {"seed": 7, "faults": [
    {"site": "sock.send", "kind": "drop", "match": "3", "times": 4},
    {"site": "sock.recv", "kind": "error", "after": 3, "prob": 0.5},
    {"site": "kv.put", "kind": "delay", "delay_s": 0.25, "prob": 0.3},
    {"site": "sock.corrupt", "kind": "corrupt", "prob": 0.4},
    {"site": "grad.nonfinite", "kind": "corrupt", "after": 2, "times": 3},
    {"site": "shm.lost", "kind": "error", "match": "read", "times": 2},
    {"site": "train.step", "kind": "stall", "stall_s": 1.5, "times": 2},
    {"site": "serve.admit", "kind": "halfopen", "stall_s": 0.5,
     "prob": 0.2},
    {"site": "ctrl.worker.send", "kind": "partition",
     "groups": [[0, 1], [2, 3]]},
    {"site": "sock.reset", "kind": "error", "prob": 0.1},
]}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    fi.clear()
    jfi.clear()
    sleeps = {}
    for name, mod in (("port", fi), ("jax", jfi)):
        log = sleeps.setdefault(name, [])
        monkeypatch.setattr(mod, "time", SimpleNamespace(
            sleep=lambda s, log=log: log.append(s)))
    yield sleeps
    fi.clear()
    jfi.clear()


def _passes(seed, n=400):
    rng = np.random.default_rng(seed)
    return [(SITES[rng.integers(len(SITES))],
             DETAILS[rng.integers(len(DETAILS))]) for _ in range(n)]


def _drive(mod, sleeps, passes):
    """What each pass did: ("pass",) or ("raise", message), then
    ("slept", seconds...) if it slept, then ("corrupt",) if a corrupt
    fault armed."""
    out = []
    for site, detail in passes:
        n_sleeps = len(sleeps)
        try:
            mod.fire(site, detail)
            what = ("pass",)
        except mod.InjectedFault as e:
            what = ("raise", str(e))
        if len(sleeps) > n_sleeps:
            what = what + ("slept",) + tuple(sleeps[n_sleeps:])
        if mod.should_corrupt(site, detail):
            what = what + ("corrupt",)
        out.append(what)
    return out


def _both(_clean, passes):
    return (_drive(fi, _clean["port"], passes),
            _drive(jfi, _clean["jax"], passes))


@pytest.mark.parametrize("rank", ["0", "2"])
def test_inline_plan_fires_the_same_sequence(monkeypatch, _clean, rank):
    monkeypatch.setenv("HVD_RANK", rank)
    monkeypatch.setenv(fi.ENV_VAR, json.dumps(PLAN))
    fi._load_from_env()
    jfi._load_from_env()
    assert fi.active() and jfi.active()
    mine, theirs = _both(_clean, _passes(int(rank) + 1))
    assert mine == theirs
    kinds = {w[0] for w in mine} | {w[-1] for w in mine}
    assert {"pass", "raise", "corrupt"} <= kinds
    assert any("slept" in w for w in mine)
    fired = [f.fired for f in fi._PLAN.faults]
    assert fired == [f.fired for f in jfi._PLAN.faults]
    assert all(fired[:9]), fired


def test_file_plan_fires_the_same_sequence(monkeypatch, _clean, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN))
    monkeypatch.setenv("HVD_RANK", "1")
    monkeypatch.setenv(fi.ENV_VAR, str(path))
    fi._load_from_env()
    jfi._load_from_env()
    mine, theirs = _both(_clean, _passes(11))
    assert mine == theirs


@pytest.mark.parametrize("spec", ["random:1234:0.05", "random:9:0.5"])
def test_random_plan_fires_the_same_sequence(monkeypatch, _clean, spec):
    monkeypatch.setenv(fi.ENV_VAR, spec)
    fi._load_from_env()
    jfi._load_from_env()
    passes = [(s, d) for s, d in _passes(3, 1000)
              if s in ("sock.corrupt", "sock.reset", "shm.lost")]
    mine, theirs = _both(_clean, passes)
    assert mine == theirs
    assert any(w[0] == "raise" for w in mine)
    assert any(w[-1] == "corrupt" for w in mine)


@pytest.mark.parametrize("seed,rate", [(0, 0.0), (1234, 0.05), (7, 1.0)])
def test_random_schedule_equals_jax(seed, rate):
    assert fi.random_schedule(seed, rate) == jfi.random_schedule(seed, rate)
    assert fi.RANDOM_SCHEDULE_FAULTS == jfi.RANDOM_SCHEDULE_FAULTS


def test_partition_follows_hvd_rank(monkeypatch):
    plan = {"faults": [{"site": "sock.send", "kind": "partition",
                        "groups": [[0, 1], [2, 3]]}]}
    for mod in (fi, jfi):
        mod.configure(plan)
        for me, other, cut in (("0", "2", True), ("0", "1", False),
                               ("3", "1", True), ("2", "3", False),
                               ("2", "2", True), ("1", "1", False)):
            monkeypatch.setenv("HVD_RANK", me)
            if cut:
                with pytest.raises(mod.InjectedFault):
                    mod.fire("sock.send", other)
            else:
                mod.fire("sock.send", other)
        mod.fire("sock.send", "not-a-rank")
        mod.clear()
    with pytest.raises(ValueError, match="groups"):
        fi.configure({"faults": [{"site": "x", "kind": "partition"}]})
    with pytest.raises(ValueError, match="unknown fault kind"):
        fi.configure({"faults": [{"site": "x", "kind": "explode"}]})


def test_no_plan_fire_does_nothing(monkeypatch, _clean):
    monkeypatch.delenv(fi.ENV_VAR, raising=False)
    fi._load_from_env()
    assert not fi.active() and fi._PLAN is None
    for site, detail in _passes(5, 200):
        assert fi.fire(site, detail) is None
        assert fi.should_corrupt(site, detail) is False
    assert _clean["port"] == []


def _fired_literals(package="horovod_tpu_torch"):
    """(file, site) for every site literal ``package`` passes to ``fire``
    or ``should_corrupt`` (the KV client passes its sites through
    ``_with_retry``)."""
    pat = re.compile(r"""(?:\bfire\(|should_corrupt\(|_with_retry\(\w+,)"""
                     r"""\s*["']([a-z_.]+)["']""")
    found = []
    root = os.path.join(REPO, package)
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as fh:
                    for site in pat.findall(fh.read()):
                        found.append((os.path.relpath(path, REPO), site))
    return found


def test_every_fired_site_is_known():
    found = _fired_literals()
    known = fi.known_sites()
    unknown = [(f, s) for f, s in found if s not in known]
    assert not unknown, unknown
    # Every known site but the user-level one is fired somewhere, and is
    # one of the JAX package's sites: in its registry, or fired by it
    # (its KV client fires ``kv.list``, which its registry does not list).
    assert {s for _, s in found} == set(known) - {"train.step"}
    jax_sites = set(jfi.known_sites()) | {
        s for _, s in _fired_literals("horovod_tpu")}
    assert set(known) <= jax_sites


def test_telemetry_sites_fire(tmp_path):
    """Each telemetry site fires and degrades as in the JAX package: the
    debug server sheds with a 503, the fold marks the rank stale, a span
    batch is dropped and a dump returns None, none of them raising."""
    import urllib.error
    import urllib.request

    from horovod_tpu_torch.telemetry import aggregate, blackbox, registry
    from horovod_tpu_torch.telemetry import server, trace

    sites = ("metrics.server.request", "agg.scrape", "trace.emit",
             "blackbox.dump")
    fi.configure({"faults": [{"site": s, "kind": "error"} for s in sites]})
    registry.configure(True)
    try:
        srv = server.MetricsServer(host="127.0.0.1", port=0)
        port = srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                       timeout=5)
            assert ei.value.code == 503
        finally:
            srv.stop()
        agg = aggregate.GangAggregator(2, kv=None, interval_s=999.0)
        assert agg.poll_once(now=1.0)["stale_ranks"] == [0, 1]
        tr = trace.Tracer(0, str(tmp_path / "t.jsonl"))
        tr.close()
        assert (tmp_path / "t.jsonl").read_text() == ""
        bb = blackbox.Blackbox(0, 16, str(tmp_path / "bb"))
        assert bb.dump("engine_abort") is None
        fired = {f.site: f.fired for f in fi._PLAN.faults}
        assert all(fired[s] >= 1 for s in sites), fired
    finally:
        registry.configure(False)


def test_only_the_elastic_knob_is_left_out(monkeypatch):
    """The elastic knob was the last one left out: since elastic is
    ported, none is, and no knob raises."""
    from horovod_tpu_torch import runtime_py

    assert list(runtime_py._LEFT_OUT) == []
    for k in ("HVD_AUTOTUNE", "HVD_METRICS", "HVD_TRACE",
              "HVD_STRAGGLER_WARN_MS", "HVD_METRICS_PORT",
              "HVD_METRICS_FILE", "HVD_ELASTIC_EPOCH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (("HVD_AUTOTUNE", "1"), ("HVD_METRICS", "1"),
                 ("HVD_METRICS_PORT", "0"), ("HVD_METRICS_FILE", "/x"),
                 ("HVD_STRAGGLER_WARN_MS", "50"), ("HVD_TRACE", "1"),
                 ("HVD_ELASTIC_EPOCH", "1")):
        monkeypatch.setenv(k, v)
    runtime_py.check_left_out_knobs()  # none of these raises
