"""The port's gang-wide trace (``horovod_tpu_torch/telemetry/trace.py``)
against the JAX package's.

* A ``Tracer`` writes the JAX records field for field: ``meta``, ``clock``
  and ``span``, with the same seq, buffering and ``release``; a
  ``trace.emit`` fault drops a batch and raises nothing.
* With no tracer the port's ring reads no clock; with one it writes
  ``pack``, ``hop`` (``recv_ns``, ``reduce_ns``, ``send_wait_ns``) and
  ``unpack`` spans, on the flat ring and on the hierarchical paths.
* Gangs of three with ``HVD_TRACE=1`` (``tests/torch_port_engine_worker.py
  fusion,cache``): a port gang, a JAX root over port workers, and a port
  gang whose rank 1 has a ``trace.emit`` fault.  The JAX package's
  ``horovod_tpu.tools.hvd_trace`` loads, merges and analyzes every rank
  file; the same seq names the same collective on every rank; every
  worker has ``clock`` records, each within its round trip of the root's
  clock (one host: the true offset is 0); the fault dropped spans on its
  rank alone, and every gang's results are bit-equal.
"""

import json
import pickle
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

from horovod_tpu.telemetry import trace as jtrace
from horovod_tpu.tools import hvd_trace
from horovod_tpu_torch.common import fault_injection as pfi
from horovod_tpu_torch.common.types import (DataType, ReduceOp, Response,
                                            ResponseType)
from horovod_tpu_torch.ops import cpu_backend as cb
from horovod_tpu_torch.ops.fusion_buffer import FusionBuffer
from horovod_tpu_torch.telemetry import trace as ptrace
from horovod_tpu_torch.utils import transport as tpt

from test_torch_engine import _finish, _start


@pytest.fixture(autouse=True)
def _clean():
    pfi.clear()
    ptrace.reset()
    jtrace.reset()
    yield
    pfi.clear()
    ptrace.reset()
    jtrace.reset()


def _records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("pid", "t_ns", "mono_anchor_ns", "wall_anchor_ns")}


def test_tracer_records_equal_jax(tmp_path):
    out = {}
    for name, mod in (("port", ptrace), ("jax", jtrace)):
        path = str(tmp_path / f"{name}.jsonl")
        tr = mod.Tracer(1, path, epoch=0)
        tr.clock(-1234, 56789)
        for i in range(3):
            seq = tr.begin_collective()
            tr.span("negotiate", 10, 20 + i, seq=seq, name=f"t{i}",
                    op="ALLREDUCE", tensors=2)
            tr.span("hop", 30, 40, ring="reduce_scatter", hop=0, peer=0,
                    tp="shm", recv_ns=4, reduce_ns=3, send_wait_ns=3)
        tr.instant("transport.failover", peer=2, tp="tcp")
        assert tr.seq == 2
        mod.release(tr)
        out[name] = [_strip(r) for r in _records(path)]
    port, jax = out["port"], out["jax"]
    # The instant's clock read differs; every other field is the same.
    for recs in (port, jax):
        recs[-1].pop("t0"), recs[-1].pop("t1")
    assert port == jax
    assert [r["k"] for r in port[:2]] == ["meta", "clock"]


def test_from_env_gating_and_emit_fault(monkeypatch, tmp_path):
    monkeypatch.delenv("HVD_TRACE", raising=False)
    assert ptrace.from_env(0) is None and not ptrace.active()
    ptrace.emit("hop", 0, 1)  # a no-op with the trace off
    monkeypatch.setenv("HVD_TRACE", "1")
    monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path / "tr"))
    tr = ptrace.from_env(3)
    assert ptrace.get() is tr
    pfi.configure({"faults": [{"site": "trace.emit", "kind": "error",
                               "times": 1}]})
    for i in range(ptrace._FLUSH_EVERY - 1):  # the meta record is first
        ptrace.emit("x", i, i + 1)
    ptrace.emit_instant("y")  # the next batch lands
    ptrace.release(tr)
    assert not ptrace.active()
    recs = _records(tmp_path / "tr" / "trace_rank3.jsonl")
    assert [r["ph"] for r in recs] == ["y"]  # the first batch was dropped


class _CountingTime:
    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        return getattr(time, name)

    def monotonic_ns(self):
        self.calls += 1
        return time.monotonic_ns()

    def perf_counter(self):
        self.calls += 1
        return time.perf_counter()


def _mesh(n, local_size):
    socks, engines = [], []
    for r in range(n):
        engines.append(SimpleNamespace(
            rank=r, size=n, local_rank=r % local_size,
            local_size=local_size, cross_rank=r // local_size,
            cross_size=n // local_size, ring_segment_bytes=64,
            hierarchical_allreduce=local_size > 1,
            hierarchical_topology_ok=lambda: True,
            _fusion_buf=FusionBuffer(), _transports={}, _tracer=None))
    for a in range(n):
        for b in range(a + 1, n):
            sa, sb = socket.socketpair()
            socks += [sa, sb]
            engines[a]._transports[b] = tpt.TcpTransport(sa, b)
            engines[b]._transports[a] = tpt.TcpTransport(sb, a)
    return engines, socks


def _run(engines, fn):
    import threading

    out = {}
    ts = [threading.Thread(target=lambda e=e: out.__setitem__(e.rank,
                                                              fn(e)))
          for e in engines]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert len(out) == len(engines)
    return out


@pytest.mark.parametrize("n,local_size", [(2, 1), (4, 2)])
def test_ring_spans_and_no_clock_reads_untraced(monkeypatch, tmp_path, n,
                                               local_size):
    datas = {r: np.arange(300, dtype=np.float32) + r for r in range(n)}
    resp = Response(response_type=ResponseType.ALLREDUCE,
                    tensor_type=DataType.FLOAT32, reduce_op=ReduceOp.SUM)

    def coll(eng):
        return cb.allreduce(eng, [SimpleNamespace(array=datas[eng.rank])],
                            resp)[0]

    engines, socks = _mesh(n, local_size)
    try:
        _run(engines, coll)  # warm the buffers and senders
        ct = _CountingTime()
        monkeypatch.setattr(cb, "time", ct)
        plain = _run(engines, coll)
        assert ct.calls == 0, f"the untraced ring read the clock {ct.calls}x"
        monkeypatch.undo()
        for e in engines:
            e._tracer = ptrace.Tracer(e.rank,
                                      str(tmp_path / f"t{e.rank}.jsonl"))
        traced = _run(engines, coll)
        for e in engines:
            e._tracer.close()
    finally:
        for e in engines:
            for t in e._transports.values():
                t.close(timeout=2.0)
        for s in socks:
            s.close()
    want = sum(datas.values())
    for r in range(n):
        np.testing.assert_array_equal(plain[r], want)
        np.testing.assert_array_equal(traced[r], want)
        spans = [x for x in _records(tmp_path / f"t{r}.jsonl")
                 if x["k"] == "span"]
        phases = [s["ph"] for s in spans]
        assert phases[0] == "pack" and phases[-1] == "unpack"
        hops = [s for s in spans if s["ph"] == "hop"]
        # flat: 2 (n-1) hops; hierarchical: 2 (L-1) local + 2 (C-1) cross
        want_hops = 2 * (n - 1) if local_size == 1 else \
            2 * (local_size - 1) + 2 * (n // local_size - 1)
        assert len(hops) == want_hops
        assert {h["ring"] for h in hops} == {"reduce_scatter", "allgather"}
        for h in hops:
            assert h["recv_ns"] >= 0 and h["send_wait_ns"] >= 0
            assert h["tp"] == "tcp" and h["t1"] >= h["t0"]
        assert any(h["reduce_ns"] > 0 for h in hops)


# ---------------------------------------------------------------------------
# traced gangs
# ---------------------------------------------------------------------------

CASES = ["fusion", "cache"]
GANGS = {
    "port3": ["port-nogroup"] * 3,
    "mixed": ["jax", "port-nogroup", "port-nogroup"],
    "port3_fault": ["port-nogroup"] * 3,
}
EMIT_FAULT = json.dumps({"faults": [
    {"site": "trace.emit", "kind": "error", "after": 1, "times": 1}]})


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_gangs")
    started = {}
    for name, pkgs in GANGS.items():
        d = str(root / name)

        def env(r, name=name, d=d):
            e = {"HVD_TRACE": "1", "HVD_TRACE_DIR": d,
                 "HVD_TRACE_CLOCK_SYNC_CYCLES": "5"}
            if name == "port3_fault" and r == 1:
                e["HOROVOD_FAULT_PLAN"] = EMIT_FAULT
            return e

        started[name] = _start(pkgs, CASES, d, env)
    deadline = time.monotonic() + 90.0
    out = {}
    for name, (server, procs) in started.items():
        runs = _finish(server, procs, deadline)
        d = root / name
        results = [pickle.loads((d / f"rank{r}.pkl").read_bytes())
                   if (d / f"rank{r}.pkl").exists() else {}
                   for r in range(3)]
        out[name] = (runs, results, str(d))
    return out


@pytest.mark.parametrize("name", list(GANGS))
def test_jax_tool_reads_the_gang(traced, name):
    runs, results, d = traced[name]
    for r, (code, text) in enumerate(runs):
        for case in CASES:
            assert code == 0 and f"SCENARIO_OK {case}" in text, \
                f"rank {r} (exit {code}):\n{text[-3000:]}"
    files = hvd_trace.load_files(hvd_trace.trace_files(d))
    assert [f["rank"] for f in files] == [0, 1, 2]
    merged = hvd_trace.merge(files)
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1, 2}
    rep = hvd_trace.analyze(files)
    assert rep["num_ranks"] == 3 and rep["num_collectives"] > 10
    assert rep["phase_breakdown_ms"]["hop.recv"] > 0
    # The same seq names the same collective on every rank.
    by_rank = {f["rank"]: {s["seq"]: (s["name"], s["op"])
                           for s in f["spans"] if s["ph"] == "collective"}
               for f in files}
    if name != "port3_fault":
        assert by_rank[0] == by_rank[1] == by_rank[2]
    else:
        common = set(by_rank[0]) & set(by_rank[1])
        assert all(by_rank[0][s] == by_rank[1][s] == by_rank[2][s]
                   for s in common)
    for f in files:
        if f["rank"] == 0:
            assert f["clocks"][0]["offset_ns"] == 0
            continue
        assert f["clocks"], f["rank"]
        for c in f["clocks"]:
            assert abs(c["offset_ns"]) <= c["rtt_ns"], c
        kinds = {s["ph"] for s in f["spans"]}
        assert {"negotiate", "pack", "hop", "unpack", "callback",
                "collective", "transport.map"} <= kinds, kinds


def test_emit_fault_drops_spans_not_results(traced):
    clean = hvd_trace.load_files(hvd_trace.trace_files(traced["port3"][2]))
    faulty = hvd_trace.load_files(
        hvd_trace.trace_files(traced["port3_fault"][2]))
    n = {f["rank"]: len(f["spans"]) for f in faulty}
    assert n[1] < n[0] and n[1] < n[2]
    assert n[0] == len(clean[0]["spans"]) or n[0] > 0
    base = traced["port3"][1]
    for name in ("mixed", "port3_fault"):
        for r in range(3):
            assert traced[name][1][r] == base[r], (name, r)
