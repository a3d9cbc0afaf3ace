"""The port's eager engine in gangs, bit for bit against the JAX package's
``PyEngine``.

Four gangs run once per module, two at a time, so that at most six
worker processes share the machine (``tests/torch_port_engine_worker.py``,
each gang against its own ``RendezvousServer``):

* a port gang of 3 and a JAX gang of 3 (``HVD_TPU_CORE=py``) on the same
  seeded inputs: every case's results must be the same bits on every rank;
* a mixed gang of 2 (rank 0 a JAX ``PyEngine``, rank 1 the port) and a
  JAX gang of 2: the mixed gang completes every
  case, Adasum included (a power of two), with the JAX gang's bits;
* the same mixed gang with the recovery ladder on (``HVD_WIRE_CRC=1``),
  each rank under a fault plan that loses its shm ring once and then
  corrupts a few of its TCP data writes: the ladder heals every fault in
  place, and the gang gives the clean JAX gang's bits.

Every gang pairs its ranks over shm (they share the host): the JAX
``PyEngine`` and the port publish the same host fingerprint.

The cases: allreduce with every op, with and without pre- and postscale,
in fp32, bf16, fp16, int32 and both fp8 wire types (NaN, infinities and
fp8 overflow among the inputs), and through the compressors; fusion of
many small tensors; ragged allgather; reducescatter; ``sparse_allreduce``;
broadcast; alltoall with splits; process sets; ``broadcast_object``;
``broadcast_parameters``; barrier; a "Mismatched" shape error on every
rank, after which the engine works; response-cache hits on repeated steps;
join.  Each case is its own test over the module's gangs.

Every knob that turns on a feature the port leaves out raises
``NotImplementedError`` at ``init()``; those tests start no gang (none is
left out now).  The knobs of the features ported since (the timeline, the
hierarchical data plane, the ladder, the fault plan, liveness, deadlines,
the control tree, the autotuner, telemetry, the trace and the elastic
epoch) turn their feature on instead: rank 1 through ``hvd.init()`` and
rank 0 a ``PyEngine`` on a thread.  A clean two-rank teardown of that
kind writes no flight-recorder dump.
"""

import importlib
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, runtime_py
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_engine_worker.py")

CASES = ["allreduce", "fusion", "allgather", "reducescatter",
         "sparse_allreduce",
         "broadcast", "alltoall", "process_sets", "broadcast_object",
         "broadcast_parameters", "barrier", "mismatch", "cache", "join"]
MIXED_CASES = CASES + ["adasum"]
GANG_TIMEOUT = 150.0
# Each rank of the ladder's mixed gang: lose the shm ring once (the pair
# fails over to TCP), then corrupt three TCP data writes (NACKed and
# retransmitted).
CRC_PLAN = {"seed": 3, "faults": [
    {"site": "shm.lost", "kind": "error", "after": 40, "times": 1},
    {"site": "sock.corrupt", "kind": "corrupt", "after": 5, "times": 3}]}
CRC_ENV = {"HVD_WIRE_CRC": "1", "HOROVOD_FAULT_PLAN": json.dumps(CRC_PLAN)}


def _start(pkgs, cases, out_dir, extra_env=None):
    """Start one gang (one worker per entry of ``pkgs``) against its own
    rendezvous server; returns (server, processes).  ``extra_env`` is a
    dict of variables for every rank, or a function of the rank that
    returns one."""
    os.makedirs(out_dir, exist_ok=True)
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_"))}
    procs = []
    for rank, pkg in enumerate(pkgs):
        env = dict(env0, HVD_RANK=str(rank), HVD_SIZE=str(len(pkgs)),
                   HVD_LOCAL_RANK=str(rank), HVD_LOCAL_SIZE=str(len(pkgs)),
                   HVD_CROSS_RANK="0", HVD_CROSS_SIZE="1",
                   HVD_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_RENDEZVOUS_PORT=str(port), HVD_TPU_CORE="py",
                   JAX_PLATFORMS="cpu")
        if extra_env is not None:
            env.update(extra_env(rank) if callable(extra_env)
                       else extra_env)
        # In the gang's own directory, so that nothing a rank writes to its
        # working directory (a JAX rank's flight-recorder dump) lands in
        # the checkout.
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, pkg, ",".join(cases), out_dir],
            env=env, cwd=out_dir, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    return server, procs


def _finish(server, procs, deadline):
    """Wait for a gang; kill every process that outlives ``deadline``.
    Returns each rank's (exit code, output)."""
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += b"\n(killed: the gang outlived its time limit)"
            outs.append((p.returncode, out.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    return outs


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_gangs")
    waves = ({"port3": (["port"] * 3, CASES),
              "jax3": (["jax"] * 3, CASES)},
             {"mixed2": (["jax", "port-nogroup"], MIXED_CASES),
              "jax2": (["jax"] * 2, MIXED_CASES),
              "mixed2crc": (["jax", "port-nogroup"], MIXED_CASES, CRC_ENV)})
    deadline = time.monotonic() + GANG_TIMEOUT
    out = {}
    for plan in waves:
        started = {name: _start(spec[0], spec[1], str(root / name),
                                *spec[2:])
                   for name, spec in plan.items()}
        for name, (server, procs) in started.items():
            runs = _finish(server, procs, deadline)
            results, links = [], []
            for rank in range(len(procs)):
                path = root / name / f"rank{rank}.pkl"
                results.append(pickle.loads(path.read_bytes())
                               if path.exists() else {})
                path = root / name / f"rank{rank}.links.json"
                links.append(json.loads(path.read_text())
                             if path.exists() else {})
            out[name] = (runs, results, links)
    return out


def _ran(gang, case):
    runs = gang[0]
    for rank, (code, text) in enumerate(runs):
        assert f"SCENARIO_OK {case}" in text, \
            f"rank {rank} (exit {code}):\n{text[-4000:]}"


def _same_bits(got, want, case):
    assert len(got[1]) == len(want[1])
    for rank, (g, w) in enumerate(zip(got[1], want[1])):
        g, w = g.get(case), w.get(case)
        assert w, f"the JAX gang recorded nothing for {case} on rank {rank}"
        assert g is not None and set(g) == set(w), (rank, case)
        for key in w:
            assert g[key][:2] == w[key][:2], (rank, case, key, g[key][:2],
                                               w[key][:2])
            assert g[key][2] == w[key][2], \
                f"rank {rank}, {case} {key}: the bits differ"


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", CASES)
def test_port_gang_matches_jax_gang(gangs, case):
    _ran(gangs["jax3"], case)
    _ran(gangs["port3"], case)
    _same_bits(gangs["port3"], gangs["jax3"], case)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", MIXED_CASES)
def test_mixed_gang_matches_jax_gang(gangs, case):
    _ran(gangs["jax2"], case)
    _ran(gangs["mixed2"], case)
    _same_bits(gangs["mixed2"], gangs["jax2"], case)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", MIXED_CASES)
def test_mixed_ladder_gang_under_faults_matches_jax_gang(gangs, case):
    _ran(gangs["jax2"], case)
    _ran(gangs["mixed2crc"], case)
    _same_bits(gangs["mixed2crc"], gangs["jax2"], case)


@pytest.mark.timeout(240)
def test_gangs_pair_over_shm_and_the_ladder_heals(gangs):
    """The plain gangs pair every rank over shm; in the ladder's gang
    every planned fault fired on both ranks, and the pair ended on TCP
    (failed over in place)."""
    for name in ("port3", "jax3", "mixed2", "jax2"):
        for rank, link in enumerate(gangs[name][2]):
            assert link["media"] and set(link["media"].values()) == \
                {"shm"}, (name, rank, link)
    links = gangs["mixed2crc"][2]
    for rank, link in enumerate(links):
        assert link["media"] == {str(1 - rank): "tcp"}, (rank, link)
        assert link["fired"][1] == 3, (rank, link)
    # The first rank to lose its ring demotes the pair; the other's
    # shm.lost comes due only if it passes the site before the demotion
    # reaches it.
    assert 1 <= sum(link["fired"][0] for link in links) <= 2, links


@pytest.mark.timeout(240)
def test_gangs_exit_cleanly(gangs):
    for name, (runs, _, _) in gangs.items():
        for rank, (code, text) in enumerate(runs):
            assert code == 0, f"{name} rank {rank}:\n{text[-4000:]}"


# The knobs of features ported since the engine's core: each now turns its
# feature on (checked by _ported_knob_is_on).
PORTED_KNOBS = ("HVD_TIMELINE", "HVD_HIERARCHICAL_ALLREDUCE",
                "HVD_HIERARCHICAL_ALLGATHER", "HVD_WIRE_CRC",
                "HOROVOD_FAULT_PLAN", "HVD_HEARTBEAT_TIMEOUT",
                "HOROVOD_HEARTBEAT_TIMEOUT", "HVD_COLLECTIVE_TIMEOUT",
                "HVD_CTRL_TREE", "HVD_CTRL_FANOUT", "HVD_AUTOTUNE",
                "HVD_METRICS", "HVD_METRICS_PORT", "HVD_METRICS_FILE",
                "HVD_STRAGGLER_WARN_MS", "HVD_TRACE", "HVD_ELASTIC_EPOCH")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ported_knob_is_on(monkeypatch, tmp_path, knob, value):
    """Rank 1 through ``hvd.init()`` and rank 0 a ``PyEngine`` on a thread,
    against a live rendezvous, with ``knob`` set on both: ``init()`` does
    not raise, the knob's feature is on, and an allreduce runs."""
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.telemetry import registry as tmx
    from horovod_tpu_torch.telemetry import trace as trace_mod

    if knob == "HVD_TIMELINE":
        value = str(tmp_path / "timeline.json")
    elif knob == "HVD_METRICS_PORT":
        value = str(_free_port())  # the server binds it (local rank 0)
    elif knob == "HVD_METRICS_FILE":
        value = str(tmp_path / "metrics.jsonl")
    elif knob == "HVD_TRACE":
        monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
    telemetry.reset()
    monkeypatch.setenv(knob, value)
    epochs = []
    if knob == "HVD_ELASTIC_EPOCH":
        # Every list frame either rank encodes, by its epoch.
        from horovod_tpu_torch.common import wire

        for fn in ("encode_request_list", "encode_response_list"):
            def spy(*a, _fn=getattr(wire, fn), **kw):
                epochs.append(kw.get("epoch", 0))
                return _fn(*a, **kw)

            monkeypatch.setattr(wire, fn, spy)
    if knob == "HOROVOD_FAULT_PLAN":
        importlib.reload(fi)  # the plan is read at import
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    monkeypatch.setenv("HVD_RENDEZVOUS_PORT", str(port))
    rank0 = {}

    def start0():
        rank0["eng"] = runtime_py.PyEngine(0, 2, 0, 2, 0, 1, "127.0.0.1",
                                           port)

    t = threading.Thread(target=start0)
    t.start()
    try:
        hvd.init(device="cpu", backend="none")
        t.join(60)
        eng0, eng1 = rank0["eng"], basics._engine_obj
        x = np.arange(4, dtype=np.float32)
        h0 = eng0.allreduce_async("knob.x", x, op=hvd.Sum)
        y = hvd.allreduce(x, op=hvd.Sum, name="knob.x")
        np.testing.assert_array_equal(eng0.synchronize(h0), 2 * x)
        np.testing.assert_array_equal(y, 2 * x)
        if knob == "HVD_TIMELINE":
            assert eng0.timeline.enabled and not eng1.timeline.enabled
        elif knob.startswith("HVD_HIERARCHICAL_"):
            attr = knob[len("HVD_"):].lower()
            assert getattr(eng0, attr) and getattr(eng1, attr)
        elif knob == "HVD_WIRE_CRC":
            from horovod_tpu_torch.utils.ladder import LadderLink

            for eng in (eng0, eng1):
                assert all(isinstance(tr, LadderLink)
                           for tr in eng._transports.values())
                assert eng._reconnect_listener is not None
        elif knob.endswith("HEARTBEAT_TIMEOUT"):
            assert eng0.heartbeat_timeout == eng1.heartbeat_timeout == \
                float(value)
        elif knob == "HVD_COLLECTIVE_TIMEOUT":
            assert eng0.collective_timeout == eng1.collective_timeout == \
                float(value)
        elif knob == "HVD_CTRL_FANOUT":
            assert eng0.ctrl_fanout == eng1.ctrl_fanout == int(value)
        elif knob == "HVD_CTRL_TREE":
            # One host: the tree is planned and empty, the flat star.
            assert (eng1._tree_parent, eng1._tree_children) == (None, [])
        elif knob == "HVD_AUTOTUNE":
            # The coordinator tunes; a worker applies its broadcasts.
            assert eng0._pm is not None and eng1._pm is None
        elif knob in ("HVD_METRICS", "HVD_METRICS_PORT",
                      "HVD_METRICS_FILE"):
            assert tmx.enabled() and eng0._metrics_on and eng1._metrics_on
            snap = hvd.metrics_snapshot()
            assert snap["counters"][
                'hvd_collectives_total{op="allreduce",dtype="float32"}'] \
                == 1
            if knob == "HVD_METRICS_PORT":
                assert telemetry.server_port() == int(value)
        elif knob == "HVD_STRAGGLER_WARN_MS":
            # Alone it turns nothing on, as in the JAX package: the
            # detector needs the registry.
            assert not tmx.enabled() and eng0._straggler is None
        elif knob == "HVD_TRACE":
            assert eng0._tracer is not None and eng1._tracer is not None
        elif knob == "HVD_ELASTIC_EPOCH":
            # A gang at epoch 1 negotiates, every frame at epoch 1.
            assert eng0.epoch == eng1.epoch == int(value)
            assert epochs and set(epochs) == {int(value)}, epochs
        else:
            assert fi.active()
    finally:
        stop = threading.Thread(target=lambda: rank0.get("eng") and
                                rank0["eng"].shutdown())
        stop.start()
        hvd.shutdown()
        stop.join(30)
        t.join(5)
        server.stop()
        fi.clear()
        telemetry.reset()
        trace_mod.reset()
    if knob == "HVD_METRICS_FILE":
        recs = [json.loads(line) for line in
                (tmp_path / "metrics.jsonl").read_text().splitlines()]
        assert {r["rank"] for r in recs} <= {0, 1} and recs
    if knob == "HVD_TRACE":
        for r in (0, 1):
            kinds = {json.loads(line)["k"] for line in
                     (tmp_path / f"trace_rank{r}.jsonl").read_text()
                     .splitlines()}
            assert {"meta", "clock", "span"} <= kinds, (r, kinds)
    if knob == "HVD_TIMELINE":
        events = json.loads((tmp_path / "timeline.json").read_text())
        assert ("B", "NEGOTIATE_ALLREDUCE") in {
            (e.get("ph"), e.get("name")) for e in events}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("knob,value", [
    ("HVD_TIMELINE", "/tmp/timeline.json"),
    ("HVD_HIERARCHICAL_ALLREDUCE", "1"),
    ("HVD_HIERARCHICAL_ALLGATHER", "1"),
    ("HVD_WIRE_CRC", "1"),
    ("HVD_HEARTBEAT_TIMEOUT", "2.0"),
    ("HOROVOD_HEARTBEAT_TIMEOUT", "2.0"),
    ("HVD_COLLECTIVE_TIMEOUT", "5"),
    ("HVD_CTRL_TREE", "1"),
    ("HVD_CTRL_FANOUT", "1"),
    ("HVD_AUTOTUNE", "1"),
    ("HVD_METRICS", "1"),
    ("HVD_METRICS_PORT", "9100"),
    ("HVD_METRICS_FILE", "/tmp/metrics.jsonl"),
    ("HVD_STRAGGLER_WARN_MS", "50"),
    ("HVD_TRACE", "1"),
    ("HOROVOD_FAULT_PLAN", '{"faults": []}'),
    ("HVD_ELASTIC_EPOCH", "1"),
])
def test_left_out_knob_raises_at_init(monkeypatch, tmp_path, knob, value):
    """A knob that turns on a feature the port does not run yet stops
    ``init()`` before the rendezvous: no gang, no sockets.  The knobs of
    the features ported since (``PORTED_KNOBS``; the timeline's file goes
    to ``tmp_path``) turn their feature on instead."""
    for k in list(os.environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)
    # A recorder dump lands in the test's directory, not the checkout.
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path / "blackbox"))
    monkeypatch.delenv("HOROVOD_FAULT_PLAN", raising=False)
    monkeypatch.setenv("HVD_RANK", "1")
    monkeypatch.setenv("HVD_SIZE", "2")
    monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_RENDEZVOUS_PORT", "9")  # never dialed
    hvd.shutdown()
    if knob in PORTED_KNOBS:
        _ported_knob_is_on(monkeypatch, tmp_path, knob, value)
        assert not hvd.is_initialized()
        return
    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match=knob):
        hvd.init(device="cpu", backend="none")
    assert not hvd.is_initialized()


@pytest.mark.timeout(120)
def test_clean_two_rank_teardown_writes_no_dump(monkeypatch, tmp_path):
    """Two engines in this process (rank 0 on a thread) run an allreduce
    and shut down at once, as ``_ported_knob_is_on`` does, ten times: no
    engine aborts and the flight recorder dumps nothing.  A clean teardown
    that read as a lost coordinator would make the elastic wrapper see a
    dead hub."""
    from horovod_tpu_torch.telemetry import blackbox

    for k in list(os.environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)
    dump_dir = tmp_path / "blackbox"
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(dump_dir))
    hvd.shutdown()
    x = np.arange(4, dtype=np.float32)
    try:
        for i in range(10):
            server = RendezvousServer("127.0.0.1")
            port = server.start()
            engs = {}

            def start(r):
                engs[r] = runtime_py.PyEngine(r, 2, r, 2, 0, 1,
                                              "127.0.0.1", port)

            threads = [threading.Thread(target=start, args=(r,))
                       for r in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            try:
                hs = [engs[r].allreduce_async(f"td.{i}", x, op=hvd.Sum)
                      for r in (0, 1)]
                for r, h in zip((0, 1), hs):
                    np.testing.assert_array_equal(engs[r].synchronize(h),
                                                  2 * x)
            finally:
                stop = threading.Thread(target=engs[0].shutdown)
                stop.start()
                engs[1].shutdown()
                stop.join(30)
                server.stop()
            for r in (0, 1):
                assert not engs[r]._aborted, (i, r, engs[r]._abort_reason)
    finally:
        blackbox.reset()
    assert not dump_dir.exists() or not os.listdir(dump_dir), \
        os.listdir(dump_dir)
