"""The port's eager engine in gangs, bit for bit against the JAX package's
``PyEngine``.

Four gangs run once per module, two at a time, so that at most six
worker processes share the machine (``tests/torch_port_engine_worker.py``,
each gang against its own ``RendezvousServer``):

* a port gang of 3 and a JAX gang of 3 (``HVD_TPU_CORE=py``) on the same
  seeded inputs: every case's results must be the same bits on every rank;
* a mixed gang of 2 (rank 0 a JAX ``PyEngine``, rank 1 the port, with
  ``HVD_CTRL_TREE=0``) and a JAX gang of 2: the mixed gang completes every
  case, Adasum included (a power of two), with the JAX gang's bits.

The cases: allreduce with every op, with and without pre- and postscale,
in fp32, bf16, fp16, int32 and both fp8 wire types (NaN, infinities and
fp8 overflow among the inputs), and through the compressors; fusion of
many small tensors; ragged allgather; reducescatter; ``sparse_allreduce``;
broadcast; alltoall with splits; process sets; ``broadcast_object``;
``broadcast_parameters``; barrier; a "Mismatched" shape error on every
rank, after which the engine works; response-cache hits on repeated steps;
join.  Each case is its own test over the module's gangs.

Every knob that turns on a feature the port leaves out raises
``NotImplementedError`` at ``init()``; those tests start no gang.
"""

import os
import pickle
import subprocess
import sys
import time

import pytest

import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_engine_worker.py")

CASES = ["allreduce", "fusion", "allgather", "reducescatter",
         "sparse_allreduce",
         "broadcast", "alltoall", "process_sets", "broadcast_object",
         "broadcast_parameters", "barrier", "mismatch", "cache", "join"]
MIXED_CASES = CASES + ["adasum"]
GANG_TIMEOUT = 150.0


def _start(pkgs, cases, out_dir):
    """Start one gang (one worker per entry of ``pkgs``) against its own
    rendezvous server; returns (server, processes)."""
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
                   HVD_CTRL_TREE="0", JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, pkg, ",".join(cases), out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
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
              "jax2": (["jax"] * 2, MIXED_CASES)})
    deadline = time.monotonic() + GANG_TIMEOUT
    out = {}
    for plan in waves:
        started = {name: _start(pkgs, cases, str(root / name))
                   for name, (pkgs, cases) in plan.items()}
        for name, (server, procs) in started.items():
            runs = _finish(server, procs, deadline)
            results = []
            for rank in range(len(procs)):
                path = root / name / f"rank{rank}.pkl"
                results.append(pickle.loads(path.read_bytes())
                               if path.exists() else {})
            out[name] = (runs, results)
    return out


def _ran(gang, case):
    runs, _ = gang
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
def test_gangs_exit_cleanly(gangs):
    for name, (runs, _) in gangs.items():
        for rank, (code, text) in enumerate(runs):
            assert code == 0, f"{name} rank {rank}:\n{text[-4000:]}"


@pytest.mark.parametrize("knob,value", [
    ("HVD_TIMELINE", "/tmp/timeline.json"),
    ("HVD_HIERARCHICAL_ALLREDUCE", "1"),
    ("HVD_HIERARCHICAL_ALLGATHER", "1"),
    ("HVD_WIRE_CRC", "1"),
    ("HVD_HEARTBEAT_TIMEOUT", "2.0"),
    ("HOROVOD_HEARTBEAT_TIMEOUT", "2.0"),
    ("HVD_COLLECTIVE_TIMEOUT", "5"),
    ("HVD_AUTOTUNE", "1"),
    ("HVD_METRICS", "1"),
    ("HVD_METRICS_PORT", "9100"),
    ("HVD_METRICS_FILE", "/tmp/metrics.jsonl"),
    ("HVD_STRAGGLER_WARN_MS", "50"),
    ("HVD_TRACE", "1"),
    ("HOROVOD_FAULT_PLAN", '{"faults": []}'),
    ("HVD_ELASTIC_EPOCH", "1"),
])
def test_left_out_knob_raises_at_init(monkeypatch, knob, value):
    """A knob that turns on a feature the port does not run yet stops
    ``init()`` before the rendezvous: no gang, no sockets."""
    for k in list(os.environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("HVD_RANK", "1")
    monkeypatch.setenv("HVD_SIZE", "2")
    monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_RENDEZVOUS_PORT", "9")  # never dialed
    monkeypatch.setenv(knob, value)
    hvd.shutdown()
    with pytest.raises(NotImplementedError, match=knob):
        hvd.init(device="cpu", backend="none")
    assert not hvd.is_initialized()
