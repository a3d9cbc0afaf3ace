"""The port's native engine in gangs, bit for bit against the JAX package's
native engine (``tests/torch_port_engine_worker.py``, each gang against
its own ``RendezvousServer``).  Three waves:

1. ``native4``: four port ranks on the default core (``NativeEngine``),
   with ``HVD_TIMELINE``, running every case of
   ``tests/test_torch_engine.py`` (allreduce in every op and wire dtype,
   fusion, ragged allgather, reducescatter, ``sparse_allreduce``,
   broadcast, alltoall with splits, process sets, ``broadcast_object``,
   ``broadcast_parameters``, barrier, the "Mismatched" error, the response
   cache's stats, join) and Adasum, then the dispatcher-op paths of
   ``horovod_tpu_torch.torch`` and the bridge's grouped op under
   ``torch.compile(fullgraph=True)`` against the numpy route; beside it
   ``jaxn4``, four JAX native ranks on the same cases;
2. ``mixed4``: one gang of a port native rank, a JAX native rank, a port
   ``PyEngine`` rank and a JAX ``PyEngine`` rank, each its own process,
   on the same cases; beside it ``native4h``, four port native ranks as
   two hosts of two with ``HVD_HIERARCHICAL_ALLREDUCE=1`` and
   ``HVD_HIERARCHICAL_ALLGATHER=1``;
3. ``jaxn4h``: the JAX native ranks at the same topology and knobs, and
   ``jax4``, four JAX ``PyEngine`` ranks on the cases of wave 1.

Every case's results are the same bits on every rank as the JAX gang's of
the rank's engine (the engines differ in one thing, which the port keeps:
an integer Average comes back from the native engine in the input's type,
and from ``PyEngine`` in numpy's promoted one), and every rank runs the
engine its ``HVD_TPU_CORE`` asks for.
"""

import json
import pickle
import time

import numpy as np
import pytest

import tracing_util
from test_torch_engine import CASES, _finish, _same_bits, _start

GANG_CASES = CASES + ["adasum"]
PORT_CASES = GANG_CASES + ["native_ops"]
HIER_CASES = ["allreduce", "allgather", "fusion", "reducescatter"]
GANG_TIMEOUT = 240.0
NATIVE = {"HVD_TPU_CORE": ""}


def _hier_env(rank):
    return dict(NATIVE, HVD_LOCAL_RANK=str(rank % 2), HVD_LOCAL_SIZE="2",
                HVD_CROSS_RANK=str(rank // 2), HVD_CROSS_SIZE="2",
                HVD_HIERARCHICAL_ALLREDUCE="1",
                HVD_HIERARCHICAL_ALLGATHER="1")


# The mixed gang, rank by rank: (package, HVD_TPU_CORE).
MIXED = [("port-nogroup", ""), ("jax", ""), ("port-nogroup", "py"),
         ("jax", "py")]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_gangs")
    timeline = str(root / "native4" / "timeline.json")
    waves = (
        {"native4": (["port"] * 4, PORT_CASES,
                     dict(NATIVE, HVD_TIMELINE=timeline)),
         "jaxn4": (["jax"] * 4, GANG_CASES, NATIVE)},
        {"mixed4": ([p for p, _ in MIXED], GANG_CASES,
                    lambda r: {"HVD_TPU_CORE": MIXED[r][1]}),
         "native4h": (["port"] * 4, HIER_CASES, _hier_env)},
        {"jaxn4h": (["jax"] * 4, HIER_CASES, _hier_env),
         "jax4": (["jax"] * 4, GANG_CASES, {"HVD_TPU_CORE": "py"})})
    deadline = time.monotonic() + GANG_TIMEOUT
    out = {}
    for plan in waves:
        started = {name: _start(pkgs, cases, str(root / name), env)
                   for name, (pkgs, cases, env) in plan.items()}
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
    out["timeline"] = timeline
    return out


def _ran(gang, case):
    for rank, (code, text) in enumerate(gang[0]):
        assert f"SCENARIO_OK {case}" in text, \
            f"rank {rank} (exit {code}):\n{text[-4000:]}"


@pytest.mark.timeout(360)
@pytest.mark.parametrize("case", GANG_CASES)
def test_native_port_gang_matches_jax_native_gang(gangs, case):
    _ran(gangs["jaxn4"], case)
    _ran(gangs["native4"], case)
    _same_bits(gangs["native4"], gangs["jaxn4"], case)


@pytest.mark.timeout(360)
@pytest.mark.parametrize("case", GANG_CASES)
def test_mixed_engines_gang_matches_jax_gangs(gangs, case):
    """Each rank of the mixed gang against the same rank of the JAX gang
    of its engine; the "Mismatched" error's text, which the coordinator
    (rank 0, native) words for every rank, against the native gang's."""
    _ran(gangs["jaxn4"], case)
    _ran(gangs["jax4"], case)
    _ran(gangs["mixed4"], case)
    ref = {"": gangs["jaxn4"], "py": gangs["jax4"]}
    for rank, (_, core) in enumerate(MIXED):
        want = ref["" if case == "mismatch" else core]
        _same_bits((None, gangs["mixed4"][1][rank:rank + 1]),
                   (None, want[1][rank:rank + 1]), case)


@pytest.mark.timeout(360)
@pytest.mark.parametrize("case", HIER_CASES)
def test_hierarchical_native_gang_matches_jax(gangs, case):
    _ran(gangs["jaxn4h"], case)
    _ran(gangs["native4h"], case)
    _same_bits(gangs["native4h"], gangs["jaxn4h"], case)


@pytest.mark.timeout(360)
def test_every_rank_runs_the_engine_it_asks_for(gangs):
    forced = "HVD_TPU_CORE forces the Python engine"
    want = {"native4": [["NativeEngine", None]] * 4,
            "jaxn4": [["NativeEngine", None]] * 4,
            "native4h": [["NativeEngine", None]] * 4,
            "jaxn4h": [["NativeEngine", None]] * 4,
            "jax4": [["PyEngine", forced]] * 4,
            "mixed4": [["NativeEngine", None], ["NativeEngine", None],
                       ["PyEngine", forced], ["PyEngine", forced]]}
    for name, engines in want.items():
        got = [link.get("engine") for link in gangs[name][2]]
        assert got == engines, (name, got)
    # The port's two-level collectives ran: both flags on at a block
    # topology (the JAX native engine does not report its flags).
    for rank, link in enumerate(gangs["native4h"][2]):
        assert link["hierarchical"] == [True, True, True], (rank, link)


@pytest.mark.timeout(360)
def test_gangs_exit_cleanly(gangs):
    for name, gang in gangs.items():
        if name == "timeline":
            continue
        for rank, (code, text) in enumerate(gang[0]):
            assert code == 0, f"{name} rank {rank}:\n{text[-4000:]}"


def _bits(gang, rank, key):
    return gang[1][rank]["native_ops"][key]


@pytest.mark.timeout(360)
def test_dispatcher_ops_and_bridge_match_numpy_route(gangs):
    """The dispatcher ops (``torch.ops.hvd.*``) and the bridge's grouped
    op (``hvd::grouped_allreduce``) give the numpy route's bits, every
    call went through them, and the compiled step has no graph break."""
    gang = gangs["native4"]
    _ran(gang, "native_ops")
    for rank in range(4):
        res = gang[1][rank]["native_ops"]
        pairs = [k for k in res if isinstance(k, tuple) and
                 k[-1] == "native"]
        assert len(pairs) == 5 * 4 + 3
        for key in pairs:
            got = res[key]
            want = res[key[:-1] + ("numpy",)]
            assert got[:2] == want[:2], (rank, key, got[:2], want[:2])
            assert got[2] == want[2], f"rank {rank} {key}: the bits differ"
        assert res["graph_breaks"][2] == np.zeros(1, np.int64).tobytes()
        # Per dtype: the autograd allreduce, allreduce_, allgather and
        # broadcast once each; one grouped call.
        np.testing.assert_array_equal(
            np.frombuffer(res["dispatched"][2], np.int64), [5, 5, 5, 5, 1])
        # And the same bits on every rank (rank 0's).
        for key in pairs:
            assert res[key] == _bits(gang, 0, key), (rank, key)


@pytest.mark.timeout(360)
def test_native_timeline_written_by_the_core(gangs):
    """Rank 0's core writes the timeline: negotiation and execution of a
    named allreduce on its tensor's lane."""
    events = tracing_util.parse_timeline_file(gangs["timeline"])
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    lane = [e.get("name") for e in events if e and e.get("ph") != "M" and
            names.get(e.get("tid")) == "ar.float32.SUM.1.0"]
    assert "NEGOTIATE_ALLREDUCE" in lane and "ALLREDUCE" in lane, lane
