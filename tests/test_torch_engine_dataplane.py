"""The port's engine data plane in gangs, against the JAX package's
``PyEngine`` (``tests/torch_port_engine_worker.py``, each gang against its
own ``RendezvousServer``).

Two waves of at most six processes:

* a port gang of 4 and a JAX gang of 4 as two virtual nodes of two ranks
  (``HVD_LOCAL_*``/``HVD_CROSS_*``; the control tree on, so rank 2 folds
  rank 3's control frames) with
  ``HVD_HIERARCHICAL_ALLREDUCE=1`` and ``HVD_HIERARCHICAL_ALLGATHER=1``;
  ranks 2-3 run with ``HVD_SHM_DISABLE=1``, so node 0's pair is shm and
  every other pair TCP.  Every case gives the JAX gang's bits;
* a port gang of 2 and a JAX gang of 2 with ``HVD_TIMELINE``: rank 0's
  files parse (``tests/tracing_util.py``) and hold the same multiset of
  ``(ph, name)`` events per tensor lane, a hostile tensor name included,
  and the same integrity instants (the guard's ``NONFINITE_SKIP``, the
  audit's ``DIVERGENCE_DETECTED``, the checkpoint's
  ``CKPT_VERIFY_FAIL``).
"""

import collections
import glob
import json
import pickle
import time

import pytest

import tracing_util
from test_torch_engine import _finish, _same_bits, _start

HIER_CASES = ["allreduce", "allgather", "fusion"]
TIMELINE_CASES = ["timeline_ops", "instants"]
GANG_TIMEOUT = 150.0


def _hier_env(rank):
    env = dict(HVD_LOCAL_RANK=str(rank % 2), HVD_LOCAL_SIZE="2",
               HVD_CROSS_RANK=str(rank // 2), HVD_CROSS_SIZE="2",
               HVD_HIERARCHICAL_ALLREDUCE="1",
               HVD_HIERARCHICAL_ALLGATHER="1")
    if rank >= 2:
        env["HVD_SHM_DISABLE"] = "1"
    return env


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataplane_gangs")
    tl = {"HVD_TIMELINE": None, "HVD_TIMELINE_MARK_CYCLES": "1"}
    waves = ({"port4h": (["port"] * 4, HIER_CASES, _hier_env),
              "port2tl": (["port"] * 2, TIMELINE_CASES, tl)},
             {"jax4h": (["jax"] * 4, HIER_CASES, _hier_env),
              "jax2tl": (["jax"] * 2, TIMELINE_CASES, tl)})
    deadline = time.monotonic() + GANG_TIMEOUT
    out = {}
    for plan in waves:
        started = {}
        for name, (pkgs, cases, extra) in plan.items():
            out_dir = root / name
            if isinstance(extra, dict):
                extra = dict(extra, HVD_TIMELINE=str(out_dir /
                                                     "timeline.json"))
            started[name] = _start(pkgs, cases, str(out_dir), extra)
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
            out[name] = (runs, results, links, root / name,
                         [p.pid for p in procs])
    return out


def _ran(gang, case):
    for rank, (code, text) in enumerate(gang[0]):
        assert f"SCENARIO_OK {case}" in text, \
            f"rank {rank} (exit {code}):\n{text[-4000:]}"


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", HIER_CASES)
def test_hierarchical_port_gang_matches_jax_gang(gangs, case):
    _ran(gangs["jax4h"], case)
    _ran(gangs["port4h"], case)
    _same_bits(gangs["port4h"], gangs["jax4h"], case)


@pytest.mark.timeout(240)
def test_hierarchical_gangs_pair_node0_over_shm(gangs):
    """Node 0's pair over shm, every pair with a rank of node 1 (under
    ``HVD_SHM_DISABLE``) over TCP, in both packages."""
    want = {0: {"1": "shm", "2": "tcp", "3": "tcp"},
            1: {"0": "shm", "2": "tcp", "3": "tcp"},
            2: {"0": "tcp", "1": "tcp", "3": "tcp"},
            3: {"0": "tcp", "1": "tcp", "2": "tcp"}}
    for name in ("port4h", "jax4h"):
        for rank, link in enumerate(gangs[name][2]):
            assert link.get("media") == want[rank], (name, rank, link)
            # Both flags on and the block topology recognized: the cases
            # ran the two-level collectives.
            assert link["hierarchical"] == [True, True, True], (name, rank)
            # The control tree: rank 2 is host 1's sub-coordinator.
            assert link["tree"] == {2: [None, [3]], 3: [2, []]}.get(
                rank, [None, []]), (name, rank, link)


@pytest.mark.timeout(240)
def test_gangs_exit_cleanly_and_leave_no_shm(gangs):
    for name, (runs, _, _, _, pids) in gangs.items():
        for rank, (code, text) in enumerate(runs):
            assert code == 0, f"{name} rank {rank}:\n{text[-4000:]}"
            assert "leaked shared_memory" not in text, (name, rank)
        for pid in pids:
            assert not glob.glob(f"/dev/shm/hvd-shm-{pid}-*"), name


def _lanes(events):
    """{tensor name: Counter of (ph, name)} from a parsed timeline, and the
    process lane's instants as [(name, args)]."""
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    lanes = collections.defaultdict(collections.Counter)
    instants = []
    for e in events:
        if not e or e.get("ph") == "M":
            continue
        if e["tid"] == 0:
            instants.append((e.get("name"), e.get("args", {})))
        else:
            lanes[names[e["tid"]]][(e["ph"], e.get("name"))] += 1
    return lanes, instants


@pytest.mark.timeout(240)
def test_timeline_events_match_jax_per_tensor(gangs):
    for name in ("port2tl", "jax2tl"):
        _ran(gangs[name], "timeline_ops")
        _ran(gangs[name], "instants")
    port, _ = _lanes(tracing_util.parse_timeline_file(
        str(gangs["port2tl"][3] / "timeline.json")))
    jax, _ = _lanes(tracing_util.parse_timeline_file(
        str(gangs["jax2tl"][3] / "timeline.json")))
    # The JAX package's guard and audit run through its eager engine (the
    # port's through torch.distributed): those lanes are the JAX file's
    # alone.
    extra = set(jax) - set(port)
    assert all(n.startswith("integrity.") for n in extra), extra
    assert set(port) <= set(jax)
    for lane in port:
        assert port[lane] == jax[lane], lane
    # The worker's hostile name (quotes, backslashes, a newline, JSON
    # punctuation, non-ASCII) came through JSON intact.
    hostile = [n for n in port if n.startswith('we"ird')]
    assert hostile == ['we"ird\\na\nme {}],\u00e9'], hostile
    assert port[hostile[0]][("B", "ALLREDUCE")] == 2
    assert port[hostile[0]][("i", "RANK_1_READY")] == 2


@pytest.mark.timeout(240)
def test_timeline_instants_match_jax(gangs):
    """Both files close with the footer, mark cycles, and hold the same
    integrity instants with the same arguments (bar the checkpoint's
    path and the audit's digests and leaf path, which each package
    spells its own way)."""
    got = {}
    for name in ("port2tl", "jax2tl"):
        path = gangs[name][3] / "timeline.json"
        text = path.read_text()
        assert text.rstrip().endswith("{}]"), name
        events = json.loads(text)
        _, instants = _lanes(events)
        assert any(n == "CYCLE_START" for n, _ in instants), name
        assert instants[0][0] == "CLOCK_ANCHOR", name
        got[name] = [(n, {k: v for k, v in a.items()
                          if k not in ("path", "digests", "leaf")})
                     for n, a in instants
                     if n not in ("CLOCK_ANCHOR", "CYCLE_START")]
    assert got["port2tl"] == got["jax2tl"]
    assert [n for n, _ in got["port2tl"]] == [
        "NONFINITE_SKIP", "DIVERGENCE_DETECTED", "CKPT_VERIFY_FAIL"]
    assert got["port2tl"][0][1] == {"serial": 1, "policy": "skip",
                                    "consecutive": 1}
    assert got["port2tl"][1][1] == {"ranks": [1]}
    assert got["port2tl"][2][1]["reason"].startswith("sha256 mismatch")
