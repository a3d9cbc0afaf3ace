"""The port's control tree against the JAX package's
(``tests/test_ctrl_tree.py`` is the JAX side's own).

* ``_plan_tree`` gives the JAX engine's ``(parent, children, route)`` for
  every rank of a grid of sizes, local sizes, fan-outs, block and
  non-block layouts, with the tree on and off.
* The tree codecs (``TAG_TREE_UP``, ``TAG_TREE_DOWN``, ``TAG_REPARENT``)
  are the JAX package's bytes, both ways.
* Port gangs of two hosts of three ranks (``tests/torch_port_chaos_worker.py
  tree_subcoord_steps``, liveness on), started together: host 1's
  sub-coordinator (rank 3) killed after step 2, so that its children 4 and
  5 re-parent, the in-flight step completes over the five survivors and
  only ``[3]`` is named; ``ctrl.subcoord.send`` failing on rank 3
  (``tests/test_ctrl_tree.py``'s case: the fault stays on that host); and
  ``ctrl.reparent`` failing on orphan 4 (it aborts as a lost coordinator,
  and the rest ride on).
* Mixed gangs of two hosts of two with ``HVD_CTRL_TREE`` unset
  (``tests/torch_port_engine_worker.py``): a port sub-coordinator with a
  JAX child, and a JAX sub-coordinator with a port child, each with the
  other package's root; every case's bits are a JAX gang's of the same
  shape.
"""

import itertools
import json
import pickle
import re
import time

import pytest

from horovod_tpu_torch.common import wire
from horovod_tpu_torch.utils import socketutil as su
from test_torch_engine import _finish as _finish_engine
from test_torch_engine import _same_bits
from test_torch_engine import _start as _start_engine
from test_torch_liveness import (FAULT_PLAN, HEARTBEAT_ENV, KILL_PLAN,
                                 _finish, _start, _steps)

GANG_TIMEOUT = 150.0
TREE_CASES = ["allreduce", "fusion", "allgather", "broadcast", "barrier"]


class _Topo:
    """Just enough of an engine for ``PyEngine._plan_tree``."""

    def __init__(self, rank, size, local_size, fanout, block):
        self.rank = rank
        self.size = size
        self.local_size = local_size
        self.cross_size = max(1, size // local_size)
        self.ctrl_fanout = fanout
        self._block = block

    def hierarchical_topology_ok(self):
        return self._block


@pytest.mark.parametrize("tree_on", ["1", "0"])
def test_plan_tree_matches_jax(monkeypatch, tree_on):
    from horovod_tpu.runtime_py import PyEngine as JaxEngine

    from horovod_tpu_torch.runtime_py import PyEngine

    monkeypatch.setenv("HVD_CTRL_TREE", tree_on)
    n = 0
    for size, ls, fanout, block in itertools.product(
            (1, 2, 4, 6, 8, 9, 12, 16), (1, 2, 3, 4), (0, 1, 2, 5),
            (True, False)):
        for rank in range(size):
            topo = _Topo(rank, size, ls, fanout, block)
            want = JaxEngine._plan_tree(topo)
            assert PyEngine._plan_tree(topo) == want, \
                (rank, size, ls, fanout, block, want)
            n += bool(want[1]) or want[0] is not None
    assert (n > 0) == (tree_on == "1")


def test_plan_tree_two_hosts_of_three():
    from horovod_tpu_torch.runtime_py import PyEngine

    route = {4: 3, 5: 3}
    assert PyEngine._plan_tree(_Topo(0, 6, 3, 0, True)) == \
        (None, [], route)
    assert PyEngine._plan_tree(_Topo(3, 6, 3, 0, True)) == \
        (None, [4, 5], route)
    assert PyEngine._plan_tree(_Topo(5, 6, 3, 0, True))[0] == 3
    assert PyEngine._plan_tree(_Topo(3, 6, 3, 1, True)) == \
        (None, [4], {4: 3})


def test_tree_codecs_byte_equal_to_jax_both_ways():
    from horovod_tpu.common import wire as jwire

    entries = [(4, su.TAG_REQUEST_LIST, b"\x00\x01payload"),
               (5, su.TAG_HEARTBEAT, b""), (3, su.TAG_PROBE_ACK, b"ack")]
    for ents, epoch in ((entries, 0), (entries[:1], 7), ([], 2)):
        blob = wire.encode_tree_up(ents, epoch=epoch)
        assert blob == jwire.encode_tree_up(ents, epoch=epoch)
        assert wire.decode_tree_up(blob) == jwire.decode_tree_up(blob) == \
            (ents, epoch)
    for args in ((4, su.TAG_PROBE, b""), (-1, su.TAG_ABORT_VERDICT, b"v")):
        blob = wire.encode_tree_down(*args)
        assert blob == jwire.encode_tree_down(*args)
        assert wire.decode_tree_down(blob) == \
            jwire.decode_tree_down(blob) == args
    for args in ((4, 3, 0), (5, 3, 9)):
        blob = wire.encode_reparent(*args)
        assert blob == jwire.encode_reparent(*args)
        assert tuple(wire.decode_reparent(blob)) == \
            tuple(jwire.decode_reparent(blob)) == args


# ---------------------------------------------------------------------------
# port gangs of two hosts of three
# ---------------------------------------------------------------------------

SUBCOORD_SEND_PLAN = json.dumps({"faults": [
    {"site": "ctrl.subcoord.send", "kind": "error", "times": 1,
     "after": 2}]})
REPARENT_PLAN = json.dumps({"faults": [
    {"site": "ctrl.reparent", "kind": "error"}]})
BOUNDED_ENV = dict(HEARTBEAT_ENV, HVD_COLLECTIVE_TIMEOUT="8")


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree_gangs")
    tl = str(root / "kill" / "timeline.json")
    spec = {
        "kill": (HEARTBEAT_ENV, {3: {FAULT_PLAN: KILL_PLAN},
                                 0: {"HVD_TIMELINE": tl}}),
        "subcoord_send": (BOUNDED_ENV, {3: {FAULT_PLAN:
                                            SUBCOORD_SEND_PLAN}}),
        "reparent": (BOUNDED_ENV, {3: {FAULT_PLAN: KILL_PLAN},
                                   4: {FAULT_PLAN: REPARENT_PLAN}}),
    }
    started = {name: _start(["port"] * 6, "tree_subcoord_steps",
                            str(root / name), local_size=3,
                            base_env=base, rank_env=rank_env)
               for name, (base, rank_env) in spec.items()}
    deadline = time.monotonic() + GANG_TIMEOUT
    out = {name: _finish(g, deadline) for name, g in started.items()}
    with open(tl) as fh:
        out["kill_timeline"] = fh.read()
    return out


def _tree_line(out):
    m = re.search(r"TREE rank=(\d+) parent=(\S+) orphaned=(\S+) "
                  r"reparented=(\[.*?\])", out)
    assert m, out
    return {"rank": int(m.group(1)), "parent": m.group(2),
            "orphaned": m.group(3) == "True",
            "reparented": json.loads(m.group(4))}


def _failed(out):
    m = re.search(r"RANKS_FAILED (\[[^\]]*\])", out)
    return set(json.loads(m.group(1))) if m else None


@pytest.mark.timeout(300)
def test_subcoord_sigkill_children_reparent_only_victim_evicted(gangs):
    """Rank 3 (host 1's sub-coordinator) dies after step 2: 4 and 5
    re-parent to the root, the in-flight step completes over the five
    survivors, RanksFailedError names [3] alone, no abort ran, and the
    root's timeline holds SUBCOORD_REPARENT."""
    outs = gangs["kill"]
    v_code, v_out = outs[3]
    assert v_code == 137, (v_code, v_out)
    assert dict(_steps(v_out))[2] == 6.0, v_out
    for rank in (0, 1, 2, 4, 5):
        code, out = outs[rank]
        assert code == 0, (rank, out)
        assert "RANKS_FAILED [3]" in out, (rank, out)
        assert "COLLECTIVE_ABORT" not in out, (rank, out)
        steps = dict(_steps(out))
        assert steps[2] == 6.0, (rank, steps)
        assert any(v == 5.0 for s, v in steps.items() if s >= 3), steps
    for child in (4, 5):
        t = _tree_line(outs[child][1])
        assert t["orphaned"] and t["parent"] == "3", outs[child][1]
    assert _tree_line(outs[0][1])["reparented"] == [4, 5], outs[0][1]
    assert "SUBCOORD_REPARENT" in gangs["kill_timeline"]
    assert "COLLECTIVE_ABORT" not in gangs["kill_timeline"]


@pytest.mark.timeout(300)
def test_subcoord_send_fault_isolated_to_that_host(gangs):
    """``ctrl.subcoord.send`` fails once on rank 3: it aborts as a lost
    coordinator (17); the root's host rides on with a failed set that
    holds 3 and stays within host 1; a child exits 0 re-parented, or 17
    if the bounded collective's verdict named it."""
    outs = gangs["subcoord_send"]
    assert outs[3][0] == 17, outs[3]
    for rank in (0, 1, 2):
        code, out = outs[rank]
        assert code == 0, (rank, out)
        failed = _failed(out)
        assert failed and 3 in failed and failed <= {3, 4, 5}, (rank, out)
    for child in (4, 5):
        code, out = outs[child]
        assert code in (0, 17), (child, code, out)
        if code == 0:
            assert _tree_line(out)["orphaned"], out


@pytest.mark.timeout(300)
def test_reparent_fault_child_falls_back_to_abort(gangs):
    """Rank 3 dies and orphan 4's ``TAG_REPARENT`` fails: 4 aborts as a
    lost coordinator (17), 5 re-parents, and the others ride on with a
    failed set within {3, 4}."""
    outs = gangs["reparent"]
    assert outs[3][0] == 137, outs[3]
    assert outs[4][0] == 17, outs[4]
    for rank in (0, 1, 2, 5):
        code, out = outs[rank]
        assert code == 0, (rank, out)
        failed = _failed(out)
        assert failed and failed <= {3, 4}, (rank, out)
    assert _tree_line(outs[5][1])["orphaned"], outs[5][1]


# ---------------------------------------------------------------------------
# mixed gangs of two hosts of two, the tree on by default
# ---------------------------------------------------------------------------


def _two_hosts(rank):
    return dict(HVD_LOCAL_RANK=str(rank % 2), HVD_LOCAL_SIZE="2",
                HVD_CROSS_RANK=str(rank // 2), HVD_CROSS_SIZE="2")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree_mixed")
    spec = {"port_sub": ["jax", "port-nogroup", "port-nogroup", "jax"],
            "jax_sub": ["port-nogroup", "jax", "jax", "port-nogroup"],
            "jax4": ["jax"] * 4}
    started = {name: _start_engine(pkgs, TREE_CASES, str(root / name),
                                   _two_hosts)
               for name, pkgs in spec.items()}
    deadline = time.monotonic() + GANG_TIMEOUT
    out = {}
    for name, (server, procs) in started.items():
        runs = _finish_engine(server, procs, deadline)
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


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["port_sub", "jax_sub"])
@pytest.mark.parametrize("case", TREE_CASES)
def test_mixed_tree_gang_matches_jax_gang(mixed, name, case):
    for gang in (mixed["jax4"], mixed[name]):
        for rank, (code, text) in enumerate(gang[0]):
            assert f"SCENARIO_OK {case}" in text, \
                f"rank {rank} (exit {code}):\n{text[-4000:]}"
    _same_bits(mixed[name], mixed["jax4"], case)


@pytest.mark.timeout(300)
def test_mixed_tree_gangs_plan_the_tree_and_exit_cleanly(mixed):
    want = [[None, []], [None, []], [None, [3]], [2, []]]
    for name, (runs, _, links) in mixed.items():
        assert [link.get("tree") for link in links] == want, (name, links)
        for rank, (code, text) in enumerate(runs):
            assert code == 0, f"{name} rank {rank}:\n{text[-4000:]}"
