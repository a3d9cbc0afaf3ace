"""A gloo process group re-formed by ``@hvd.elastic.run`` at every epoch.

One CPU gang of three ranks of ``tests/torch_port_elastic_worker.py
group``, each of which formed a gloo group before entering the wrapper
(``init_torch_distributed``, then ``hvd.init(device="cpu")``), runs four
epochs:

* epoch 0, three ranks: every step allreduces one exactly representable
  tensor over the mesh's ``dp`` axis (the group) and through the eager
  engine, bit for bit equal; rank 0 is SIGKILLed (an injected ``kill``)
  before its group collective of step 2;
* epoch 1: the survivors re-form a group of two, the promoted rank 0
  publishing the new store's address under the epoch's scope, and the
  last incarnation's mesh axis raises ``StaleMeshError``;
* epoch 2: a joiner, started once the survivors run at epoch 1, takes the
  backend from its grant and enters the group of three;
* epoch 3: a peer stalls (an injected ``stall``) before its group
  collective; the others' collective fails at the group's timeout, the
  collective deadline (3 s, not gloo's 30 minutes), the engine's verdict
  names the stalled rank in a ``CollectiveTimeoutError``, and the two
  survivors finish.

The gang's knobs are ``tests/test_torch_elastic.py``'s (heartbeats at 2 s
every 0.25 s) with ``HVD_SHM_DISABLE=1``.

Two more gangs of four (``torch_port_elastic_worker.py group_abort``, a dp
2 x tp 2 mesh, rank 3 SIGKILLed before its group collective of step 2),
started together, both with liveness off (the launcher's default): one
whose ranks asked for NCCL (formed over gloo by a stand-in,
``GROUP_FAKE_NCCL=1``) and wait, as an NCCL collective with a dead peer
does, until the groups' abort frees them; and one on gloo, the control.
With NCCL the coordinator evicts rank 3 once its control link drops, and
the eviction aborts the world group and each mesh subgroup
(``basics.abort_process_groups``, recorded at torch's
``_abort_process_group``): the pending wait ends, the next collective
raises ``GroupAbortedError`` and the gang re-forms at three.  On gloo
nothing is evicted or aborted: the failed collective's verdict re-forms
the gang as before.
"""

import json
import os
import re

import pytest

from test_torch_elastic import finish_gang, start_gang

DEADLINE_S = 3.0
PROBE_S = 1.0


def _plan(fault):
    return json.dumps({"faults": [dict(site="train.step", **fault)]})


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    cwd = str(tmp_path_factory.mktemp("elastic_group"))
    g = start_gang(
        ["port"] * 3, cwd, min_np=2, max_np=3, scenario="group",
        base_env={"HVD_COLLECTIVE_TIMEOUT": str(DEADLINE_S),
                  "HVD_COLLECTIVE_PROBE_TIMEOUT": str(PROBE_S),
                  "OMP_NUM_THREADS": "1"},
        rank_env={0: {"HOROVOD_FAULT_PLAN": _plan(
                      {"kind": "kill", "match": "e0.s2."})},
                  2: {"HOROVOD_FAULT_PLAN": _plan(
                      {"kind": "stall", "stall_s": 3600,
                       "match": "e2.", "after": 1})}},
        joiner="port", joiner_after="STEP 3 e1 ", joiner_watch=1)
    outs = finish_gang(g, timeout=120.0, stalled=(2,))
    return {"uid-0": outs[0], "uid-1": outs[1], "uid-2": outs[2],
            "joiner": outs[3]}


def _steps(out):
    return [(int(s), int(e), int(n), same == "True", float(v))
            for s, e, n, _r, same, v in re.findall(
                r"STEP (\d+) e(\d+) size (\d+) rank (\d+) same (\w+) "
                r"([\d.]+)", out)]


def _groups(out):
    return {int(e): (int(r), int(n), b, st) for e, r, n, b, st in
            re.findall(r"GROUP epoch (\d+) rank (\d+) size (\d+) backend "
                       r"(\w+) store (\S+)", out)}


def test_every_step_group_equals_engine_bit_for_bit(gang):
    for uid in ("uid-1", "joiner"):
        rc, out = gang[uid]
        assert rc == 0, out
        steps = _steps(out)
        assert steps and all(same for *_, same, _v in steps), out
    # Each step's sum over the gang: sum_r (r + 1) * 28 + 8 * 0.25 * step
    # * n, whichever epoch ran it.
    for s, e, n, _same, v in _steps(gang["uid-1"][1]):
        assert v == 28 * n * (n + 1) / 2 + 2.0 * s * n, (s, e, n, v)


def test_rank0_killed_survivors_reform_group_of_two(gang):
    rc0, out0 = gang["uid-0"]
    assert rc0 == 137, out0
    rc1, out1 = gang["uid-1"]
    assert "RESET size 2 epoch 1" in out1, out1
    g1 = _groups(out1)
    g2 = _groups(gang["uid-2"][1])
    # The promoted rank 0 (uid-1) and uid-2 share the epoch's new store.
    assert g1[1][:3] == (0, 2, "gloo") and g2[1][:3] == (1, 2, "gloo")
    assert g1[1][3] == g2[1][3] != g1[0][3]
    assert "STALE StaleMeshError" in out1 and "STALE none" not in out1
    # The rollback: the steps of epoch 1 resume from the last commit.
    assert [s for s, e, *_ in _steps(out1) if e == 1][0] == 2


def test_joiner_enters_the_group_at_the_next_epoch(gang):
    rcj, outj = gang["joiner"]
    assert rcj == 0, outj
    gj = _groups(outj)
    assert min(gj) == 2 and gj[2][1:3] == (3, "gloo"), outj
    g1 = _groups(gang["uid-1"][1])
    assert gj[2][3] == g1[2][3], (gj, g1)
    assert "RESET size 3 epoch 2" in gang["uid-1"][1]


def test_stalled_group_peer_ends_in_typed_error_within_deadline(gang):
    _rc2, out2 = gang["uid-2"]
    assert "(running when killed: True)" in out2, out2
    for uid in ("uid-1", "joiner"):
        rc, out = gang[uid]
        assert rc == 0, out
        err = re.search(r"GROUP_ERR e2\.s(\d+) t ([\d.]+)", out)
        reset = re.search(r"RESET size 2 epoch 3 t ([\d.]+) verdict "
                          r"(\w+) (\[.*\])", out)
        assert err and reset, out
        # The stalled rank was rank 1 of epoch 2.
        assert reset.group(2) == "CollectiveTimeoutError", out
        assert json.loads(reset.group(3)) == [1], out
        dt = float(reset.group(1)) - float(err.group(2))
        assert DEADLINE_S - 0.5 < dt < DEADLINE_S + PROBE_S + 10.0, dt
        g = _groups(out)
        assert g[3][1:3] == (2, "gloo"), out
        assert len([1 for _s, e, *_ in _steps(out) if e == 3]) == 3, out


@pytest.fixture(scope="module")
def abort_gangs(tmp_path_factory):
    gangs = {}
    for mode in ("nccl", "gloo"):
        # The launcher's default: liveness off.
        env = {"HVD_COLLECTIVE_TIMEOUT": str(DEADLINE_S),
               "HVD_COLLECTIVE_PROBE_TIMEOUT": str(PROBE_S),
               "HVD_HEARTBEAT_TIMEOUT": "0", "OMP_NUM_THREADS": "1"}
        if mode == "nccl":
            env["GROUP_FAKE_NCCL"] = "1"
        gangs[mode] = start_gang(
            ["port"] * 4, str(tmp_path_factory.mktemp(f"abort_{mode}")),
            min_np=2, max_np=4, scenario="group_abort", base_env=env,
            rank_env={3: {"HOROVOD_FAULT_PLAN": _plan(
                {"kind": "kill", "match": "e0.s2."})}})
    return {mode: finish_gang(g, timeout=120.0) for mode, g in gangs.items()}


def _abort_lines(out):
    return [(t, json.loads(r), json.loads(g)) for t, r, g in re.findall(
        r"ABORT thread (\S+) reason (\[.*?\]) groups (\[.*\])", out)]


@pytest.mark.parametrize("mode", ["nccl", "gloo"])
def test_eviction_aborts_nccl_groups_gloo_unchanged(abort_gangs, mode):
    outs = abort_gangs[mode]
    assert outs[3][0] == 137, outs[3][1]
    for r in range(3):
        rc, out = outs[r]
        assert rc == 0, out
        mesh = re.search(r"MESH epoch 0 rank (\d) backend (\w+) axes "
                         r"(\[.*\])", out)
        assert mesh and mesh.group(2) == mode, out
        tp, dp = json.loads(mesh.group(3))
        aborts = _abort_lines(out)
        if mode == "gloo":
            assert aborts == [] and "PENDING" not in out, out
        else:
            # Once, from the engine's thread, on the eviction's word: the
            # world group and this rank's tp and dp subgroups.
            assert len(aborts) == 1, out
            thread, reason, groups = aborts[0]
            assert thread != "MainThread" and reason == [
                "rank(s) [3] evicted"], out
            # torch's registry of this rank's groups may hold other lines
            # of the mesh too.
            lines = [[0, 1, 2, 3], [0, 1], [2, 3], [0, 2], [1, 3]]
            assert all(g in groups for g in ([0, 1, 2, 3], tp, dp)), out
            assert all(g in lines for g in groups), out
            assert "PENDING freed True" in out, out
            assert "GROUP_ERR GroupAbortedError" in out, out
        assert "RESET size 3 epoch 1" in out, out
        # Steps 0 and 1 at four (280 + 8 s), then two at three from the
        # last commit, step 2 (168 + 6 s).
        steps = [(int(s), int(e), int(n), float(v)) for s, e, n, v in
                 re.findall(r"STEP (\d+) e(\d+) size (\d+) ([\d.]+)", out)]
        assert steps == [(0, 0, 4, 280.0), (1, 0, 4, 288.0),
                         (2, 1, 3, 180.0), (3, 1, 3, 186.0)], out
