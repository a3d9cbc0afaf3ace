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
