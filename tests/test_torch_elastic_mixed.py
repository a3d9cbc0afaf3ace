"""Mixed elastic gangs: JAX ranks (``tests/elastic_worker.py``, the JAX
package's ``PyEngine``) and port ranks
(``tests/torch_port_elastic_worker.py``) re-form one gang.  They share the
KV keys and the world's JSON, the commit checks' names, the pickles of
``broadcast_object``, the epoch trailer on every frame and the fence.

* Shrink: a gang of three loses a rank after step 3, between commits;
  each package's rank is the killed one, the leader that stays, and the
  leader a failover promotes (rank 0 killed).
* Grow: a port joiner admitted into a JAX gang, and a JAX joiner into a
  port gang.
* Fence: a JAX rank at a stale epoch fenced by a port coordinator, and a
  port rank by a JAX one.

Every survivor prints the same ``STEP`` values and the same ``FINAL_W``,
and ``tests/test_elastic.py``'s assertions hold.  The gangs pin
``HVD_SHM_DISABLE=1`` (``start_gang``).
"""

import re
import time

import pytest

from test_torch_elastic import (FAULT_PLAN, HEARTBEAT_ENV, assert_shrunk,
                                final_w, finish_gang, kill_plan, start_gang,
                                steps_of)
from test_torch_liveness import _finish, _start


@pytest.mark.timeout(240)
@pytest.mark.parametrize("pkgs,victim", [
    (("jax", "jax", "port"), 2),   # the port rank dies; JAX rank 0 leads
    (("jax", "port", "jax"), 0),   # the JAX hub dies; the port rank leads
    (("port", "jax", "jax"), 0),   # the port hub dies; a JAX rank leads
], ids=["port-killed", "port-leads", "jax-leads"])
def test_mixed_gang_shrinks_and_agrees(tmp_path, pkgs, victim):
    tl = tmp_path / "timeline.json"
    outs = finish_gang(start_gang(
        list(pkgs), str(tmp_path), min_np=2,
        base_env={"ELASTIC_TOTAL_STEPS": "8", "ELASTIC_COMMIT_EVERY": "3",
                  "HVD_TIMELINE": str(tl)},
        rank_env={victim: {FAULT_PLAN: kill_plan(3)}}))
    assert outs[victim][0] == 137, outs[victim]
    survivors = [r for r in range(3) if r != victim]
    for r in survivors:
        code, out = outs[r]
        assert code == 0, (r, pkgs[r], out)
        assert_shrunk(out, 8, 3, 3)
    a, b = (outs[r][1] for r in survivors)
    assert steps_of(a) == steps_of(b), (a, b)
    assert final_w(a) == final_w(b)
    text = tl.read_text()
    assert "ELASTIC_REFORM" in text and "ELASTIC_EPOCH_1" in text
    if victim == 0:
        assert "LEADER_FAILOVER" in text, text[-2000:]


@pytest.mark.timeout(240)
@pytest.mark.parametrize("gang,joiner", [
    (("jax", "jax"), "port"), (("port", "port"), "jax")],
    ids=["port-joins-jax", "jax-joins-port"])
def test_mixed_joiner_grows_gang(tmp_path, gang, joiner):
    outs = finish_gang(start_gang(
        list(gang), str(tmp_path), max_np=3,
        # The gang stops three steps after it reaches three; the step
        # budget only has to outlast a joiner started under load.
        base_env={"ELASTIC_TOTAL_STEPS": "4000", "ELASTIC_COMMIT_EVERY": "1",
                  "ELASTIC_STEP_SLEEP": "0.05", "ELASTIC_STOP_AT_SIZE": "3",
                  "ELASTIC_STEPS_AFTER_GROW": "3"},
        joiner=joiner))
    assert len(outs) == 3
    for i, (code, out) in enumerate(outs):
        assert code == 0, (i, out)
        assert "DONE" in out, (i, out)
    for r in (0, 1):
        out = outs[r][1]
        assert "RESET size 3" in out, out
        steps = steps_of(out)
        assert any(v == 2.0 for _, v in steps), steps
        assert steps[-1][1] == 3.0, steps
    assert steps_of(outs[0][1]) == steps_of(outs[1][1])
    j_out = outs[2][1]
    j_steps = steps_of(j_out)
    assert j_steps and all(v == 3.0 for _, v in j_steps), j_out
    # The joiner's steps are the incumbents' last ones.
    assert j_steps == steps_of(outs[0][1])[-len(j_steps):]
    assert "RESET size" not in j_out
    assert len({final_w(o) for _, o in outs}) == 1, outs


@pytest.mark.timeout(200)
@pytest.mark.parametrize("pkgs", [("port", "jaxchaos"), ("jaxchaos", "port")],
                         ids=["port-fences-jax", "jax-fences-port"])
def test_mixed_stale_epoch_rank_is_fenced(tmp_path, pkgs):
    """The coordinator at epoch 3 fences the other package's rank at epoch
    1: the zombie raises the typed ``FencedError``, the coordinator notes
    ``epoch.fence`` and evicts it."""
    outs = _finish(_start(
        list(pkgs), "fence_stale_epoch", str(tmp_path),
        base_env=dict(HEARTBEAT_ENV, HVD_SHM_DISABLE="1"),
        rank_env={0: {"HVD_ELASTIC_EPOCH": "3"},
                  1: {"HVD_ELASTIC_EPOCH": "1"}}),
        time.monotonic() + 120)
    z_code, z_out = outs[1]
    assert z_code == 0, z_out
    assert "FENCED rank=1 stale=1 current=3" in z_out, z_out
    c_code, c_out = outs[0]
    assert c_code == 0, c_out
    m = re.search(r"(SURVIVED rank=0 sum=1\.0|RANKS_FAILED \[1\]) "
                  r"fences=(\d+)", c_out)
    assert m and int(m.group(2)) >= 1, c_out
    assert "FENCED" not in c_out, c_out
