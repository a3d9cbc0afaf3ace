"""``ServingLoop(mesh=...)``: the gang-wide serving loop over tensor
parallelism, on launched CPU gangs of ``tests/torch_port_serve_worker.py``
with ``SERVE_MESH``, against the JAX package's one-device ``generate``.

The model is ``tests/test_torch_serving.py``'s (fp32, vocab 128, d_model
64, 2 layers, 4 heads, d_ff 128, the JAX init's matrices times 5), its
weights through ``models/convert.py``; every rank loads the whole model and
the loop cuts its shard.  Both gangs start together, once:

* tp 2 on two ranks (the loop forms the gloo group): eight concurrent
  requests through eight slots, half posted to the follower's door; every
  reply's tokens equal ``generate``'s on that prompt alone;
* dp 2 x tp 2 on four ranks, rank 0 SIGKILLed once four requests are live
  in rank 1's slot table: the three survivors re-form at epoch 1 with tp 1
  (3 is no multiple of 2), the promoted leader replays the in-flight
  requests from their prompts, and every reply equals the same oracle;
* dp 2 x tp 2 on four ranks whose rank 1 stalls (the ``serve.step`` fault
  site) mid-stream: rank 0's tp collective with it fails at the group's
  timeout, ranks 2 and 3, whose tp group is healthy, wait on the engine
  and report nothing, and the verdict names rank 1 alone (the failed
  group's silent member), so that ranks 0, 2 and 3 re-form at tp 1, rank 0
  still the leader, and every reply equals the oracle.

Knobs as ``tests/test_torch_serving_loop.py``'s failover gang (collective
deadline 5 s, probe window 0.5 s, rank 0's steps delayed 50 ms); the
serving leader stops once every client has its reply (``SERVE_STOP_FILE``),
so that a client re-POSTing after the replay finished still finds a door.
"""

import json
import re
import threading
import time

import pytest
import torch

from test_torch_serving import MODEL, _jax_tokens, _params, _requests
from test_torch_serving_loop import (_env, _final_epoch, _finish, _kill_all,
                                     _out, _post_all, _repost_until_served,
                                     _start, _wait_file)
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.runner.http_server import RendezvousServer

TP_REQS = _requests(8)
FAILOVER_REQS = [(f"cli{i}", [3 + i, 14, 15], 24) for i in range(4)]
STALL_REQS = [(f"st{i}", [7 + i, 20, 21], 24) for i in range(4)]
KNOBS = {"HVD_COLLECTIVE_TIMEOUT": "5.0",
         "HVD_COLLECTIVE_PROBE_TIMEOUT": "0.5",
         "HVD_KV_RETRY_BASE_S": "0.02",
         "SERVE_MODEL": json.dumps(MODEL),
         "OMP_NUM_THREADS": "1"}


def _gang_envs(tmp, np_, mesh, rport, per_rank):
    return [_env(tmp, r, np_, rport, min_np=2, extra=dict(
        KNOBS, SERVE_MESH=json.dumps(mesh), **per_rank(r)))
        for r in range(np_)]


def _run_tp2(tmp, procs, out):
    _wait_file(tmp / "ready", procs, tmp)
    ports = [int(_wait_file(tmp / f"port{r}", procs, tmp)) for r in range(2)]
    results = {}
    threads = _post_all([(ports[i % 2], None, p, m)
                         for i, (p, m) in enumerate(TP_REQS)], results)
    for t in threads:
        t.join(timeout=90)
    (tmp / "stop").write_text("1")
    _finish(procs)
    out["results"] = results


def _run_failover(tmp, procs, out):
    _wait_file(tmp / "ready", procs, tmp)
    port0, port1 = (int(_wait_file(tmp / f"port{r}", procs, tmp))
                    for r in range(2))
    phase1, results = {}, {}
    _post_all([(port0, rid, p, m) for rid, p, m in FAILOVER_REQS], phase1)
    _wait_file(tmp / "shadow_full", procs, tmp, 30.0)
    procs[0].kill()  # SIGKILL, mid-decode
    reposters = [threading.Thread(
        target=_repost_until_served,
        args=(port1, rid, p, m, results, time.monotonic() + 90.0),
        daemon=True) for rid, p, m in FAILOVER_REQS]
    for t in reposters:
        t.start()
    for t in reposters:
        t.join(timeout=100)
    (tmp / "stop").write_text("1")
    _finish(procs[1:])
    procs[0].wait(timeout=10)
    out["results"] = results


def _run_stall(tmp, procs, out):
    _wait_file(tmp / "ready", procs, tmp)
    port0 = int(_wait_file(tmp / "port0", procs, tmp))
    results = {}
    threads = _post_all([(port0, rid, p, m) for rid, p, m in STALL_REQS],
                        results)
    for t in threads:
        t.join(timeout=90)
    (tmp / "stop").write_text("1")
    _finish([procs[r] for r in (0, 2, 3)])
    procs[1].kill()  # stalled for an hour
    procs[1].wait(timeout=10)
    out["results"] = results


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    tmp_a = tmp_path_factory.mktemp("serve_tp2")
    tmp_b = tmp_path_factory.mktemp("serve_dp2tp2")
    tmp_c = tmp_path_factory.mktemp("serve_dp2tp2_stall")
    weights = convert.params_from_jax(_params())
    for tmp in (tmp_a, tmp_b, tmp_c):
        torch.save(weights, tmp / "weights.pt")
    servers = [RendezvousServer("127.0.0.1") for _ in range(3)]
    rports = [s.start() for s in servers]

    def tp2_rank(r):
        extra = {"SERVE_MAX_BATCH": "8", "SERVE_MAX_QUEUE": "16",
                 "SERVE_STOP_FILE": str(tmp_a / "stop"),
                 "SERVE_PORT_FILE": str(tmp_a / f"port{r}")}
        if r == 0:
            extra["SERVE_READY_FILE"] = str(tmp_a / "ready")
        return extra

    def failover_rank(r):
        extra = {"SERVE_MAX_BATCH": "4",
                 "SERVE_STOP_FILE": str(tmp_b / "stop")}
        if r < 2:
            extra["SERVE_PORT_FILE"] = str(tmp_b / f"port{r}")
        if r == 0:
            extra["SERVE_READY_FILE"] = str(tmp_b / "ready")
            extra["HOROVOD_FAULT_PLAN"] = json.dumps({"faults": [
                {"site": "serve.step", "kind": "delay", "delay_s": 0.05}]})
        if r == 1:
            extra["SERVE_SHADOW_FILE"] = str(tmp_b / "shadow_full")
        return extra

    def stall_rank(r):
        extra = {"SERVE_MAX_BATCH": "4",
                 "SERVE_STOP_FILE": str(tmp_c / "stop")}
        if r == 0:
            extra["SERVE_PORT_FILE"] = str(tmp_c / "port0")
            extra["SERVE_READY_FILE"] = str(tmp_c / "ready")
        if r == 1:
            # Five frames into the stream, before the step's tp
            # collectives.
            extra["HOROVOD_FAULT_PLAN"] = json.dumps({"faults": [
                {"site": "serve.step", "kind": "stall", "stall_s": 3600,
                 "after": 5}]})
        return extra

    procs_a = _start(tmp_a, _gang_envs(tmp_a, 2, {"tp": 2}, rports[0],
                                       tp2_rank))
    procs_b = _start(tmp_b, _gang_envs(tmp_b, 4, {"dp": 2, "tp": 2},
                                       rports[1], failover_rank))
    procs_c = _start(tmp_c, _gang_envs(tmp_c, 4, {"dp": 2, "tp": 2},
                                       rports[2], stall_rank))
    out_a, out_b, out_c, errors = {}, {}, {}, []

    def guard(fn, *args):
        try:
            fn(*args)
        except BaseException as e:  # re-raised below, after the cleanup
            errors.append(e)

    runners = [threading.Thread(target=guard, args=a, daemon=True) for a in
               ((_run_tp2, tmp_a, procs_a, out_a),
                (_run_failover, tmp_b, procs_b, out_b),
                (_run_stall, tmp_c, procs_c, out_c))]
    try:
        for t in runners:
            t.start()
        # The oracles while the gangs serve.
        oracle = {tuple(p): _jax_tokens(p, m) for p, m in
                  TP_REQS + [(p, m) for _, p, m in
                             FAILOVER_REQS + STALL_REQS]}
        for t in runners:
            t.join(timeout=170)
    finally:
        _kill_all(procs_a + procs_b + procs_c)
        for s in servers:
            s.stop()
    if errors:
        raise errors[0]
    return {"oracle": oracle,
            "tp2": (procs_a, tmp_a, out_a.get("results", {})),
            "failover": (procs_b, tmp_b, out_b.get("results", {})),
            "stall": (procs_c, tmp_c, out_c.get("results", {}))}


def _tps(out):
    return [tuple(int(v) for v in m) for m in re.findall(
        r"TP (\d+) epoch (\d+) size (\d+) rank (\d+)", out)]


@pytest.mark.timeout(240)
def test_tp2_gang_serves_generate_exact(gangs):
    procs, tmp, results = gangs["tp2"]
    for r, p in enumerate(procs):
        out = _out(tmp, r)
        assert p.returncode == 0 and "DONE" in out, (r, out)
        assert _tps(out) == [(2, 0, 2, r)], out
    assert len(results) == len(TP_REQS), results
    for i, (prompt, max_new) in enumerate(TP_REQS):
        code, body = results[i]
        assert code == 200, (i, code, body)
        got = json.loads(body)
        assert got["tokens"] == gangs["oracle"][tuple(prompt)], (i, got)
        assert got["attempts"] == 1, got


@pytest.mark.timeout(240)
def test_dp2_tp2_leader_sigkill_replays_at_tp1(gangs):
    procs, tmp, results = gangs["failover"]
    assert procs[0].returncode == -9
    assert _tps(_out(tmp, 0)) == [(2, 0, 4, 0)]
    for r in (1, 2, 3):
        out = _out(tmp, r)
        assert procs[r].returncode == 0 and "DONE" in out, (r, out)
        assert _final_epoch(out) >= 1, out
        tps = _tps(out)
        assert tps[0] == (2, 0, 4, r), out
        # Every incarnation after the kill runs three ranks at tp 1.
        assert tps[1:] and all(tp == 1 and n == 3 for tp, _e, n, _r
                               in tps[1:]), out
    for rid, prompt, max_new in FAILOVER_REQS:
        got = results.get(rid)
        assert got is not None, (rid, results)
        assert got["tokens"] == gangs["oracle"][tuple(prompt)], rid
        assert got["attempts"] > 1, (rid, got)


@pytest.mark.timeout(240)
def test_dp2_tp2_stalled_rank_evicted_alone(gangs):
    procs, tmp, results = gangs["stall"]
    assert procs[1].returncode == -9
    for r in (0, 2, 3):
        out = _out(tmp, r)
        assert procs[r].returncode == 0 and "DONE" in out, (r, out)
        assert _final_epoch(out) >= 1, out
        tps = _tps(out)
        assert tps[0] == (2, 0, 4, r), out
        # Rank 1's verdict alone: the three others re-form at tp 1, in
        # their old order.
        assert tps[1:] and all(tp == 1 and n == 3 for tp, _e, n, _r
                               in tps[1:]), out
        assert tps[1][3] == (0, None, 1, 2)[r], out
    assert "the gang's verdict: rank(s) [1]" in _out(tmp, 0), _out(tmp, 0)
    assert len(results) == len(STALL_REQS), results
    for i, (rid, prompt, _max_new) in enumerate(STALL_REQS):
        code, body = results[i]
        assert code == 200, (rid, code, body)
        assert json.loads(body)["tokens"] == \
            gangs["oracle"][tuple(prompt)], rid
