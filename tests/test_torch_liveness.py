"""The port's liveness against the JAX package's: heartbeats, eviction,
``EVICT`` and ``RanksFailedError``.

* ``_check_dead_ranks`` on a bare engine, case for case with
  ``tests/test_chaos.py``'s ``test_check_dead_ranks_semantics``, in both
  packages;
* gangs of three (``tests/torch_port_chaos_worker.py`` for the port's
  ranks, ``tests/chaos_worker.py`` for the JAX package's), started
  together in one wave: rank 2 killed after step 2 in a port gang and in a
  JAX gang (the survivors' ``STEP`` and ``RANKS_FAILED ... at_step``
  markers are the same in both), rank 2's control send dropped, and cut
  by a partition, in port gangs (it exits 17 as a lost coordinator, the
  survivors evict it), and a mixed gang whose JAX coordinator evicts a
  killed port rank; and two port gangs under a 1.0 s timeout, whose rank
  2 receives a ``broadcast_object`` slowly (kept in the gang) or wedged
  (evicted).

``_start``/``_finish`` are the gang helpers the timeout and control-tree
files use too.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT_WORKER = os.path.join(HERE, "torch_port_chaos_worker.py")
JAX_WORKER = os.path.join(HERE, "chaos_worker.py")
FAULT_PLAN = "HOROVOD_FAULT_PLAN"
HEARTBEAT_ENV = {"HVD_HEARTBEAT_TIMEOUT": "2.0",
                 "HVD_HEARTBEAT_INTERVAL": "0.25"}
KILL_PLAN = json.dumps({"faults": [
    {"site": "train.step", "kind": "kill", "after": 2}]})
DROP_PLAN = json.dumps({"faults": [
    {"site": "ctrl.worker.send", "kind": "drop", "times": 1, "after": 2}]})
# Rank 2 cut off from the root's side of the network at its third send.
PARTITION_PLAN = json.dumps({"faults": [
    {"site": "ctrl.worker.send", "kind": "partition", "after": 2,
     "groups": [[0, 1], [2]]}]})
GANG_TIMEOUT = 120.0
# A short timeout against a broadcast_object that outlasts it on rank 2:
# 8 MiB read in 64 KiB slices 50 ms apart (≈6.4 s; with 512 KiB socket
# buffers the root's send ends with at most a few MiB, ≥1.6 s of reading,
# still to go) and an unpickle of 1.5 s on every rank; or its payload's
# receive wedged for 6 s.
BUSY_ENV = {"HVD_HEARTBEAT_TIMEOUT": "1.0", "HVD_HEARTBEAT_INTERVAL": "0.1",
            "HVD_SHM_DISABLE": "1", "HVD_SOCK_BUF_BYTES": str(512 << 10),
            "BUSY_RANK": "2"}
BUSY_STALL_S = 6.0
BUSY_GANGS = {
    "port_busy_slow": {"BUSY_MODE": "slow", "BUSY_MB": "8",
                       "BUSY_UNPICKLE_S": "1.5"},
    "port_busy_wedge": {"BUSY_MODE": "wedge", "BUSY_MB": "0.25",
                        "BUSY_UNPICKLE_S": "0",
                        "BUSY_STALL_S": str(BUSY_STALL_S)},
}


def _start(pkgs, scenario, cwd, local_size=None, base_env=None,
           rank_env=None):
    """Start one gang against its own rendezvous server: rank r runs
    ``pkgs[r]``, ``"port"`` or ``"jax"`` (this file's worker on the JAX
    package) or ``"jaxchaos"`` (``tests/chaos_worker.py``).  ``local_size``
    makes a block topology of hosts of that many ranks."""
    os.makedirs(cwd, exist_ok=True)
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    n = len(pkgs)
    ls = local_size or n
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env0["PYTHONPATH"] = REPO + os.pathsep + env0.get("PYTHONPATH", "")
    procs = []
    for rank, pkg in enumerate(pkgs):
        env = dict(env0, HVD_RANK=str(rank), HVD_SIZE=str(n),
                   HVD_LOCAL_RANK=str(rank % ls), HVD_LOCAL_SIZE=str(ls),
                   HVD_CROSS_RANK=str(rank // ls),
                   HVD_CROSS_SIZE=str(n // ls),
                   HVD_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_RENDEZVOUS_PORT=str(port), HVD_TPU_CORE="py",
                   JAX_PLATFORMS="cpu")
        env.update(base_env or {})
        env.update((rank_env or {}).get(rank, {}))
        if pkg == "jaxchaos":
            argv = [sys.executable, JAX_WORKER, scenario]
        else:
            argv = [sys.executable, PORT_WORKER, scenario, pkg]
        # In the gang's own directory: a JAX rank's flight-recorder dump
        # lands there, not in the checkout.
        procs.append(subprocess.Popen(argv, env=env, cwd=cwd,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    return server, procs


def _finish(gang, deadline, stalled=()):
    """Wait for a gang's ranks, then kill the ``stalled`` ones (a stall's
    victim never exits by itself: it must still be running).  Returns each
    rank's (exit code, output); kills every rank past ``deadline``."""
    server, procs = gang
    outs = {}
    alive_after = {}
    try:
        order = [r for r in range(len(procs)) if r not in stalled] + \
            list(stalled)
        for r in order:
            p = procs[r]
            if r in stalled:
                alive_after[r] = p.poll() is None
                p.kill()
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += b"\n(killed: the gang outlived its time limit)"
            outs[r] = (p.returncode, out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    for r, alive in alive_after.items():
        code, out = outs[r]
        outs[r] = (code, out + f"\n(running when killed: {alive})")
    return [outs[r] for r in range(len(procs))]


def _steps(out):
    return [(int(m.group(1)), float(m.group(2)))
            for m in re.finditer(r"STEP (\d+) ([\d.]+)", out)]


def _markers(out):
    """The survivor's contract: its steps, and what RanksFailedError
    named at which step."""
    m = re.search(r"RANKS_FAILED (\[[^\]]*\]) at_step (\d+)", out)
    return (_steps(out), (json.loads(m.group(1)), int(m.group(2)))
            if m else None)


# ---------------------------------------------------------------------------
# _check_dead_ranks on a bare engine, in both packages
# ---------------------------------------------------------------------------


def _dead_ranks_trace(engine_cls):
    """tests/test_chaos.py's cases, returning every answer."""
    eng = object.__new__(engine_cls)
    now = time.monotonic()
    got = []
    eng.heartbeat_timeout = 0.0
    eng._evicted_ranks = set()
    eng._conn_lost = set()
    eng._rank_route = {}
    eng._last_seen = {1: now - 99.0, 2: now}
    got.append(eng._check_dead_ranks())          # off by default
    eng.heartbeat_timeout = 1.0
    got.append(eng._check_dead_ranks())          # silent past the timeout
    eng._conn_lost.add(2)
    got.append(sorted(eng._check_dead_ranks()))  # EOF beats the timer
    eng._evicted_ranks.add(1)
    got.append(eng._check_dead_ranks())          # evicted once
    eng._evicted_ranks.clear()
    eng._conn_lost.clear()
    eng._rank_route = {2: 1}
    eng._last_seen = {1: now - 99.0, 2: now - 99.0}
    got.append(eng._check_dead_ranks())          # the parent only
    got.append(eng._last_seen[2] > now - 1.0)    # the child's clock reset
    got.append(eng._check_dead_ranks())          # the child stays spared
    return got


def test_check_dead_ranks_matches_jax():
    from horovod_tpu.runtime_py import PyEngine as JaxEngine

    from horovod_tpu_torch.runtime_py import PyEngine

    want = _dead_ranks_trace(JaxEngine)
    assert want == [[], [1], [1, 2], [2], [1], True, [1]]
    assert _dead_ranks_trace(PyEngine) == want


def test_ranks_failed_error_exported():
    import horovod_tpu as jhvd

    import horovod_tpu_torch as hvd

    err = hvd.RanksFailedError([3, 1])
    assert err.ranks == [1, 3]
    assert str(err) == str(jhvd.RanksFailedError([3, 1]))


# ---------------------------------------------------------------------------
# gangs of three: kill, drop, mixed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("liveness_gangs")
    kill = {2: {FAULT_PLAN: KILL_PLAN}}
    spec = {
        "port_kill": (["port"] * 3, kill),
        "jax_kill": (["jaxchaos"] * 3, kill),
        "port_drop": (["port"] * 3, {2: {FAULT_PLAN: DROP_PLAN}}),
        "port_partition": (["port"] * 3, {2: {FAULT_PLAN: PARTITION_PLAN}}),
        "mixed_kill": (["jaxchaos", "port", "port"], kill),
    }
    started = {name: _start(pkgs, "train_steps", str(root / name),
                            base_env=HEARTBEAT_ENV, rank_env=rank_env)
               for name, (pkgs, rank_env) in spec.items()}
    for name, env in BUSY_GANGS.items():
        started[name] = _start(["port"] * 3, "bcast_object_busy",
                               str(root / name),
                               base_env=dict(BUSY_ENV, **env))
    deadline = time.monotonic() + GANG_TIMEOUT
    return {name: _finish(g, deadline,
                          stalled=(2,) if name == "port_busy_wedge" else ())
            for name, g in started.items()}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", ["port_kill", "jax_kill", "mixed_kill"])
def test_sigkilled_rank_evicted_survivors_complete_in_flight_step(gangs,
                                                                  name):
    """Rank 2 dies after step 2: evicted on its dropped link, the
    in-flight step 3 completes over the two survivors, and step 4's
    submission raises RanksFailedError naming [2]."""
    outs = gangs[name]
    v_code, v_out = outs[2]
    assert v_code == 137, (v_code, v_out)
    assert _steps(v_out)[-1][0] == 2, v_out
    for rank in (0, 1):
        code, out = outs[rank]
        assert code == 0, (name, rank, out)
        steps = dict(_steps(out))
        assert steps[0] == 3.0 and steps[2] == 3.0, (name, rank, steps)
        assert steps[3] == 2.0, (name, rank, steps)  # the survivors only
        assert "RANKS_FAILED [2] at_step 4" in out, (name, rank, out)


@pytest.mark.timeout(240)
def test_port_kill_markers_equal_jax_gang(gangs):
    """The survivors' markers, step for step, are the JAX gang's."""
    for rank in (0, 1):
        assert _markers(gangs["port_kill"][rank][1]) == \
            _markers(gangs["jax_kill"][rank][1]), rank
        assert _markers(gangs["mixed_kill"][rank][1]) == \
            _markers(gangs["jax_kill"][rank][1]), rank


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", ["port_drop", "port_partition"])
def test_ctrl_fault_victim_exits_lost_and_is_evicted(gangs, name):
    """The victim's control send is dropped, or crosses a partition, at
    its third step: it aborts as a lost coordinator (exit 17), the
    coordinator evicts it on the dropped link, and the survivors' last
    step ran over the two of them before RanksFailedError."""
    outs = gangs[name]
    v_code, v_out = outs[2]
    assert v_code == 17, (v_code, v_out)
    assert "CTRL_LOST" in v_out, v_out
    for rank in (0, 1):
        code, out = outs[rank]
        assert code == 0, (rank, out)
        assert "RANKS_FAILED [2]" in out, (rank, out)
        steps = _steps(out)
        assert steps and steps[-1][1] == 2.0, steps


@pytest.mark.timeout(240)
def test_busy_receiver_of_broadcast_object_is_not_evicted(gangs):
    """Rank 2 still reads the root's object, then unpickles it, long after
    the root's send has ended, past the heartbeat timeout: its control
    receive thread beats for it while the bytes arrive, and every rank
    gets the object and runs the allreduces after it."""
    outs = gangs["port_busy_slow"]
    digests = set()
    for rank, (code, out) in enumerate(outs):
        assert code == 0, (rank, out)
        assert "RANKS_FAILED" not in out and "evicting" not in out, \
            (rank, out)
        m = re.search(r"BUSY_OK rank=%d digest=(\w+)" % rank, out)
        assert m, (rank, out)
        digests.add(m.group(1))
    assert len(digests) == 1, digests


@pytest.mark.timeout(240)
def test_rank_wedged_in_a_receive_is_still_evicted(gangs):
    """Rank 2's receive of the object's payload wedges (no bytes move):
    no beat goes out for it, and the coordinator evicts it
    within the timeout, long before the wedge ends; the survivors'
    next allreduce raises RanksFailedError naming [2]."""
    outs = gangs["port_busy_wedge"]
    assert "BUSY_OK" not in outs[2][1], outs[2]
    for rank in (0, 1):
        code, out = outs[rank]
        assert code == 0, (rank, out)
        m = re.search(r"RANKS_FAILED \[2\] dt=([\d.]+)", out)
        assert m, (rank, out)
        assert float(m.group(1)) < BUSY_STALL_S / 2, (rank, out)
