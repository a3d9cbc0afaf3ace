"""The port's elastic training against the JAX package's.

Units, the port's function beside the JAX package's on the same inputs:
``quorum_lost`` over every roster of one to six ranks and every failed
set, ``_set_world_env``'s environment, the state's commit and restore
round trips (``ObjectState``, and ``TorchState`` over a module and an
optimizer on the CPU) and the commit serial rewound at ``on_reset``,
``HostDiscoveryScript``'s parsing, ``ElasticDriver``'s epochs, blacklist
and ``wait_for_available_slots`` (``tests/test_elastic.py``'s cases),
``KVClient.list`` on the port's and the JAX package's servers, and the
timeline re-attached across two engine incarnations in one process.

Port gangs of ``tests/torch_port_elastic_worker.py`` (and
``tests/torch_port_chaos_worker.py`` for the fence), each a scenario of
``tests/test_elastic.py``, ``tests/test_ctrl_tree.py`` or
``tests/test_timeouts.py`` with its assertions: the shrink after a SIGKILL
between commits (step 3 read at 3.0, then at 2.0 after the rollback) with
the survivors' response caches in agreement, leader failover beside a JAX
gang of ``tests/elastic_worker.py`` in the same scenario (the same markers
and ``FINAL_W``), a joiner that grows the gang and whose cold cache agrees,
the discovery script's re-form, ``PARTITION_MINORITY``, the quorum's
switch, the fence, and the stalled rank's abort, eviction and replay on
the shm ring.  The gangs use the JAX tests' knobs (heartbeats at 2.0 s
every 0.25 s, a check interval of 0.05 s); those whose subject is not the
shm ring pin ``HVD_SHM_DISABLE=1``.

``start_gang``/``finish_gang`` are the gang helpers the mixed-gang file
uses too.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT_WORKER = os.path.join(HERE, "torch_port_elastic_worker.py")
JAX_WORKERS = {"train": os.path.join(HERE, "elastic_worker.py"),
               "stall": os.path.join(HERE, "timeout_worker.py")}
FAULT_PLAN = "HOROVOD_FAULT_PLAN"
HEARTBEAT_ENV = {"HVD_HEARTBEAT_TIMEOUT": "2.0",
                 "HVD_HEARTBEAT_INTERVAL": "0.25"}
GANG_TIMEOUT = 150.0


def kill_plan(after):
    return json.dumps({"faults": [
        {"site": "train.step", "kind": "kill", "after": after}]})


# ---------------------------------------------------------------------------
# gang helpers
# ---------------------------------------------------------------------------


def start_gang(pkgs, cwd, *, min_np=1, max_np=None, scenario="train",
               base_env=None, rank_env=None, joiner=None,
               joiner_after="STEP 1 ", shm=False, joiner_watch=0):
    """Start one elastic gang against its own rendezvous server: rank r
    runs ``pkgs[r]``, ``"port"`` (``tests/torch_port_elastic_worker.py``)
    or ``"jax"`` (``tests/elastic_worker.py``, or for the ``stall``
    scenario ``tests/timeout_worker.py``).  ``joiner`` (a package) starts a
    late worker with ``HVD_ELASTIC_JOINER=1`` once rank 0 has printed
    ``joiner_after`` (by default its ``STEP 1``: a JAX incumbent that
    reaches its first ``consume_updates()`` after the announcement never
    admits the joiner; ``joiner_watch`` names another rank whose output to
    watch).  Each rank's output goes to ``<cwd>/out<r>``.
    Every rank pins ``HVD_SHM_DISABLE=1`` unless ``shm``."""
    os.makedirs(cwd, exist_ok=True)
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    n = len(pkgs)
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env0["PYTHONPATH"] = REPO + os.pathsep + env0.get("PYTHONPATH", "")
    # The recorder's dumps in the gang's own directory.
    env0["HVD_BLACKBOX_DIR"] = os.path.join(cwd, "blackbox")

    def env_for(rank, extra=None):
        env = dict(env0, HVD_RANK=str(rank), HVD_SIZE=str(n),
                   HVD_LOCAL_RANK=str(rank), HVD_LOCAL_SIZE=str(n),
                   HVD_CROSS_RANK="0", HVD_CROSS_SIZE="1",
                   HVD_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_RENDEZVOUS_PORT=str(port), JAX_PLATFORMS="cpu",
                   HVD_TPU_CORE="py", HVD_ELASTIC_EPOCH="0",
                   HVD_ELASTIC_MIN_NP=str(min_np),
                   HVD_ELASTIC_MAX_NP=str(max_np or n),
                   HVD_ELASTIC_UID=f"uid-{rank}",
                   HVD_ELASTIC_CHECK_INTERVAL_S="0.05", **HEARTBEAT_ENV)
        if not shm:
            env["HVD_SHM_DISABLE"] = "1"
        env.update(base_env or {})
        env.update(extra or {})
        return env

    def argv(pkg):
        if pkg == "port":
            return [sys.executable, PORT_WORKER, scenario]
        return [sys.executable, JAX_WORKERS[scenario]]

    def popen(r, pkg, env):
        with open(os.path.join(cwd, f"out{r}"), "wb") as out:
            return subprocess.Popen(argv(pkg), env=env, cwd=cwd, stdout=out,
                                    stderr=subprocess.STDOUT)

    procs = [popen(r, pkg, env_for(r, (rank_env or {}).get(r)))
             for r, pkg in enumerate(pkgs)]
    late = {}
    if joiner is not None:
        def start_joiner():
            deadline = time.monotonic() + GANG_TIMEOUT
            path = os.path.join(cwd, f"out{joiner_watch}")
            while time.monotonic() < deadline and \
                    procs[joiner_watch].poll() is None:
                with open(path, "rb") as fh:
                    if joiner_after.encode() in fh.read():
                        break
                time.sleep(0.02)
            late["proc"] = popen(n, joiner, env_for(n, {
                "HVD_ELASTIC_JOINER": "1",
                "HVD_ELASTIC_UID": "uid-joiner"}))

        late["thread"] = threading.Thread(target=start_joiner, daemon=True)
        late["thread"].start()
    return server, procs, late, cwd


def finish_gang(gang, timeout=GANG_TIMEOUT, stalled=()):
    """Each rank's (exit code, output), the joiner's last; a ``stalled``
    rank must still run when the others have exited, and is killed then
    (its output ends with whether it ran)."""
    server, procs, late, cwd = gang
    deadline = time.monotonic() + timeout
    outs = {}
    try:
        if "thread" in late:
            late["thread"].join(max(1.0, deadline - time.monotonic()))
            procs = procs + [late["proc"]]
        order = [r for r in range(len(procs)) if r not in stalled] + \
            list(stalled)
        for r in order:
            p = procs[r]
            note = ""
            if r in stalled:
                note = f"\n(running when killed: {p.poll() is None})"
                p.kill()
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                note += "\n(killed: the gang outlived its time limit)"
            with open(os.path.join(cwd, f"out{r}"), "rb") as fh:
                out = fh.read().decode(errors="replace")
            outs[r] = (p.returncode, out + note)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    return [outs[r] for r in range(len(procs))]


def steps_of(out):
    return [(int(m.group(1)), float(m.group(2)))
            for m in re.finditer(r"STEP (\d+) ([\d.]+)", out)]


def final_w(out):
    m = re.search(r"FINAL_W ([\d.]+)", out)
    return float(m.group(1)) if m else None


def cache_view(out):
    m = re.search(r"CACHE (\{.*\})", out)
    assert m, out
    return json.loads(m.group(1))


def counters(out):
    m = re.search(r"COUNTERS (\{.*\})", out)
    assert m, out
    return json.loads(m.group(1))


def assert_shrunk(out, total, kill_step, commit_every):
    """``tests/test_elastic.py``'s survivor contract after a rank of three
    died after ``kill_step`` between commits: every step kept once, the
    uncommitted steps read at 3.0 and again at 2.0, the committed ones
    never replayed, and ``FINAL_W`` the sum of the kept executions."""
    assert "RESET size 2" in out, out
    assert "FINAL_EPOCH 1" in out, out
    assert "DONE" in out, out
    steps = steps_of(out)
    kept = dict(steps)
    assert sorted(kept) == list(range(total)), steps
    first_lost = (kill_step // commit_every) * commit_every
    assert [v for i, v in steps if i == first_lost] == [3.0, 2.0], steps
    assert [v for i, v in steps if i == 0] == [3.0], steps
    assert final_w(out) == sum(kept.values()), (final_w(out), steps)


# ---------------------------------------------------------------------------
# units, against the JAX package's functions
# ---------------------------------------------------------------------------


def _run_modules():
    """The two ``elastic/run.py`` modules (each package's ``elastic.run``
    attribute is the decorator)."""
    import importlib

    return (importlib.import_module("horovod_tpu.elastic.run"),
            importlib.import_module("horovod_tpu_torch.elastic.run"))


def test_quorum_lost_matches_jax_on_every_roster():
    from itertools import combinations

    jrun, prun = _run_modules()

    n_cases = 0
    for size in range(1, 7):
        for k in range(size + 1):
            for failed in combinations(range(size), k):
                assert prun.quorum_lost(size, set(failed)) == \
                    jrun.quorum_lost(size, set(failed)), (size, failed)
                n_cases += 1
    assert n_cases == sum(2 ** n for n in range(1, 7))
    # The tie-break: an exact half holds the quorum while it has rank 0.
    assert not prun.quorum_lost(4, {2, 3}) and prun.quorum_lost(4, {0, 1})


@pytest.mark.parametrize("base", ["", "attempt2"])
def test_set_world_env_matches_jax(monkeypatch, base):
    jrun, prun = _run_modules()

    keys = ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_LOCAL_SIZE",
            "HVD_CROSS_RANK", "HVD_CROSS_SIZE", "HVD_ELASTIC_EPOCH",
            "HVD_RDV_SCOPE")
    monkeypatch.setenv("HVD_ELASTIC_SCOPE_BASE", base)
    views = []
    for fn in (prun._set_world_env, jrun._set_world_env):
        for k in keys:
            # Set, then deleted: monkeypatch restores what the call writes.
            monkeypatch.setenv(k, "")
            monkeypatch.delenv(k)
        fn(2, 5, 3)
        views.append({k: os.environ.get(k) for k in keys})
    assert views[0] == views[1]
    assert views[0]["HVD_RDV_SCOPE"] == (f"{base}.elastic-3" if base
                                         else "elastic-3")


def _object_state_trace(elastic):
    s = elastic.ObjectState(w=np.arange(4, dtype=np.float32), step=0)
    s.w[0] = 99.0
    s.step = 5
    s.restore()  # back to the construction-time snapshot
    trace = [(s.step, s.w.tolist())]
    s.step = 3
    s.w = s.w + 1.0
    s.commit()  # no wrapper attached: a plain snapshot
    s.step = 7
    s.w[:] = 0.0
    s.restore()
    trace.append((s.step, s.w.tolist()))
    s._commit_serial = 14
    s._update_pending = True
    called = []
    s.register_reset_callbacks([lambda: called.append(True)])
    s.on_reset()
    trace.append((s._commit_serial, s._update_pending, called))
    return trace


def test_object_state_round_trip_and_reset_match_jax():
    from horovod_tpu import elastic as jel

    from horovod_tpu_torch import elastic as pel

    got = _object_state_trace(pel)
    assert got == _object_state_trace(jel)
    assert got == [(0, [0.0, 1.0, 2.0, 3.0]), (3, [1.0, 2.0, 3.0, 4.0]),
                   (0, False, [True])]


def _torch_state_trace(elastic):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    state = elastic.TorchState(model, opt)

    def step():
        opt.zero_grad()
        model(torch.ones(2, 4)).square().sum().backward()
        opt.step()

    step()
    state.commit()
    committed = ({k: v.clone() for k, v in model.state_dict().items()},
                 opt.state_dict()["state"][0]["exp_avg"].clone())
    step()
    step()
    state.restore()
    return committed, model.state_dict(), opt.state_dict()


def test_torch_state_round_trip_matches_jax():
    """``TorchState`` rolls a module and its AdamW back to the commit, bit
    for bit, as the JAX package's does; a later step from the restored
    state moves the same way from both."""
    from horovod_tpu import elastic as jel

    from horovod_tpu_torch import elastic as pel

    (c_model, c_avg), p_model, p_opt = _torch_state_trace(pel)
    _, j_model, j_opt = _torch_state_trace(jel)
    for k, v in c_model.items():
        assert torch.equal(p_model[k], v) and torch.equal(j_model[k], v)
    assert torch.equal(p_opt["state"][0]["exp_avg"], c_avg)
    assert torch.equal(j_opt["state"][0]["exp_avg"], c_avg)
    assert p_opt["state"][0]["step"] == j_opt["state"][0]["step"] == 1


def test_torch_state_extras_and_snapshot_are_copies():
    """Keywords ride along: ``state.step += 1`` is saved and restored with
    the module; a tensor keyword is cloned on its device."""
    from horovod_tpu_torch import elastic

    model = torch.nn.Linear(2, 2)
    t = torch.zeros(3)
    state = elastic.TorchState(model, None, step=0, buf=t)
    state.step += 1
    state.buf[0] = 5.0  # the live tensor, not the snapshot
    state.commit()
    state.step += 1
    state.buf[1] = 7.0
    with torch.no_grad():
        model.weight.add_(1.0)
    state.restore()
    assert state.step == 1
    assert state.buf.tolist() == [5.0, 0.0, 0.0]
    assert state.buf is not t
    assert state._saved_model["weight"].data_ptr() != \
        model.weight.data_ptr()


def test_host_discovery_script_parsing_matches_jax(tmp_path):
    from horovod_tpu.elastic.driver import HostDiscoveryScript as J

    from horovod_tpu_torch.elastic import HostDiscoveryScript as P

    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\n"
                      "echo '# provisioning note'\n"
                      "echo hostA:4\n"
                      "echo '  hostB  '\n"
                      "echo ''\n"
                      "echo hostC:1\n")
    script.chmod(0o755)
    want = {"hostA": 4, "hostB": 2, "hostC": 1}
    assert P(str(script), default_slots=2).find_available_hosts_and_slots() \
        == J(str(script), default_slots=2).find_available_hosts_and_slots() \
        == want


def _driver_trace(driver_cls, blacklist_cls):
    class StubDiscovery:
        def __init__(self):
            self.hosts = {"a": 1}

        def find_available_hosts_and_slots(self):
            return dict(self.hosts)

    events = []
    disco = StubDiscovery()
    bl = blacklist_cls(threshold=1, cooldown_s=300.0)
    d = driver_cls(
        disco, 1, 4, blacklist=bl, interval_s=0.02,
        on_hosts_updated=lambda e, a, r: events.append((e, a, r)))
    d.start()
    seen = []
    try:
        seen.append((d.epoch, d.hosts()))  # start() polled once
        disco.hosts["b"] = 2
        deadline = time.monotonic() + 5.0
        while d.epoch < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        seen.append((d.epoch, d.slots()))
        bl.record_failure("b")  # a blacklisted host drops out
        while d.epoch < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        seen.append((d.epoch, d.hosts()))
    finally:
        d.stop()
    return seen, events


def test_elastic_driver_epochs_and_blacklist_match_jax():
    from horovod_tpu.elastic.driver import ElasticDriver as J
    from horovod_tpu.runner.hosts import HostBlacklist as JB

    from horovod_tpu_torch.elastic import ElasticDriver as P
    from horovod_tpu_torch.runner.hosts import HostBlacklist as PB

    got = _driver_trace(P, PB)
    assert got == _driver_trace(J, JB)
    assert got == ([(1, {"a": 1}), (2, 3), (3, {"a": 1})],
                   [(1, ["a"], []), (2, ["b"], []), (3, [], ["b"])])


def test_driver_wait_for_available_slots():
    from horovod_tpu_torch.elastic import ElasticDriver, FixedHostDiscovery

    d = ElasticDriver(FixedHostDiscovery({"a": 2}), 1, 4, interval_s=0.02)
    d.start()
    try:
        assert d.wait_for_available_slots(2) == {"a": 2}
        with pytest.raises(TimeoutError):
            d.wait_for_available_slots(5, timeout=0.15)
    finally:
        d.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_kv_list_and_delete_on_both_servers(monkeypatch, server_pkg):
    monkeypatch.delenv("HVD_SECRET_KEY", raising=False)
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "2")
    from horovod_tpu.runner.http_client import KVClient as JKV
    from horovod_tpu.runner.http_server import RendezvousServer as JRS

    from horovod_tpu_torch.common.types import FencedError
    from horovod_tpu_torch.runner.http_client import KVClient

    server = (RendezvousServer if server_pkg == "port" else JRS)(
        "127.0.0.1")
    port = server.start()
    try:
        kv = KVClient("127.0.0.1", port)
        kv.put("elastic/pending/uid-a", "1")
        kv.put("elastic/pending/uid-b", "1")
        kv.put("elastic/world/1", "x")
        want = ["elastic/pending/uid-a", "elastic/pending/uid-b"]
        assert kv.list("elastic/pending/") == want
        assert JKV("127.0.0.1", port).list("elastic/pending/") == want
        assert kv.list("nope/") == []
        kv.delete("elastic/pending/uid-a")
        assert kv.list("elastic/pending/") == want[1:]
        # A delete under elastic/ carries the epoch: a stale one is fenced.
        monkeypatch.setenv("HVD_ELASTIC_EPOCH", "1")
        with pytest.raises(FencedError):
            kv.delete("elastic/pending/uid-b")
        assert kv.list("elastic/pending/") == want[1:]
    finally:
        server.stop()


def test_server_counts_fenced_writes(monkeypatch):
    from horovod_tpu_torch.common.types import FencedError
    from horovod_tpu_torch.runner.http_client import KVClient
    from horovod_tpu_torch.telemetry import registry

    monkeypatch.delenv("HVD_SECRET_KEY", raising=False)
    registry.configure(True)
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        kv = KVClient("127.0.0.1", port)
        monkeypatch.setenv("HVD_ELASTIC_EPOCH", "3")
        kv.put("elastic/world/3", "[]")
        monkeypatch.setenv("HVD_ELASTIC_EPOCH", "2")
        with pytest.raises(FencedError, match="epoch 2"):
            kv.put("elastic/world/2", "[]")
        snap = registry.snapshot()
        assert snap["counters"]["hvd_fenced_writes_total"] == 1
    finally:
        server.stop()
        registry.configure(False)


def test_timeline_spans_two_incarnations_in_one_process(monkeypatch,
                                                        tmp_path):
    """Two engine pairs in this process, at epochs 0 and 1, under one
    ``HVD_TIMELINE``: rank 0's second engine re-attaches to the first's
    timeline, and the file, closed at the end, parses with the re-form's
    records."""
    from horovod_tpu_torch import runtime_py
    from horovod_tpu_torch.common.types import ReduceOp
    from horovod_tpu_torch.utils import timeline

    for k in list(os.environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HVD_TIMELINE", str(path))
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path / "blackbox"))
    monkeypatch.setenv("HVD_SHM_DISABLE", "1")
    x = np.arange(4, dtype=np.float32)
    tls = []
    for epoch in (0, 1):
        monkeypatch.setenv("HVD_ELASTIC_EPOCH", str(epoch))
        monkeypatch.setenv("HVD_RDV_SCOPE", f"elastic-{epoch}")
        server = RendezvousServer("127.0.0.1")
        port = server.start()
        engs = {}

        def start(r):
            engs[r] = runtime_py.PyEngine(r, 2, r, 2, 0, 1, "127.0.0.1",
                                          port)

        threads = [threading.Thread(target=start, args=(r,))
                   for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        try:
            hs = [engs[r].allreduce_async(f"tl.{epoch}", x,
                                          op=ReduceOp.SUM)
                  for r in (0, 1)]
            for r, h in zip((0, 1), hs):
                engs[r].synchronize(h)
            tl = engs[0].timeline
            tls.append(tl)
            tl.elastic_event("ELASTIC_RESET" if epoch == 0
                             else "ELASTIC_REFORM", epoch=epoch)
        finally:
            stop = threading.Thread(target=engs[0].shutdown)
            stop.start()
            engs[1].shutdown()
            stop.join(30)
            server.stop()
        assert not engs[1].timeline.enabled  # rank 0 writes alone
    assert tls[0] is tls[1] and tls[0].enabled
    timeline.close_live()
    assert not tls[0].enabled
    events = json.loads(path.read_text())
    names = [e.get("name") for e in events]
    for want in ("ELASTIC_RESET", "ELASTIC_EPOCH_1", "ELASTIC_REFORM"):
        assert names.count(want) == 1, (want, names)
    assert names.index("ELASTIC_RESET") < names.index("ELASTIC_EPOCH_1") \
        < names.index("ELASTIC_REFORM")
    assert names.count("CLOCK_ANCHOR") == 1  # one file, one time axis
    assert names.count("NEGOTIATE_ALLREDUCE") == 2


def test_trace_and_recorder_carry_over_a_reform(monkeypatch, tmp_path):
    """Across two incarnations in one process the trace re-opens the
    rank's file for appending, with a fresh ``meta`` record at the new
    epoch, and the flight recorder keeps its ring and restamps rank and
    epoch."""
    from horovod_tpu_torch.telemetry import blackbox, trace

    monkeypatch.setenv("HVD_TRACE", "1")
    monkeypatch.setenv("HVD_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("HVD_BLACKBOX_DIR", str(tmp_path / "blackbox"))
    monkeypatch.delenv("HVD_BLACKBOX", raising=False)
    blackbox.reset()
    try:
        for epoch, rank in ((0, 2), (1, 1)):
            monkeypatch.setenv("HVD_ELASTIC_EPOCH", str(epoch))
            tr = trace.from_env(1)
            tr.span("collective", 1, 2, seq=0)
            trace.release(tr)
            bb = blackbox.from_env(rank, epoch=epoch)
            bb.note("engine.init", 0, {"rank": rank, "epoch": epoch})
        metas = [json.loads(line) for line in
                 (tmp_path / "trace_rank1.jsonl").read_text().splitlines()]
        assert [m["epoch"] for m in metas if m["k"] == "meta"] == [0, 1]
        assert sum(m["k"] == "span" for m in metas) == 2
        snap = blackbox.get().snapshot()
        assert (snap["rank"], snap["epoch"]) == (1, 1)
        assert [e["epoch"] for e in snap["events"]
                if e["kind"] == "engine.init"] == [0, 1]
    finally:
        blackbox.reset()
        trace.reset()


# ---------------------------------------------------------------------------
# port gangs
# ---------------------------------------------------------------------------


@pytest.mark.timeout(200)
def test_shrink_after_sigkill_rolls_back_replays_and_caches_agree(tmp_path):
    """Rank 2 of 3 dies after step 3 between commits (every 3 steps): the
    survivors re-form a gang of two at epoch 1 in the same processes, roll
    back to the step-3 commit, run steps 3-7 again and finish; the quorum
    lets the majority re-form; rank 0's timeline records the reset; the
    response cache probe after training gives both survivors the same
    view, with hits."""
    tl = tmp_path / "timeline.json"
    outs = finish_gang(start_gang(
        ["port"] * 3, str(tmp_path), min_np=2,
        base_env={"ELASTIC_TOTAL_STEPS": "8", "ELASTIC_COMMIT_EVERY": "3",
                  "ELASTIC_CACHE_PROBE": "1"},
        rank_env={2: {FAULT_PLAN: kill_plan(3)},
                  0: {"HVD_TIMELINE": str(tl)}}))
    v_code, v_out = outs[2]
    assert v_code == 137, outs[2]
    assert steps_of(v_out)[-1][0] == 3
    views = []
    for r in (0, 1):
        code, out = outs[r]
        assert code == 0, (r, out)
        assert_shrunk(out, 8, 3, 3)
        assert "PARTITION_MINORITY" not in out, out
        views.append(cache_view(out))
    assert views[0] == views[1], views
    assert views[0]["len"] >= 4 and views[0]["hits"] >= 4, views
    assert all(pos >= 0 for _, pos in views[0]["positions"]), views
    text = tl.read_text()
    for rec in ("ELASTIC_RESET", "ELASTIC_REFORM", "ELASTIC_EPOCH_1"):
        assert rec in text, rec


@pytest.mark.timeout(240)
def test_leader_failover_matches_jax_gang(tmp_path):
    """Rank 0, the hub, dies after step 3: old rank 1 leads the re-form
    (it writes the world), every survivor counts one failover and one
    re-form, the promoted rank's timeline appends ``LEADER_FAILOVER`` and
    ``ELASTIC_REFORM`` to the file the dead hub wrote, and the gang
    finishes.  A JAX gang in the same scenario gives the same markers and
    ``FINAL_W``."""
    outs = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        tl = d / "timeline.json"
        outs[pkg] = finish_gang(start_gang(
            [pkg] * 3, str(d), min_np=2,
            base_env={"ELASTIC_TOTAL_STEPS": "8",
                      "ELASTIC_COMMIT_EVERY": "3",
                      "ELASTIC_METRICS": "1", "HVD_TIMELINE": str(tl)},
            rank_env={0: {FAULT_PLAN: kill_plan(3)}}))
        assert outs[pkg][0][0] == 137, outs[pkg][0]
        text = tl.read_text()
        assert text.count("CLOCK_ANCHOR") == 2, text[-2000:]  # appended
        for rec in ("LEADER_FAILOVER", "ELASTIC_REFORM", "ELASTIC_EPOCH_1"):
            assert rec in text, (pkg, rec)
    for r in (1, 2):
        code, out = outs["port"][r]
        assert code == 0, (r, out)
        assert_shrunk(out, 8, 3, 3)
        assert counters(out) == {"hvd_elastic_reforms_total": 1,
                                 "hvd_leader_failovers_total": 1,
                                 "hvd_fenced_writes_total": 0}, out
        j_code, j_out = outs["jax"][r]
        assert j_code == 0, (r, j_out)
        assert steps_of(out) == steps_of(j_out), (out, j_out)
        assert final_w(out) == final_w(j_out)
        for marker in ("RESET size 2", "FINAL_EPOCH 1", "DONE"):
            assert out.count(marker) == j_out.count(marker) == 1, marker


@pytest.mark.timeout(240)
@pytest.mark.parametrize("joiner_after", ["STEP 1 ", ""],
                         ids=["after-step-1", "before-the-gang"])
def test_joiner_grows_gang_and_cold_cache_agrees(tmp_path, joiner_after):
    """A gang of two (max 3) is joined after it trains: the incumbents
    interrupt at a commit, the gang of three syncs the state to the
    joiner, sums rise from 2.0 to 3.0 with no relaunch, every member ends
    with the same ``FINAL_W``, and the joiner's cold response cache gives
    the incumbents' view after the probe.  A joiner that announces itself
    before the incumbents start is admitted too: the first incarnation
    consumes no notification."""
    outs = finish_gang(start_gang(
        ["port"] * 2, str(tmp_path), max_np=3,
        # The gang stops three steps after it reaches three; the step
        # budget only has to outlast a joiner started under load.
        base_env={"ELASTIC_TOTAL_STEPS": "4000", "ELASTIC_COMMIT_EVERY": "1",
                  "ELASTIC_STEP_SLEEP": "0.05", "ELASTIC_STOP_AT_SIZE": "3",
                  "ELASTIC_STEPS_AFTER_GROW": "3",
                  "ELASTIC_CACHE_PROBE": "1"},
        joiner="port", joiner_after=joiner_after))
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
    j_out = outs[2][1]
    j_steps = steps_of(j_out)
    assert j_steps and all(v == 3.0 for _, v in j_steps), j_out
    assert "RESET size" not in j_out
    assert len({final_w(o) for _, o in outs}) == 1, outs
    views = [cache_view(o) for _, o in outs]
    assert all(v == views[0] for v in views), views
    assert views[0]["hits"] >= 4, views


@pytest.mark.timeout(240)
def test_discovery_script_triggers_one_reform(tmp_path):
    """Rank 0 runs the discovery driver; when the script starts reporting
    a third host the gang interrupts at a commit and re-forms at epoch 1,
    once: the restarted driver's baseline poll does not re-form again."""
    marker = tmp_path / "hostC.up"
    polled = tmp_path / "driver.polled"
    script = tmp_path / "discover.sh"
    # The marker is read before the poll stamp is written: a marker
    # written after the stamp shows only in a later poll.
    script.write_text("#!/bin/sh\n"
                      f"if [ -f {marker} ]; then c=1; else c=0; fi\n"
                      "echo hostA\n"
                      "echo hostB\n"
                      f"touch {polled}\n"
                      "if [ $c = 1 ]; then echo hostC; fi\n")
    script.chmod(0o755)
    gang = start_gang(
        ["port"] * 2, str(tmp_path / "gang"), max_np=4,
        base_env={"HVD_HOST_DISCOVERY_SCRIPT": str(script),
                  "HVD_ELASTIC_DISCOVERY_INTERVAL_S": "0.1",
                  "ELASTIC_TOTAL_STEPS": "80", "ELASTIC_COMMIT_EVERY": "1",
                  "ELASTIC_STEP_SLEEP": "0.05"})
    deadline = time.monotonic() + 60
    while not polled.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert polled.exists(), "the discovery driver never polled"
    marker.write_text("up\n")
    outs = finish_gang(gang)
    for r, (code, out) in enumerate(outs):
        assert code == 0, (r, out)
        assert "DONE" in out, (r, out)
        assert out.count("RESET size 2") == 1, out
        assert "FINAL_EPOCH 1" in out, out
        assert all(v == 2.0 for _, v in steps_of(out)), out


@pytest.mark.timeout(200)
@pytest.mark.parametrize("quorum", ["1", "0"])
def test_minority_stops_unless_the_quorum_is_off(tmp_path, quorum):
    """Two of three die at the same step.  With the quorum on, the lone
    survivor holds no strict majority and stops with
    ``PARTITION_MINORITY`` (no re-form, no ``DONE``), though min_np would
    allow one rank; with ``HVD_QUORUM=0`` it re-forms alone and
    finishes."""
    outs = finish_gang(start_gang(
        ["port"] * 3, str(tmp_path),
        base_env={"ELASTIC_TOTAL_STEPS": "8", "HVD_QUORUM": quorum},
        rank_env={r: {FAULT_PLAN: kill_plan(2)} for r in (1, 2)}))
    for r in (1, 2):
        assert outs[r][0] == 137, outs[r]
    code, out = outs[0]
    if quorum == "1":
        assert code != 0, (code, out)
        assert "PARTITION_MINORITY" in out, out
        assert "RESET size" not in out and "DONE" not in out, out
        dumps = os.listdir(tmp_path / "blackbox")
        assert "blackbox_rank0.json" in dumps, dumps
        with open(tmp_path / "blackbox" / "blackbox_rank0.json") as fh:
            assert json.load(fh)["reason"] == "partition_minority"
    else:
        assert code == 0, (code, out)
        assert "PARTITION_MINORITY" not in out, out
        assert "RESET size 1" in out and "DONE" in out, out


@pytest.mark.timeout(200)
def test_stale_epoch_rank_draws_typed_fence(tmp_path):
    """A rank that boots at a stale epoch sends one request frame, draws
    ``TAG_FENCE`` and its allreduce raises ``FencedError``; the
    coordinator notes ``epoch.fence`` and evicts it on heartbeat silence
    (``tests/test_ctrl_tree.py``'s assertions)."""
    from test_torch_liveness import _finish, _start

    outs = _finish(_start(
        ["port", "port"], "fence_stale_epoch", str(tmp_path),
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


def _grad(rank, step, j, n=8):
    """``tests/timeout_worker.py``'s inputs."""
    return (np.arange(n, dtype=np.float32) * (j + 1)
            + 10.0 * rank + 100.0 * step).astype(np.float32)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("fusion", ["fused", "one-a-response"])
def test_stalled_rank_abort_evict_replay_on_shm(tmp_path, fusion):
    """One rank of three wedges its shm receive at step 1: both survivors
    raise ``CollectiveTimeoutError([2])`` within twice the deadline,
    re-form a gang of two, replay the aborted batch (each tensor the
    survivors' retained step-1 inputs summed, bit for bit, as
    ``tests/test_timeouts.py`` checks it), and finish; rank 0's timeline
    holds ``COLLECTIVE_ABORT``, ``ELASTIC_REFORM`` and ``ELASTIC_REPLAY``;
    no shm segment of the gang is left.  With a fusion threshold below
    one tensor the step is three responses: the two after the aborted one
    fail with the same error without touching the links, and their inputs
    are replayed too."""
    import glob

    timeout_s = 2.0
    tl = tmp_path / "timeline.json"
    knobs = {"HVD_FUSION_THRESHOLD": "16"} if fusion != "fused" else {}
    gang = start_gang(
        ["port"] * 3, str(tmp_path), min_np=2, scenario="stall", shm=True,
        base_env={"HVD_COLLECTIVE_TIMEOUT": str(timeout_s),
                  "HVD_COLLECTIVE_PROBE_TIMEOUT": "0.5",
                  "TIMEOUT_SITE": "shm.stall", **knobs},
        rank_env={2: {"TIMEOUT_VICTIM": "1"}, 0: {"HVD_TIMELINE": str(tl)}})
    pids = [p.pid for p in gang[1]]
    outs = finish_gang(gang, stalled=(2,))
    v_code, v_out = outs[2]
    assert "(running when killed: True)" in v_out, v_out
    assert "CTE" not in v_out and "DONE" not in v_out, v_out
    assert dict(steps_of(v_out)) == {0: 30.0}, v_out
    replays = {}
    for r in (0, 1):
        code, out = outs[r]
        assert code == 0, (r, out)
        m = re.search(r"CTE ranks=(\[[^\]]*\]) tensor=(\S+) dt=([\d.]+)",
                      out)
        assert m, out
        assert json.loads(m.group(1)) == [2], out
        assert float(m.group(3)) < 2 * timeout_s, out
        assert dict(steps_of(out)) == {0: 30.0, 1: 210.0, 2: 410.0,
                                       3: 610.0}, out
        assert "FINAL_EPOCH 1" in out and "DONE" in out, out
        replays[r] = {mm.group(1): mm.group(2) for mm in re.finditer(
            r"REPLAY (\S+) ([0-9a-f]+)", out)}
    assert replays[0] == replays[1] and len(replays[0]) == 3, replays
    for j, nm in enumerate(("grad.a", "grad.b", "grad.c")):
        oracle = (_grad(0, 1, j) + _grad(1, 1, j)).tobytes().hex()
        assert replays[0][f"{nm}.s1"] == oracle, (nm, replays[0])
    text = tl.read_text()
    for rec in ("COLLECTIVE_ABORT", "ELASTIC_REFORM", "ELASTIC_REPLAY"):
        assert rec in text, rec
    left = [f for pid in pids for f in glob.glob(f"/dev/shm/hvd-shm-{pid}-*")]
    assert not left, left


def test_group_backed_rank_is_refused(monkeypatch):
    """The one-rank case of a group-backed rank under the wrapper, which
    no longer refuses it: a rank that called ``hvd.init(device="cpu")``
    (a gloo group over a ``HashStore``) runs under ``@hvd.elastic.run``,
    and its group is the wrapper's: a re-form (a host update) destroys it,
    marks the mesh built on it stale, and forms a new gloo group for the
    next incarnation."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, elastic
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel import mesh as M

    for k in list(os.environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)
    # The wrapper freezes the launch's scope here; monkeypatch restores it.
    monkeypatch.setenv("HVD_ELASTIC_SCOPE_BASE", "")
    server = RendezvousServer("127.0.0.1")
    monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_RENDEZVOUS_PORT", str(server.start()))
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_ELASTIC_EPOCH",
              "HVD_RDV_SCOPE", "HVD_LOCAL_RANK", "HVD_LOCAL_SIZE",
              "HVD_CROSS_RANK", "HVD_CROSS_SIZE", "HVD_TPU_CORE"):
        # Set by the wrapper; monkeypatch restores what it recorded.
        monkeypatch.setenv(k, "0")
        monkeypatch.delenv(k)
    hvd.shutdown()
    hvd.init(device="cpu")  # one rank, a gloo group over a HashStore
    try:
        seen = []

        @elastic.run
        def train(state):
            seen.append((basics.has_process_group(), str(dist.get_backend()),
                         id(dist.group.WORLD)))
            if len(seen) == 1:
                state.axis = M.make_mesh().axis("dp")
                raise elastic.HostsUpdatedInterrupt()
            with pytest.raises(M.StaleMeshError, match="re-form"):
                C.allreduce(torch.ones(2), axis=state.axis)
            out = C.allreduce(torch.full((2,), 3.0),
                              axis=M.make_mesh().axis("dp"))
            assert torch.equal(out, torch.full((2,), 3.0))

        train(elastic.ObjectState(step=0))
        assert [s[:2] for s in seen] == [(True, "gloo")] * 2
        assert seen[0][2] != seen[1][2]
        assert os.environ["HVD_ELASTIC_EPOCH"] == "1"
    finally:
        hvd.shutdown()
        server.stop()
