"""The port's gang-wide serving loop (``horovod_tpu_torch/serving/loop.py``)
and its channel, against the JAX package's.

* The serve delta (``TAG_SERVE``): ``encode_serve_delta``'s bytes equal the
  JAX package's for the same inputs, and each side decodes the other's
  (empty, stop, admissions, a leader address, epochs).
* The engines' channel: a ``SingleProcessEngine``'s broadcast is a local
  enqueue, and ``serve_recv`` wakes on shutdown.
* Gangs of ``tests/torch_port_serve_worker.py`` (the JAX package's
  ``tests/serve_worker.py`` on the port) with ``tests/test_serving.py``'s
  tiny fp32 model, weights from the JAX package's ``tfm.init(PRNGKey(0),
  cfg)`` through ``models/convert.py``.  Every reply must equal the JAX
  package's greedy ``generate`` oracle (``_oracle_tokens``) token for
  token:

  - one process with no rendezvous (size 1);
  - two ranks, six concurrent requests through two slots, half posted to
    the follower's door, which forwards: ``attempts == 1``;
  - a stalled rank: rank 1 arms ``sock.stall`` mid-serving, its deadline
    evicts it, rank 0 re-forms alone and replays the in-flight requests
    (``tests/test_serving.py:533``'s scenario);
  - leader failover: three ranks, rank 0 SIGKILLed with four requests in
    flight; rank 1 is promoted, the clients' re-POSTs to its door finish
    with ``attempts > 1``, and ``LEADER_FAILOVER`` naming rank 0 is on its
    timeline (``tests/test_leader_failover.py:71``);
  - the KV primary, started by ``python -m
    horovod_tpu_torch.runner.http_server`` and mirrored to a standby,
    SIGKILLed mid-re-form: the survivors of an elastic training gang
    rotate to the standby and finish (``tests/test_leader_failover.py:
    224``).

Every gang pins ``HVD_SHM_DISABLE=1`` (a SIGKILLed rank cannot unlink its
shm segments) and runs in the test's temporary directory.
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

from horovod_tpu_torch.common import wire as pwire
from horovod_tpu_torch.runner.http_server import RendezvousServer

from test_serving import CACHE_LEN, MODEL, _http, _oracle_tokens

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_serve_worker.py")
ELASTIC_WORKER = os.path.join(HERE, "torch_port_elastic_worker.py")


# ---------------------------------------------------------------------------
# the serve delta against the JAX package's
# ---------------------------------------------------------------------------

DELTAS = {
    "empty": (9, False, [], 4, ""),
    "stop": (1, True, [], 0, ""),
    "admissions": (7, False, [(0, "r12", 16, [3, 14, 15]),
                              (3, "r13", 1, [62])], 2, ""),
    "leader": (11, False, [(1, "cli0", 24, list(range(40)))], 0,
               "10.0.0.7:8100"),
    "epochs": (2 ** 40, False, [(5, "x" * 33, 7, [2 ** 31])], 2 ** 32 - 1,
               "127.0.0.1:1"),
}


@pytest.mark.parametrize("case", sorted(DELTAS))
def test_serve_delta_bytes_match_jax(case):
    from horovod_tpu.common import wire as jwire

    seq, stop, adm, epoch, leader = DELTAS[case]
    got = pwire.encode_serve_delta(seq, stop, adm, epoch, leader_addr=leader)
    want = jwire.encode_serve_delta(seq, stop, adm, epoch,
                                    leader_addr=leader)
    assert got == want
    # Each side decodes the other's frame.
    assert pwire.decode_serve_delta_ex(want) == (seq, stop, adm, epoch,
                                                 leader)
    assert jwire.decode_serve_delta_ex(got) == (seq, stop, adm, epoch,
                                                leader)
    assert pwire.decode_serve_delta(want) == jwire.decode_serve_delta(got)


def test_serve_delta_without_trailer_decodes_empty_leader():
    """A frame cut at the epoch (an encoder without the leader trailer)
    decodes with leader ``""`` on both sides."""
    from horovod_tpu.common import wire as jwire

    full = pwire.encode_serve_delta(3, False, [(0, "a", 2, [1])], 5)
    cut = full[:-4]  # the empty varstr
    assert pwire.decode_serve_delta_ex(cut) == \
        jwire.decode_serve_delta_ex(cut) == \
        (3, False, [(0, "a", 2, [1])], 5, "")


def test_single_process_engine_serve_channel():
    from horovod_tpu_torch import runtime_py

    eng = runtime_py.SingleProcessEngine()
    try:
        eng.serve_broadcast(b"a")
        eng.serve_broadcast(b"b")
        assert eng.serve_recv(0.1) == b"a"
        assert eng.serve_recv(0.1) == b"b"
        t0 = time.monotonic()
        assert eng.serve_recv(0.1) is None  # a plain timeout
        assert time.monotonic() - t0 >= 0.09
        threading.Timer(0.1, eng.shutdown).start()
        t0 = time.monotonic()
        assert eng.serve_recv(30.0) is None  # woken by the shutdown
        assert time.monotonic() - t0 < 5.0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# gang helpers
# ---------------------------------------------------------------------------


def _save_weights(path):
    """The JAX init of ``tests/test_serving.py``'s model as the port's
    state dict: every rank loads the same bits."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    from horovod_tpu_torch.models import convert

    cfg = jtfm.TransformerConfig(max_seq_len=CACHE_LEN,
                                 compute_dtype=jnp.float32, remat=False,
                                 **MODEL)
    params = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), cfg))
    torch.save(convert.params_from_jax(params), path)
    return path


def _env(tmp, rank, np_, rport, *, min_np=None, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({
        "SERVE_WEIGHTS": str(tmp / "weights.pt"),
        "SERVE_CACHE_LEN": str(CACHE_LEN),
        "HVD_SHM_DISABLE": "1",
        "HVD_BLACKBOX_DIR": str(tmp / "blackbox"),
    })
    if np_ > 1:
        env.update({
            "HVD_RANK": str(rank), "HVD_SIZE": str(np_),
            "HVD_LOCAL_RANK": str(rank), "HVD_LOCAL_SIZE": str(np_),
            "HVD_CROSS_RANK": "0", "HVD_CROSS_SIZE": "1",
            "HVD_RENDEZVOUS_ADDR": "127.0.0.1",
            "HVD_RENDEZVOUS_PORT": str(rport),
            "HVD_ELASTIC_EPOCH": "0",
            "HVD_ELASTIC_MIN_NP": str(min_np or np_),
            "HVD_ELASTIC_MAX_NP": str(np_),
            "HVD_ELASTIC_UID": f"uid-{rank}",
            "HVD_ELASTIC_CHECK_INTERVAL_S": "0.05",
        })
    env.update(extra or {})
    return env


def _start(tmp, envs):
    procs = []
    for r, env in enumerate(envs):
        with open(tmp / f"out{r}", "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER], env=env, cwd=str(tmp), stdout=out,
                stderr=subprocess.STDOUT))
    return procs


def _out(tmp, r):
    return (tmp / f"out{r}").read_text(errors="replace")


def _wait_file(path, procs, tmp, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return open(path).read()
        for r, p in enumerate(procs):
            if p.poll() is not None:
                raise AssertionError(
                    f"rank {r} died before serving: {_out(tmp, r)}")
        time.sleep(0.02)
    raise AssertionError(f"{path} never appeared")


def _post_all(reqs, results, timeout_s=90.0):
    """One client thread per request ``(door port, id or None, prompt,
    max_new)``, each blocking on its /generate."""
    def client(i, port, rid, prompt, max_new):
        body = {"prompt": prompt, "max_new_tokens": max_new}
        if rid is not None:
            body["id"] = rid
        try:
            results[i] = _http(port, "POST", "/generate", body,
                               timeout=timeout_s)
        except Exception as e:  # reported by the caller's assert
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,) + req, daemon=True)
               for i, req in enumerate(reqs)]
    for t in threads:
        t.start()
    return threads


def _finish(procs, timeout=60.0):
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _final_epoch(out):
    return int(re.search(r"GEN_FINAL (\d+)", out).group(1))


# ---------------------------------------------------------------------------
# the gangs
# ---------------------------------------------------------------------------


@pytest.mark.timeout(60)
def test_single_process_loop_serves_oracle_exact(tmp_path):
    """Size 1, no rendezvous: one incarnation, the broadcast a local
    enqueue."""
    _save_weights(tmp_path / "weights.pt")
    env = _env(tmp_path, 0, 1, 0, extra={
        "SERVE_PORT_FILE": str(tmp_path / "port0"),
        "SERVE_READY_FILE": str(tmp_path / "ready"), "SERVE_EXPECT": "3"})
    procs = _start(tmp_path, [env])
    try:
        _wait_file(tmp_path / "ready", procs, tmp_path)
        port = int(_wait_file(tmp_path / "port0", procs, tmp_path))
        reqs = [(port, None, [3 + i, 14, 15], 6 + 2 * i) for i in range(3)]
        results = {}
        for t in _post_all(reqs, results):
            t.join(timeout=60)
        _finish(procs)
    finally:
        _kill_all(procs)
    out = _out(tmp_path, 0)
    assert procs[0].returncode == 0 and "DONE" in out, out
    for i, (_, _, prompt, max_new) in enumerate(reqs):
        code, body = results[i]
        assert code == 200, body
        got = json.loads(body)
        assert got["tokens"] == _oracle_tokens(prompt, max_new), i
        assert got["attempts"] == 1


@pytest.mark.timeout(60)
def test_gang_serves_concurrent_requests_oracle_exact(tmp_path):
    """Two ranks, six concurrent requests through two slots (requests
    queue and join at token boundaries as earlier ones retire); three go
    to the follower's door, which forwards them to the leader."""
    np_ = 2
    _save_weights(tmp_path / "weights.pt")
    server = RendezvousServer("127.0.0.1")
    rport = server.start()
    envs = []
    for r in range(np_):
        extra = {"SERVE_PORT_FILE": str(tmp_path / f"port{r}")}
        if r == 0:
            extra.update(SERVE_EXPECT="6",
                         SERVE_READY_FILE=str(tmp_path / "ready"))
        envs.append(_env(tmp_path, r, np_, rport, extra=extra))
    procs = _start(tmp_path, envs)
    results = {}
    try:
        _wait_file(tmp_path / "ready", procs, tmp_path)
        ports = [int(_wait_file(tmp_path / f"port{r}", procs, tmp_path))
                 for r in range(np_)]
        reqs = [(ports[i % 2], None, [3 + i, 14, 15], 6 + 2 * (i % 3))
                for i in range(6)]
        for t in _post_all(reqs, results):
            t.join(timeout=60)
        _finish(procs)
    finally:
        _kill_all(procs)
        server.stop()
    for r in range(np_):
        out = _out(tmp_path, r)
        assert procs[r].returncode == 0 and "DONE" in out, (r, out)
        assert _final_epoch(out) == 0, out  # no re-form
    for i, (_, _, prompt, max_new) in enumerate(reqs):
        assert not isinstance(results.get(i), Exception), results.get(i)
        code, body = results[i]
        assert code == 200, (i, body)
        got = json.loads(body)
        assert got["tokens"] == _oracle_tokens(prompt, max_new), i
        assert got["attempts"] == 1, got


@pytest.mark.timeout(60)
def test_gang_evicts_stalled_rank_and_replays(tmp_path):
    """Rank 1 arms a 600 s transport stall before serve frame 3, wedging
    itself inside that step's token-agreement allreduce.  The 2 s
    collective deadline evicts it, rank 0 re-forms alone, and the
    in-flight requests replay from their prompts to the oracle's tokens:
    clients see ``attempts > 1``, never an error."""
    np_, victim = 2, 1
    reqs_spec = [([3, 14, 15], 24), ([4, 14, 15], 24), ([5, 14, 15], 24)]
    _save_weights(tmp_path / "weights.pt")
    server = RendezvousServer("127.0.0.1")
    rport = server.start()
    envs = []
    for r in range(np_):
        extra = {"HVD_COLLECTIVE_TIMEOUT": "2.0",
                 "HVD_COLLECTIVE_PROBE_TIMEOUT": "0.5"}
        if r == 0:
            extra.update(SERVE_PORT_FILE=str(tmp_path / "port0"),
                         SERVE_READY_FILE=str(tmp_path / "ready"),
                         SERVE_EXPECT=str(len(reqs_spec)))
        if r == victim:
            extra.update(SERVE_VICTIM="1", SERVE_STALL_SEQ="3")
        envs.append(_env(tmp_path, r, np_, rport, min_np=1, extra=extra))
    procs = _start(tmp_path, envs)
    results = {}
    try:
        _wait_file(tmp_path / "ready", procs, tmp_path)
        port = int(_wait_file(tmp_path / "port0", procs, tmp_path))
        reqs = [(port, None, p, m) for p, m in reqs_spec]
        for t in _post_all(reqs, results):
            t.join(timeout=60)
        _finish(procs[:1])
        victim_running = procs[victim].poll() is None
    finally:
        _kill_all(procs)
        server.stop()
    assert victim_running, "the victim exited: the stall never wedged it"
    assert "DONE" not in _out(tmp_path, victim)
    out0 = _out(tmp_path, 0)
    assert procs[0].returncode == 0 and "DONE" in out0, out0
    assert _final_epoch(out0) >= 1, out0  # a re-form happened
    replayed = 0
    for i, (prompt, max_new) in enumerate(reqs_spec):
        assert not isinstance(results.get(i), Exception), results.get(i)
        code, body = results[i]
        assert code == 200, (i, body)
        got = json.loads(body)
        assert got["tokens"] == _oracle_tokens(prompt, max_new), i
        replayed += int(got["attempts"] > 1)
    assert replayed >= 1, results


def _repost_until_served(port, rid, prompt, max_new, out, deadline):
    """After the leader died mid-request, re-POST the same id to a
    survivor's door until the promoted leader answers 200 (503s and
    refused connections during the re-election are expected)."""
    while time.monotonic() < deadline:
        try:
            code, body = _http(port, "POST", "/generate",
                               {"id": rid, "prompt": prompt,
                                "max_new_tokens": max_new}, timeout=60.0)
        except Exception:
            time.sleep(0.1)
            continue
        if code == 200:
            out[rid] = json.loads(body)
            return
        time.sleep(0.1)
    out[rid] = None


@pytest.mark.timeout(60)
def test_rank0_sigkill_mid_serving_promotes_survivor(tmp_path):
    """SIGKILL the serving leader once its four decode slots are live in
    rank 1's slot table (every step delayed 50 ms on rank 0, so that the
    requests are still in flight).  Ranks 1 and 2 re-form, rank 1 is
    promoted and replays the shadow's requests; every request completes at
    its door with the oracle's tokens and ``attempts > 1``, and its
    timeline has ``LEADER_FAILOVER`` naming rank 0."""
    np_ = 3
    reqs = [(f"cli{i}", [3 + i, 14, 15], 24) for i in range(4)]
    tl = tmp_path / "failover_timeline.json"
    _save_weights(tmp_path / "weights.pt")
    server = RendezvousServer("127.0.0.1")
    rport = server.start()
    envs = []
    for r in range(np_):
        extra = {"SERVE_MAX_BATCH": "4",
                 "HVD_COLLECTIVE_TIMEOUT": "5.0",
                 "HVD_COLLECTIVE_PROBE_TIMEOUT": "0.5",
                 "HVD_KV_RETRY_BASE_S": "0.02",
                 "SERVE_EXPECT": "0" if r == 0 else str(len(reqs))}
        if r < 2:
            extra["SERVE_PORT_FILE"] = str(tmp_path / f"port{r}")
        if r == 0:
            extra["SERVE_READY_FILE"] = str(tmp_path / "ready")
            extra["HOROVOD_FAULT_PLAN"] = json.dumps({"faults": [
                {"site": "serve.step", "kind": "delay", "delay_s": 0.05}]})
        if r == 1:
            extra["HVD_TIMELINE"] = str(tl)
            extra["SERVE_SHADOW_FILE"] = str(tmp_path / "shadow_full")
        envs.append(_env(tmp_path, r, np_, rport, min_np=2, extra=extra))
    procs = _start(tmp_path, envs)
    results, phase1 = {}, {}
    try:
        _wait_file(tmp_path / "ready", procs, tmp_path)
        port0, port1 = (int(_wait_file(tmp_path / f"port{r}", procs,
                                       tmp_path)) for r in range(2))
        _post_all([(port0, rid, p, m) for rid, p, m in reqs], phase1)
        _wait_file(tmp_path / "shadow_full", procs, tmp_path, 30.0)
        code, body = _http(port0, "GET", "/stats", timeout=5.0)
        assert json.loads(body)["active"] == 4, body
        procs[0].kill()  # SIGKILL, mid-decode
        reposters = [threading.Thread(
            target=_repost_until_served,
            args=(port1, rid, p, m, results, time.monotonic() + 60.0),
            daemon=True) for rid, p, m in reqs]
        for t in reposters:
            t.start()
        for t in reposters:
            t.join(timeout=70)
        _finish(procs[1:])
        procs[0].wait(timeout=10)
    finally:
        _kill_all(procs)
        server.stop()
    assert procs[0].returncode == -9
    for r in (1, 2):
        out = _out(tmp_path, r)
        assert procs[r].returncode == 0 and "DONE" in out, (r, out)
        assert _final_epoch(out) >= 1, out
    for rid, prompt, max_new in reqs:
        got = results.get(rid)
        assert got is not None, (rid, results)
        assert got["tokens"] == _oracle_tokens(prompt, max_new), rid
        assert got["attempts"] > 1, (rid, got)
    text = tl.read_text()
    recs = [json.loads(line.rstrip().rstrip(","))
            for line in text.splitlines() if "LEADER_FAILOVER" in line]
    assert any(0 in ((rec.get("args") or {}).get("failed") or [])
               for rec in recs), text[-2000:]


def _start_primary_kv(tmp_path, standby_port):
    """The primary KV server as a killable process of the port's CLI,
    mirrored to the in-process standby."""
    port_file = str(tmp_path / "kv_port")
    env = {k: v for k, v in os.environ.items() if k != "HVD_SECRET_KEY"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.http_server",
         "--host", "127.0.0.1", "--port", "0", "--port-file", port_file,
         "--mirror", f"127.0.0.1:{standby_port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            return proc, int(open(port_file).read())
        if proc.poll() is not None:
            raise AssertionError(f"primary KV died: {proc.communicate()}")
        time.sleep(0.02)
    proc.kill()
    raise AssertionError("the primary KV never wrote its port file")


@pytest.mark.timeout(60)
def test_kv_primary_sigkill_mid_reform_uses_standby(tmp_path):
    """Rank 2 of 3 dies after step 3 (the re-form's trigger); the moment it
    is gone the primary KV server is SIGKILLed too.  The survivors'
    rendezvous traffic rotates to the mirrored standby inside the retry
    budget, and the epoch-1 re-form completes over the mirrored state."""
    standby = RendezvousServer("127.0.0.1")
    sport = standby.start()
    primary, pport = _start_primary_kv(tmp_path, sport)
    np_, victim, total = 3, 2, 8
    procs = []
    try:
        for r in range(np_):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            env.update({
                "HVD_RANK": str(r), "HVD_SIZE": str(np_),
                "HVD_LOCAL_RANK": str(r), "HVD_LOCAL_SIZE": str(np_),
                "HVD_CROSS_RANK": "0", "HVD_CROSS_SIZE": "1",
                "HVD_RENDEZVOUS_ADDR": "127.0.0.1",
                "HVD_RENDEZVOUS_PORT": str(pport),
                "HVD_KV_ADDRS": f"127.0.0.1:{pport},127.0.0.1:{sport}",
                "HVD_KV_RETRY_BASE_S": "0.02",
                "HVD_SHM_DISABLE": "1",
                "HVD_BLACKBOX_DIR": str(tmp_path / "blackbox"),
                "HVD_ELASTIC_EPOCH": "0", "HVD_ELASTIC_MIN_NP": "2",
                "HVD_ELASTIC_MAX_NP": str(np_),
                "HVD_ELASTIC_UID": f"uid-{r}",
                "HVD_ELASTIC_CHECK_INTERVAL_S": "0.05",
                "HVD_HEARTBEAT_TIMEOUT": "2.0",
                "HVD_HEARTBEAT_INTERVAL": "0.25",
                "ELASTIC_TOTAL_STEPS": str(total),
                "ELASTIC_COMMIT_EVERY": "3",
            })
            if r == victim:
                env["HOROVOD_FAULT_PLAN"] = json.dumps({"faults": [
                    {"site": "train.step", "kind": "kill", "after": 3}]})
            with open(tmp_path / f"out{r}", "wb") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, ELASTIC_WORKER, "train"], env=env,
                    cwd=str(tmp_path), stdout=out,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 60.0
        while procs[victim].poll() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert procs[victim].poll() == 137, "the victim never died"
        primary.kill()
        _finish(procs)
    finally:
        _kill_all(procs)
        primary.kill()
        primary.wait(timeout=10)
        standby.stop()
    for r in (0, 1):
        out = _out(tmp_path, r)
        assert procs[r].returncode == 0, (r, out)
        assert "RESET size 2" in out and "FINAL_EPOCH 1" in out, (r, out)
        assert "DONE" in out, (r, out)
        steps = dict((int(m.group(1)), float(m.group(2)))
                     for m in re.finditer(r"STEP (\d+) ([\d.]+)", out))
        assert sorted(steps) == list(range(total)), out
    # The standby holds the re-formed world the survivors wrote there.
    assert standby.get("elastic/world/1") is not None
