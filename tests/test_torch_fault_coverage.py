"""Fault sites of the port that no scenario test pulls, each fired by a
fault plan and held to the behaviour it must cause: the port's side of
``tests/test_fault_coverage.py`` and ``tests/test_chaos.py``, whose plans
these are.  Where both packages can run the same plan in this process, the
JAX package runs it too and must behave the same.

* ``bootstrap.start``, ``bootstrap.accept``, ``engine.cycle`` and
  ``ctrl.coord.send``: a gang of two port ranks (the Python engine) under
  the harmless delay plan of ``test_gang_walks_bootstrap_cycle_ctrl_and_
  shm_sites`` bootstraps and reduces; each site fires (the plan's
  counts) and every sum has the numpy oracle's bits;
* ``sock.halfopen``: a blackholed outbound path stalls the persistent
  sender, then surfaces as ``ConnectionError`` at ``wait``;
* ``sock.connect``: one injected connect error is retried and a two-rank
  mesh forms; errors past the dial's deadline raise ``ConnectionError``;
* ``kv.server.request``: three 503s are ridden out by the KV client's
  retry, 99 surface as ``HTTPError``;
* ``kv.get``, ``kv.list`` and ``kv.delete``: one injected error is
  absorbed by the KV client's retry (``test_kv_delete_retries_through_
  injected_fault``), and errors past the retry budget raise the injected
  ``ConnectionError``.

The bit flip of the audited state and the corruption of a sealed
checkpoint are held in ``tests/test_torch_audit.py`` and
``tests/test_torch_checkpoint.py``.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_chaos_worker.py")

GANG_PLAN = {"faults": [
    {"site": "bootstrap.start", "kind": "delay", "delay_s": 0.01},
    {"site": "bootstrap.accept", "kind": "delay", "delay_s": 0.01},
    {"site": "engine.cycle", "kind": "delay", "delay_s": 0.005,
     "times": 10},
    {"site": "ctrl.coord.send", "kind": "delay", "delay_s": 0.005,
     "times": 10},
]}


def _pkg(name):
    """The package's fault plan, sockets, KV client and server, and
    bootstrap."""
    if name == "port":
        from horovod_tpu_torch import bootstrap
        from horovod_tpu_torch.common import fault_injection as fi
        from horovod_tpu_torch.runner.http_client import KVClient
        from horovod_tpu_torch.runner.http_server import RendezvousServer
        from horovod_tpu_torch.utils import socketutil as su
    else:
        from horovod_tpu import bootstrap
        from horovod_tpu.common import fault_injection as fi
        from horovod_tpu.runner.http_client import KVClient
        from horovod_tpu.runner.http_server import RendezvousServer
        from horovod_tpu.utils import socketutil as su
    return types.SimpleNamespace(bootstrap=bootstrap, fi=fi, su=su,
                                 KVClient=KVClient,
                                 RendezvousServer=RendezvousServer)


@pytest.fixture(params=["port", "jax"])
def pkg(request, monkeypatch):
    monkeypatch.delenv("HVD_SECRET_KEY", raising=False)
    monkeypatch.setenv("HVD_KV_RETRY_BASE_S", "0.01")
    monkeypatch.setenv("HVD_SHM_DISABLE", "1")
    p = _pkg(request.param)
    p.fi.clear()
    yield p
    p.fi.clear()


def _fired(fi):
    return {f.site: f.fired for f in fi._PLAN.faults}


def test_halfopen_sender_surfaces_at_wait(pkg):
    a, b = socket.socketpair()
    sender = pkg.su.PeerSender(a, name="cov-halfopen")
    try:
        pkg.fi.configure({"faults": [
            {"site": "sock.halfopen", "kind": "halfopen",
             "stall_s": 0.05}]})
        ticket = sender.send(b"payload")
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="peer send failed"):
            sender.wait(ticket, timeout=10.0)
        assert time.monotonic() - t0 < 5.0
        assert _fired(pkg.fi) == {"sock.halfopen": 1}
        # The sender stays failed: a later send is refused at once.
        with pytest.raises(ConnectionError):
            sender.send(b"again")
    finally:
        pkg.fi.clear()
        sender.close(timeout=5.0)
        a.close()
        b.close()


def test_connect_error_is_retried_and_the_mesh_forms(pkg):
    server = pkg.RendezvousServer("127.0.0.1")
    port = server.start()
    out, errors = {}, []

    def rank(r):
        try:
            out[r] = pkg.bootstrap.bootstrap_mesh(r, 2, "127.0.0.1", port)
        except BaseException as e:  # re-raised below
            errors.append(e)

    try:
        pkg.fi.configure({"faults": [
            {"site": "sock.connect", "kind": "error", "times": 1}]})
        threads = [threading.Thread(target=rank, args=(r,), daemon=True)
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        fired = pkg.fi._PLAN.faults[0]
        # Rank 1 dials rank 0 twice (data, control); the first dial failed
        # once and was retried.
        assert fired.fired == 1 and fired.hits == 3, \
            (fired.fired, fired.hits)
        data0, _, ctrl_socks0 = out[0][:3]
        data1, ctrl1 = out[1][:2]
        assert set(data0) == {1} and set(ctrl_socks0) == {1}
        assert set(data1) == {0} and ctrl1 is not None
        data1[0].sendall(b"ping")
        assert pkg.su.recv_exact(data0[1], 4) == b"ping"
        ctrl1.sendall(b"ctl!")
        assert pkg.su.recv_exact(ctrl_socks0[1], 4) == b"ctl!"
    finally:
        pkg.fi.clear()
        for got in out.values():
            socks = list(got[0].values()) + list(got[2].values()) + \
                [got[1]]
            for s in socks:
                if s is not None:
                    s.close()
        server.stop()


def test_connect_errors_past_the_deadline_raise(pkg):
    listener = pkg.su.listen_on("127.0.0.1")
    port = listener.getsockname()[1]
    try:
        pkg.fi.configure({"faults": [
            {"site": "sock.connect", "kind": "error", "times": 99}]})
        t0 = time.monotonic()
        with pytest.raises(ConnectionError,
                           match=f"cannot connect to 127.0.0.1:{port}"):
            pkg.su.connect_retry("127.0.0.1", port, timeout=0.3,
                                 interval=0.01)
        assert time.monotonic() - t0 < 5.0
        assert 1 <= _fired(pkg.fi)["sock.connect"] < 99
    finally:
        pkg.fi.clear()
        listener.close()


def test_kv_client_retries_through_server_503s(pkg):
    server = pkg.RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        kv = pkg.KVClient("127.0.0.1", port)
        pkg.fi.configure({"faults": [
            {"site": "kv.server.request", "kind": "error", "times": 3}]})
        kv.put("chaos/key", b"v1")  # three 503s, lands on the 4th attempt
        assert _fired(pkg.fi) == {"kv.server.request": 3}
        assert kv.get_bytes("chaos/key") == b"v1"
        pkg.fi.clear()
        assert kv.get_bytes("chaos/missing") is None  # 404 is an answer
        # An outage longer than the retry budget surfaces.
        pkg.fi.configure({"faults": [
            {"site": "kv.server.request", "kind": "error", "times": 99}]})
        with pytest.raises(urllib.error.HTTPError) as e:
            kv.put("chaos/key2", b"x")
        assert e.value.code == 503
        pkg.fi.clear()
        assert kv.get_bytes("chaos/key2") is None
    finally:
        pkg.fi.clear()
        server.stop()


@pytest.mark.parametrize("site", ["kv.get", "kv.list", "kv.delete"])
def test_kv_client_retries_through_an_injected_fault(pkg, site):
    server = pkg.RendezvousServer("127.0.0.1")
    port = server.start()
    calls = {"kv.get": lambda kv: kv.get("cov/x"),
             "kv.list": lambda kv: sorted(kv.list("cov/")),
             "kv.delete": lambda kv: kv.delete("cov/x")}
    try:
        kv = pkg.KVClient("127.0.0.1", port)
        kv.put("cov/x", "1")
        pkg.fi.configure({"faults": [
            {"site": site, "kind": "error", "times": 1}]})
        got = calls[site](kv)
        assert _fired(pkg.fi) == {site: 1}
        pkg.fi.clear()
        if site == "kv.delete":
            assert kv.get("cov/x") is None
        else:
            assert got == ("1" if site == "kv.get" else ["cov/x"]), got
        kv.put("cov/x", "1")
        pkg.fi.configure({"faults": [{"site": site, "kind": "error"}]})
        with pytest.raises(ConnectionError):
            calls[site](kv)
        assert _fired(pkg.fi) == {site: kv.attempts}
    finally:
        pkg.fi.clear()
        server.stop()


@pytest.fixture(scope="module")
def gang():
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    np_ = 2
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    procs, outs = [], []
    try:
        for rank in range(np_):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("HVD_", "HOROVOD_"))}
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            env.update({
                "HVD_RANK": str(rank), "HVD_SIZE": str(np_),
                "HVD_LOCAL_RANK": str(rank), "HVD_LOCAL_SIZE": str(np_),
                "HVD_CROSS_RANK": "0", "HVD_CROSS_SIZE": "1",
                "HVD_RENDEZVOUS_ADDR": "127.0.0.1",
                "HVD_RENDEZVOUS_PORT": str(port),
                "HVD_TPU_CORE": "py", "HVD_SHM_DISABLE": "1",
                "OMP_NUM_THREADS": "1",
                "HOROVOD_FAULT_PLAN": json.dumps(GANG_PLAN),
            })
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, "bootstrap_allreduce", "port"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 120.0
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} hung under delays")
            outs.append((p.returncode, out.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    return outs


def _grad(rank, step, n=8):
    """The worker's ``grad(rank, step, 0)``."""
    return (np.arange(n, dtype=np.float32) + 10.0 * rank
            + 100.0 * step).astype(np.float32)


def _marker(out, name):
    for line in out.splitlines():
        if line.startswith(name + " "):
            return line[len(name) + 1:]
    raise AssertionError(f"no {name} line in {out}")


@pytest.mark.timeout(180)
def test_gang_bootstraps_and_reduces_under_delay_faults(gang):
    want = [(_grad(0, s) + _grad(1, s)).astype(np.float32).tobytes().hex()
            for s in range(3)]
    for rank, (code, out) in enumerate(gang):
        assert code == 0, (rank, out)
        got_rank, sums = _marker(out, "BOOT_OK").split(" ", 1)
        assert int(got_rank) == rank
        assert json.loads(sums) == want, (rank, out)


@pytest.mark.timeout(180)
@pytest.mark.parametrize("site,ranks", [
    ("bootstrap.start", (0, 1)),
    ("bootstrap.accept", (0,)),  # rank 0 accepts rank 1's two dials
    ("engine.cycle", (0, 1)),
    ("ctrl.coord.send", (0,)),  # the coordinator's sends
])
def test_gang_fires_each_site(gang, site, ranks):
    for rank, (code, out) in enumerate(gang):
        fired = json.loads(_marker(out, "FIRED"))
        if rank in ranks:
            assert fired[site] >= 1, (rank, fired)
        if site == "bootstrap.accept":
            assert fired[site] == (2 if rank == 0 else 0), (rank, fired)
