"""The port's multi-host bootstrap (``parallel/multihost.py``) and its
rendezvous KV client (``runner/http_client.py``), on the CPU.

* The JAX package's launcher (``python -m horovod_tpu.runner.run -np 2``)
  runs two port workers (``tests/torch_port_multihost_worker.py``): each
  calls ``init_torch_distributed()``, which publishes or learns the store's
  address on the launcher's KV with the launcher's job secret, then forms a
  gloo group and allreduces.
* A single process is a no-op.
* The KV client against the JAX package's ``RendezvousServer``: ``put`` and
  ``wait_get`` with and without a secret, a wrong secret refused, a stale
  epoch fenced, endpoint failover.
"""

import os
import subprocess
import sys
import threading
import time
import urllib.error

import pytest

from horovod_tpu_torch.common.types import FencedError
from horovod_tpu_torch.runner import http_client
from horovod_tpu_torch.runner.http_client import KVClient, parse_kv_addrs

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_multihost_worker.py")


def _clean_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in list(env):
        if k.startswith(("HVD_", "MASTER_")) or k in ("RANK", "WORLD_SIZE"):
            env.pop(k)
    return env


@pytest.mark.timeout(200)
def test_launcher_gang_forms_through_the_kv():
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.runner.run", "-np", "2", "--",
         sys.executable, WORKER],
        env=_clean_env(), cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    lines = [ln for ln in proc.stdout.splitlines() if "allreduce OK" in ln]
    assert len(lines) == 2, proc.stdout
    assert all("signed True" in ln for ln in lines), proc.stdout
    # Both ranks met at the one address rank 0 published.
    stores = {ln.split("store ")[1].split(",")[0] for ln in lines}
    assert len(stores) == 1, lines


@pytest.mark.timeout(120)
def test_single_process_is_noop():
    proc = subprocess.run([sys.executable, WORKER], env=_clean_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=100)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "rank 0 of 1: store None:None, signed False, allreduce OK" in \
        proc.stdout


@pytest.fixture
def server(request):
    from horovod_tpu.runner.http_server import RendezvousServer

    srv = RendezvousServer(host="127.0.0.1", port=0,
                           secret=getattr(request, "param", None))
    port = srv.start()
    yield port
    srv.stop()


@pytest.fixture(autouse=True)
def _no_kv_env(monkeypatch):
    for k in ("HVD_SECRET_KEY", "HVD_KV_ADDRS", "HVD_ELASTIC_EPOCH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_KV_RETRY_BASE_S", "0.01")


@pytest.mark.parametrize("server", [None, "s3cret"], indirect=True,
                         ids=["open", "signed"])
def test_put_and_wait_get(server):
    # The open server takes the signed requests too.
    kv = KVClient("127.0.0.1", server, secret="s3cret")
    assert kv.get("hvd/missing") is None
    threading.Timer(0.2, kv.put, ("hvd/late", "10.0.0.1:1234")).start()
    assert kv.wait_get("hvd/late", timeout=10.0) == "10.0.0.1:1234"
    kv.put("hvd/bytes", b"\x00\xff")
    assert kv.get_bytes("hvd/bytes") == b"\x00\xff"
    with pytest.raises(TimeoutError, match="hvd/never"):
        kv.wait_get("hvd/never", timeout=0.2)
    assert kv.local_address() == "127.0.0.1"


@pytest.mark.parametrize("server", ["s3cret"], indirect=True)
def test_wrong_or_missing_secret_is_refused(server, monkeypatch):
    for client in (KVClient("127.0.0.1", server, secret="wrong"),
                   KVClient("127.0.0.1", server)):
        with pytest.raises(urllib.error.HTTPError) as e:
            client.put("hvd/x", "1")
        assert e.value.code == 403
    # The secret comes from the launcher's environment by default.
    monkeypatch.setenv("HVD_SECRET_KEY", "s3cret")
    KVClient("127.0.0.1", server).put("hvd/x", "1")


def test_stale_epoch_is_fenced(server, monkeypatch):
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "3")
    KVClient("127.0.0.1", server).put("hvd/elastic/roster", "a")
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "2")
    with pytest.raises(FencedError) as e:
        KVClient("127.0.0.1", server).put("hvd/elastic/roster", "b")
    assert (e.value.stale_epoch, e.value.current_epoch) == (2, 3)
    # Keys outside elastic/ never fence.
    KVClient("127.0.0.1", server).put("hvd/other", "c")


def test_failover_rotates_to_the_next_endpoint(server, monkeypatch):
    dead = http_client.socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    monkeypatch.setenv("HVD_KV_ADDRS",
                       f"127.0.0.1:{dead_port},127.0.0.1:{server}")
    kv = KVClient("ignored", 1)
    t0 = time.monotonic()
    kv.put("hvd/k", "v")
    assert kv.port == server and time.monotonic() - t0 < 10
    assert kv.get("hvd/k") == "v"


@pytest.mark.parametrize("spec,match", [
    ("a:1,,b:2", "empty entry"), ("nohost", "not host:port"),
    ("h:x", "non-numeric"), ("h:70000", "outside"),
], ids=["empty", "no-colon", "port-text", "port-range"])
def test_parse_kv_addrs_refuses(spec, match):
    with pytest.raises(ValueError, match=match):
        parse_kv_addrs(spec)
    assert parse_kv_addrs("a:1, b:2") == [("a", 1), ("b", 2)]


def test_missing_rendezvous_raises(monkeypatch):
    from horovod_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "_initialized", False)
    for k in ("HVD_RENDEZVOUS_ADDR", "HVD_RENDEZVOUS_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_RANK", "1")
    monkeypatch.setenv("HVD_SIZE", "2")
    with pytest.raises(RuntimeError, match="HVD_RENDEZVOUS_ADDR/PORT"):
        multihost.init_torch_distributed()


def test_rank1_waits_for_the_key_and_sets_the_store(server, monkeypatch):
    from horovod_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setenv("HVD_RANK", "1")
    monkeypatch.setenv("HVD_SIZE", "2")
    monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_RENDEZVOUS_PORT", str(server))
    monkeypatch.setenv("HVD_RDV_SCOPE", "attempt1")
    # Set, so that monkeypatch restores them after the call overwrites them.
    monkeypatch.setenv("MASTER_ADDR", "unset")
    monkeypatch.setenv("MASTER_PORT", "unset")
    kv = KVClient("127.0.0.1", server)
    threading.Timer(0.2, kv.put, ("hvd/attempt1/torch_coordinator",
                                  "10.1.2.3:4567")).start()
    multihost.init_torch_distributed(timeout=10.0)
    assert (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]) == (
        "10.1.2.3", "4567")
    # The JAX package's key is a different one.
    assert kv.get("hvd/attempt1/jax_coordinator") is None


@pytest.mark.parametrize("cross", [None, ("1", "3")], ids=["one-host",
                                                          "launcher"])
def test_num_slices_counts_hosts(monkeypatch, cross):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import num_slices

    for k in ("HVD_CROSS_RANK", "HVD_CROSS_SIZE", "HVD_RANK", "HVD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if cross:
        monkeypatch.setenv("HVD_CROSS_RANK", cross[0])
        monkeypatch.setenv("HVD_CROSS_SIZE", cross[1])
    hvd.init(device="cpu")
    try:
        assert num_slices() == hvd.cross_size() == (int(cross[1]) if cross
                                                    else 1)
    finally:
        hvd.shutdown()
