"""The port's recovery ladder (``horovod_tpu_torch/utils/ladder.py``,
``HVD_WIRE_CRC=1``), in process.

* The trailer, NACK and RESUME bytes equal the JAX package's, and so does
  ``WireCorruptionError``'s surface.
* Each rung on port link pairs (``make_ladder_pair``), over TCP and over
  shm, as ``tests/test_ladder.py`` runs them for the JAX package: a clean
  transfer, rung 1 (a corrupt frame is NACKed and retransmitted), rung 2
  (a reset socket is re-dialed and RESUMEd), rung 3 (shm fails over to
  TCP), rung 4 (exhaustion raises ``WireCorruptionError``), and more
  frames than the retention window.  The assertions are on what the link
  delivers and on its medium.
* With the knob off the plain transports put the plain frames on the
  wire, no trailer.
* Across the packages: one end a JAX ``LadderLink``, the other a port one,
  over a socket pair and over one shm segment; each side's fault plan in
  turn (the two packages' plans are separate globals), rungs 1-3 heal both
  ways.
"""

import socket
import threading
import time

import numpy as np
import pytest

from horovod_tpu.common import fault_injection as jfi
from horovod_tpu.common import wire as jwire
from horovod_tpu.utils import ladder as jladder
from horovod_tpu.utils import socketutil as jsu
from horovod_tpu.utils import transport as jtpt
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import ladder
from horovod_tpu_torch.utils import socketutil as su
from horovod_tpu_torch.utils import transport as tpt

PKGS = {"jax": (jladder, jtpt, jfi), "port": (ladder, tpt, fi)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    fi.clear()
    jfi.clear()
    yield
    fi.clear()
    jfi.clear()


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 8, 4096, 100003])
def test_trailer_nack_resume_bytes_equal_jax(n):
    rng = np.random.default_rng(n)
    body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for seq in (0, 7, 2 ** 32 - 1, 2 ** 32 + 5):
        assert wire.pack_trailer(body, seq) == jwire.pack_trailer(body, seq)
        assert wire.data_crc(body, seq) == jwire.data_crc(body, seq)
        framed = body + wire.pack_trailer(body, seq)
        mine = wire.split_trailer(memoryview(framed))
        theirs = jwire.split_trailer(memoryview(framed))
        assert (bytes(mine[0]),) + mine[1:] == \
            (bytes(theirs[0]),) + theirs[1:]
        assert wire.encode_nack(seq) == jwire.encode_nack(seq)
        assert wire.decode_nack(wire.encode_nack(seq)) == seq & 0xFFFFFFFF
        for rank, epoch in ((0, 0), (3, 5), (-1, 2)):
            assert wire.encode_resume(rank, seq, epoch) == \
                jwire.encode_resume(rank, seq, epoch)
    assert wire.TRAILER_BYTES == jwire.TRAILER_BYTES == 8
    assert (su.TAG_NACK, su.TAG_RESUME, su.TAG_FAILOVER) == \
        (jsu.TAG_NACK, jsu.TAG_RESUME, jsu.TAG_FAILOVER) == (11, 12, 13)


def test_wire_corruption_error_surface_equals_jax():
    mine, theirs = wire.WireCorruptionError(3, "corrupt"), \
        jwire.WireCorruptionError(3, "corrupt")
    assert isinstance(mine, ConnectionError)
    assert (mine.peer, mine.phase, mine.cause, str(mine)) == \
        (theirs.peer, theirs.phase, theirs.cause, str(theirs))
    with pytest.raises(ValueError):
        wire.split_trailer(memoryview(b"short"))


def test_knob_defaults_equal_jax(monkeypatch):
    from horovod_tpu.utils import env as jenv

    for k in ("HVD_HOP_RETRIES", "HVD_LADDER_RETAIN",
              "HVD_RECONNECT_TIMEOUT_S", "HVD_WIRE_CRC"):
        monkeypatch.delenv(k, raising=False)
    assert env_util.hop_retries() == jenv.hop_retries() == 8
    assert env_util.ladder_retain() == jenv.ladder_retain() == 32
    assert env_util.reconnect_timeout_s() == jenv.reconnect_timeout_s()
    assert env_util.wire_crc() is jenv.wire_crc() is False
    monkeypatch.setenv("HVD_LADDER_RETAIN", "0")
    assert env_util.ladder_retain() == jenv.ladder_retain() == 2


def test_knob_off_wire_bytes_are_plain_frames():
    """A plain transport's frame carries no trailer."""
    a, b = socket.socketpair()
    t = tpt.TcpTransport(a, peer=1)
    try:
        payload = b"q" * 100
        t.wait(t.send(payload), timeout=5)
        raw = su.recv_exact(b, su.HEADER.size + len(payload))
        assert raw == su.HEADER.pack(su.TAG_DATA, len(payload)) + payload
        b.setblocking(False)
        with pytest.raises(BlockingIOError):
            b.recv(1)
    finally:
        b.setblocking(True)
        t.close()
        b.close()


# ---------------------------------------------------------------------------
# link pairs
# ---------------------------------------------------------------------------


def _xfer(l0, l1, n=8, size=1 << 13, seed=0):
    """n frames each way at once, each received intact and in order."""
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                for _ in range(n)]
    errs = []

    def tx(src, who):
        try:
            tickets = [src.send(p) for p in payloads]
            for t in tickets:
                src.wait(t, timeout=30)
        except Exception as e:  # surfaced through errs
            errs.append((who, "send", repr(e)))

    def rx(link, who):
        try:
            deadline = time.monotonic() + 30
            for i, p in enumerate(payloads):
                tag, got = link.recv_frame(deadline)
                assert tag == su.TAG_DATA
                assert got == p, f"{who} frame {i} corrupted through"
        except Exception as e:  # surfaced through errs
            errs.append((who, "recv", repr(e)))

    ths = [threading.Thread(target=tx, args=(l0, "l0")),
           threading.Thread(target=tx, args=(l1, "l1")),
           threading.Thread(target=rx, args=(l0, "l0")),
           threading.Thread(target=rx, args=(l1, "l1"))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ths), "transfer hung"
    assert not errs, errs


def _close(*things):
    for t in things:
        t.close()


def _link_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith(("hvd-ladder-", "hvd-send-shm-"))}


def _threads_gone(before):
    """True once every link thread started since ``before`` has ended."""
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if not _link_threads() - before:
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("shm", [False, True], ids=["tcp", "shm"])
def test_clean_transfer(shm):
    before = _link_threads()
    l0, l1, rl = ladder.make_ladder_pair(shm=shm)
    try:
        want = "shm" if shm else "tcp"
        assert (l0.medium, l1.medium, l0.kind) == (want, want, "ladder")
        _xfer(l0, l1)
        assert (l0.medium, l1.medium) == (want, want)
    finally:
        _close(l0, l1, rl)
    assert _threads_gone(before)


def test_rung1_corruption_nack_retransmit():
    fi.configure({"faults": [
        {"site": "sock.corrupt", "kind": "corrupt", "times": 2}]})
    l0, l1, rl = ladder.make_ladder_pair()
    try:
        _xfer(l0, l1)
        assert fi._PLAN.faults[0].fired == 2
    finally:
        _close(l0, l1, rl)


def test_rung2_reset_reconnect_resume():
    fi.configure({"faults": [
        {"site": "sock.reset", "kind": "error", "times": 1}]})
    l0, l1, rl = ladder.make_ladder_pair()
    try:
        sock0 = l0._sock
        _xfer(l0, l1)
        assert fi._PLAN.faults[0].fired == 1
        assert l0._sock is not sock0 and l0._sock_gen == 1
        assert (l0.medium, l1.medium) == ("tcp", "tcp")
    finally:
        _close(l0, l1, rl)


def test_rung3_shm_fault_fails_over_to_tcp():
    before = _link_threads()
    fi.configure({"faults": [
        {"site": "shm.lost", "kind": "error", "times": 1}]})
    l0, l1, rl = ladder.make_ladder_pair(shm=True)
    try:
        _xfer(l0, l1)
        assert (l0.medium, l1.medium) == ("tcp", "tcp")
    finally:
        _close(l0, l1, rl)
    assert _threads_gone(before)


@pytest.mark.parametrize("shm", [False, True], ids=["tcp", "shm"])
def test_rung4_exhaustion_raises_typed_corruption(monkeypatch, shm):
    """TCP: no NACK budget and every frame corrupted.  Shm: the ring
    faults and the FAILOVER cannot be sent (the receiver's mesh socket is
    shut for writing), so the demotion cannot happen."""
    monkeypatch.setenv(env_util.HOP_RETRIES, "0")
    monkeypatch.setenv(env_util.RECONNECT_TIMEOUT_S, "0.5")
    before = _link_threads()
    l0, l1, rl = ladder.make_ladder_pair(shm=shm)
    try:
        if shm:
            fi.configure({"faults": [{"site": "shm.lost", "kind": "error",
                                      "match": "read"}]})
            l1._sock.shutdown(socket.SHUT_WR)
            cause = "failover"
        else:
            fi.configure({"faults": [
                {"site": "sock.corrupt", "kind": "corrupt"}]})
            l0.wait(l0.send(b"z" * 256), timeout=10)
            cause = "corrupt"
        with pytest.raises(wire.WireCorruptionError) as ei:
            l1.recv_frame(time.monotonic() + 20)
        assert (ei.value.peer, ei.value.cause) == (0, cause)
        with pytest.raises(ConnectionError):
            l1.send(b"after")
    finally:
        fi.clear()
        _close(l0, l1, rl)
    assert _threads_gone(before)


@pytest.mark.parametrize("shm", [False, True], ids=["tcp", "shm"])
def test_payloads_larger_than_retention_window(shm):
    l0, l1, rl = ladder.make_ladder_pair(shm=shm)
    try:
        _xfer(l0, l1, n=env_util.ladder_retain() + 8, size=512)
    finally:
        _close(l0, l1, rl)


def test_retention_window_exceeded_by_a_replay_poisons():
    """A NACK for a frame already out of the retention window cannot be
    healed: the sender poisons with the cause."""
    l0, l1, rl = ladder.make_ladder_pair()
    try:
        for _ in range(env_util.ladder_retain() + 4):
            l0.wait(l0.send(b"x" * 64), timeout=10)
        for _ in range(env_util.ladder_retain() + 4):
            l1.recv_frame(time.monotonic() + 10)
        l0._push_replay(0, "corrupt")
        deadline = time.monotonic() + 10
        while l0._poison is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(l0._poison, wire.WireCorruptionError)
        assert (l0._poison.peer, l0._poison.cause) == (1, "corrupt")
    finally:
        _close(l0, l1, rl)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _cross_pair(lower, higher, shm):
    """Rank 0's link from package ``lower``, rank 1's from ``higher``, over
    loopback TCP (and, with ``shm``, one segment ``lower`` creates and
    ``higher`` attaches); rank 1's package keeps the reconnect listener."""
    (llad, ltpt, _), (hlad, htpt, _) = PKGS[lower], PKGS[higher]
    lst = su.listen_on("127.0.0.1")
    host, port = lst.getsockname()
    a = socket.create_connection((host, port))
    su.configure_data_socket(a)
    b, _ = lst.accept()
    su.configure_data_socket(b)
    seg_a = seg_b = None
    if shm:
        seg_a = ltpt.ShmSegment.create(slot_bytes=4096, nslots=4)
        seg_b = htpt.ShmSegment.attach(seg_a.name)
        seg_a.unlink()
    link0 = llad.LadderLink(0, 1, a, seg=seg_a, lower=True,
                            peer_addr=(host, port))
    link1 = hlad.LadderLink(1, 0, b, seg=seg_b, lower=False)
    rl = hlad.ReconnectListener(lst)
    rl.register(0, link1)
    rl.start()
    return link0, link1, rl


RUNGS = {
    "rung1": (False, {"site": "sock.corrupt", "kind": "corrupt",
                      "times": 2}),
    "rung2": (False, {"site": "sock.reset", "kind": "error", "times": 1}),
    "rung3": (True, {"site": "shm.lost", "kind": "error", "times": 1}),
}


@pytest.mark.parametrize("faulted", ["lower", "higher"])
@pytest.mark.parametrize("lower,higher", [("jax", "port"), ("port", "jax")],
                         ids=["jax_lower", "port_lower"])
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_cross_package_link_heals(rung, lower, higher, faulted):
    shm, fault = RUNGS[rung]
    side = lower if faulted == "lower" else higher
    plan_fi = PKGS[side][2]
    l0, l1, rl = _cross_pair(lower, higher, shm)
    try:
        _xfer(l0, l1, n=4, seed=1)  # clean first
        plan_fi.configure({"faults": [dict(fault)]})
        _xfer(l0, l1, n=8, seed=2)
        assert plan_fi._PLAN.faults[0].fired >= 1
        plan_fi.clear()
        _xfer(l0, l1, n=4, seed=3)  # and clean after
        if shm:
            assert (l0._mode, l1._mode) == ("tcp", "tcp")
    finally:
        fi.clear()
        jfi.clear()
        _close(l0, l1, rl)


@pytest.mark.parametrize("receiver", ["port", "jax"])
def test_cross_package_exhaustion_carries_peer_and_cause(monkeypatch,
                                                         receiver):
    monkeypatch.setenv("HVD_HOP_RETRIES", "0")
    sender = "jax" if receiver == "port" else "port"
    l0, l1, rl = _cross_pair(sender, receiver, False)
    try:
        PKGS[sender][2].configure({"faults": [
            {"site": "sock.corrupt", "kind": "corrupt"}]})
        l0.wait(l0.send(b"z" * 256), timeout=10)
        with pytest.raises(ConnectionError) as ei:
            l1.recv_frame(time.monotonic() + 10)
        err = ei.value
        assert type(err).__name__ == "WireCorruptionError"
        assert (err.peer, err.phase, err.cause) == (0, "recv", "corrupt")
        assert str(err) == str(jwire.WireCorruptionError(0, "corrupt"))
    finally:
        fi.clear()
        jfi.clear()
        _close(l0, l1, rl)
