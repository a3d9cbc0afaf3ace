"""The port's same-host shm transport (``horovod_tpu_torch/utils/
transport.py``), in process, against the JAX package's.

* The segment layout both ways: a segment one package creates, the other
  attaches; frames one package's ring writes, the other's reads, with the
  same bytes and tags; the same frames written by both packages' writers
  leave the same segment bytes.
* The port's own pairs: the ring allreduce and the hierarchical allreduce
  over shm pairs give the TCP pairs' bits.
* No ``hvd-shm-*`` name of this process is left after pairing, after a
  close, or after a failed attach.
* Pairing over a live KV: ``build_transports`` against the port's
  ``RendezvousServer``, three ranks on threads, rank 2 under
  ``HVD_SHM_DISABLE``.
"""

import contextlib
import glob
import os
import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from horovod_tpu.utils import transport as jtpt
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.common.types import DataType, ReduceOp
from horovod_tpu_torch.ops import cpu_backend as cb
from horovod_tpu_torch.ops.fusion_buffer import FusionBuffer
from horovod_tpu_torch.runner.http_client import KVClient
from horovod_tpu_torch.runner.http_server import RendezvousServer
from horovod_tpu_torch.utils import socketutil as su
from horovod_tpu_torch.utils import transport as tpt

SLOT = 4096
# Smaller than a slot, exactly the first slot (with the 5-byte header),
# exactly one slot, many slots (ragged), empty.
SIZES = (100, SLOT - su.HEADER.size, SLOT, 5 * SLOT + 37, 0)


def _own_names():
    """This process's live shm names (both packages name a segment
    ``hvd-shm-<creator pid>-...``)."""
    return glob.glob(f"/dev/shm/{tpt._SHM_PREFIX}{os.getpid()}-*")


@pytest.fixture(autouse=True)
def _no_plan_and_no_leak():
    fi.clear()
    yield
    fi.clear()
    assert not _own_names()


def _frames(seed):
    rng = np.random.default_rng(seed)
    return [(su.TAG_DATA if i % 2 == 0 else su.TAG_NACK,
             rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            for i, n in enumerate(SIZES)]


def _pair(creator, attacher, nslots=4):
    """(created, attached) segments across the two packages' classes;
    the name is unlinked at once, as the pairing does."""
    a = creator.ShmSegment.create(slot_bytes=SLOT, nslots=nslots)
    b = attacher.ShmSegment.attach(a.name)
    a.unlink()
    return a, b


@pytest.mark.parametrize("writer_pkg,reader_pkg",
                         [(jtpt, tpt), (tpt, jtpt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_frames_cross_packages(writer_pkg, reader_pkg):
    seg_w, seg_r = _pair(writer_pkg, reader_pkg)
    assert (seg_r.nslots, seg_r.slot_bytes) == (4, SLOT)
    w = writer_pkg.ShmRingTransport(seg_w, lower=True, peer=1)
    r = reader_pkg.ShmRingTransport(seg_r, lower=False, peer=0)
    try:
        frames = _frames(1)
        tickets = [w.send(p, tag) for tag, p in frames]
        got = [r.recv_frame() for _ in frames]
        for t in tickets:
            w.wait(t, timeout=10)
        assert got == frames
        # And back on the other ring.
        back = [r.send(p, tag) for tag, p in frames]
        assert [w.recv_frame() for _ in frames] == frames
        for t in back:
            r.wait(t, timeout=10)
    finally:
        w.close(timeout=2.0)
        r.close(timeout=2.0)


def test_writers_leave_the_same_segment_bytes():
    """The same frames through the JAX writer and the port's writer, into
    segments with room for all of them, give the same bytes at every
    offset: header, control words, slot headers, payloads."""
    frames = _frames(2)
    nslots = 16
    segs = []
    for pkg in (jtpt, tpt):
        seg = pkg.ShmSegment.create(slot_bytes=SLOT, nslots=nslots)
        seg.unlink()
        writer = pkg._RingWriter(seg, 1)
        for tag, p in frames:
            writer.write_frame(tag, p, lambda: False)
        segs.append(seg)
    try:
        assert len(segs[0].buf) == len(segs[1].buf)
        assert bytes(segs[0].buf) == bytes(segs[1].buf)
        w_off, r_off, slot0 = segs[1].ring_offsets(1)
        assert (w_off, r_off) == (192, 256)
        assert slot0 == 320 + nslots * ((16 + SLOT + 63) & ~63)
    finally:
        for s in segs:
            s.close()


def test_header_is_checked_on_attach():
    seg = tpt.ShmSegment.create(slot_bytes=SLOT, nslots=2)
    try:
        seg.buf[0:4] = b"\0\0\0\0"
        with pytest.raises(ValueError, match="incompatible header"):
            jtpt.ShmSegment.attach(seg.name)
        with pytest.raises(ValueError, match="incompatible header"):
            tpt.ShmSegment.attach(seg.name)
    finally:
        seg.unlink()
        seg.close()


def test_failed_attach_leaves_no_name():
    with pytest.raises(FileNotFoundError):
        tpt.ShmSegment.attach(f"{tpt._SHM_PREFIX}{os.getpid()}-missing")
    assert not _own_names()


def test_shm_transport_pair_streams_and_unlinks():
    a, b = tpt.make_transport_pair()
    try:
        assert not _own_names()
        assert (a.medium, b.medium) == ("shm", "shm")
        payload = np.arange(5000, dtype=np.float32)
        t = a.send(payload)
        tag, got = b.recv_frame()
        a.wait(t, timeout=5)
        assert tag == su.TAG_DATA
        np.testing.assert_array_equal(np.frombuffer(got, np.float32),
                                      payload)
    finally:
        a.close(timeout=2.0)
        b.close(timeout=2.0)
    assert not [th for th in threading.enumerate()
                if th.name.startswith("hvd-send-shm-")]


# ---------------------------------------------------------------------------
# the port's collectives over shm pairs against TCP pairs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _mesh(n, local_size, shm_pairs):
    """``n`` fake engines (the attributes ``cpu_backend`` reads) on a full
    mesh: shm transports for ``shm_pairs``, TCP socketpairs for the rest."""
    engines = [SimpleNamespace(
        rank=r, size=n, local_rank=r % local_size, local_size=local_size,
        cross_rank=r // local_size, cross_size=n // local_size,
        ring_segment_bytes=0, _fusion_buf=FusionBuffer(), _transports={})
        for r in range(n)]
    socks = []
    for a in range(n):
        for b in range(a + 1, n):
            if (a, b) in shm_pairs:
                ta, tb = tpt.make_transport_pair()
            else:
                sa, sb = socket.socketpair()
                socks += [sa, sb]
                ta, tb = tpt.TcpTransport(sa, b), tpt.TcpTransport(sb, a)
            engines[a]._transports[b] = ta
            engines[b]._transports[a] = tb
    try:
        yield engines
    finally:
        for e in engines:
            for t in e._transports.values():
                t.close(timeout=2.0)
        for s in socks:
            s.close()


def _run(engines, fn):
    out, errs = {}, []

    def go(e):
        try:
            out[e.rank] = fn(e)
        except BaseException as exc:  # surfaced below
            errs.append(exc)

    ths = [threading.Thread(target=go, args=(e,)) for e in engines]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert not any(t.is_alive() for t in ths), "collective hung"
    assert not errs, errs
    return out


@pytest.mark.parametrize("hier", [False, True], ids=["ring", "hierarchical"])
def test_allreduce_over_shm_equals_tcp(hier):
    n, local = 4, 2
    rng = np.random.default_rng(5)
    inputs = {
        (dt, r): (rng.standard_normal(5000) * 3).astype(np.float32)
        for dt in ("f32", "bf16") for r in range(n)}

    def reduce_all(e):
        res = {}
        for dt, dtype in (("f32", DataType.FLOAT32),
                          ("bf16", DataType.BFLOAT16)):
            x = inputs[(dt, e.rank)]
            if dtype == DataType.BFLOAT16:
                x = (x.view(np.uint32) >> 16).astype(np.uint16)
            flat = x.copy()
            if hier:
                out = cb.hierarchical_allreduce_flat(e, flat, ReduceOp.SUM,
                                                     dtype)
            else:
                out = cb._ring_allreduce_group(e, flat, ReduceOp.SUM, dtype,
                                               list(range(n)), e.rank)
            res[dt] = out.tobytes()
        return res

    runs = {}
    for medium, pairs in (("tcp", ()), ("mixed", {(0, 1), (2, 3)}),
                          ("shm", {(a, b) for a in range(n)
                                   for b in range(a + 1, n)})):
        with _mesh(n, local, pairs) as engines:
            runs[medium] = _run(engines, reduce_all)
    for r in range(n):
        assert runs["tcp"][r] == runs["tcp"][0]
        assert runs["shm"][r] == runs["tcp"][r]
        assert runs["mixed"][r] == runs["tcp"][r]


# ---------------------------------------------------------------------------
# pairing over a live KV
# ---------------------------------------------------------------------------


def test_build_transports_over_live_kv(monkeypatch):
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    prefix = "hvd/shmtest/"
    kv = KVClient("127.0.0.1", port)
    n = 3
    socks = {r: {} for r in range(n)}
    for a in range(n):
        for b in range(a + 1, n):
            socks[a][b], socks[b][a] = socket.socketpair()
    built = {}
    try:
        # Rank 2 runs with HVD_SHM_DISABLE: it publishes its TCP-only token
        # and pairs every peer over TCP with no KV round.
        monkeypatch.setenv("HVD_SHM_DISABLE", "1")
        kv.put(f"{prefix}hostid/2", tpt.host_record_value(2))
        built[2] = tpt.build_transports(2, n, socks[2], kv, prefix,
                                        timeout=30)
        monkeypatch.delenv("HVD_SHM_DISABLE")
        for r in (0, 1):
            kv.put(f"{prefix}hostid/{r}", tpt.host_record_value(r))
        assert kv.get(f"{prefix}hostid/2") == "tcp-only-2"
        assert "|" in kv.get(f"{prefix}hostid/0")

        def pair(r):
            built[r] = tpt.build_transports(
                r, n, socks[r], KVClient("127.0.0.1", port), prefix,
                timeout=30)

        ths = [threading.Thread(target=pair, args=(r,)) for r in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        media = {r: {p: t.medium for p, t in built[r].items()}
                 for r in range(n)}
        assert media == {0: {1: "shm", 2: "tcp"}, 1: {0: "shm", 2: "tcp"},
                         2: {0: "tcp", 1: "tcp"}}
        assert kv.get(f"{prefix}shmack/0_1") == "ok"
        assert not _own_names()
        # A frame each way on every link.
        for a in range(n):
            for b in range(n):
                if a != b:
                    msg = f"{a}->{b}".encode()
                    t = built[a][b].send(msg)
                    assert built[b][a].recv_frame() == (su.TAG_DATA, msg)
                    built[a][b].wait(t, timeout=5)
    finally:
        for trs in built.values():
            for t in trs.values():
                t.close(timeout=2.0)
        for d in socks.values():
            for s in d.values():
                s.close()
        server.stop()


def test_failed_attach_pairs_over_tcp():
    """An injected ``shm.attach`` fault: the attacher acks "fail", the
    creator unlinks and closes its segment, and both sides use TCP."""
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    prefix = "hvd/shmfail/"
    sa, sb = socket.socketpair()
    built = {}
    try:
        fi.configure({"faults": [{"site": "shm.attach", "kind": "error"}]})
        for r in (0, 1):
            KVClient("127.0.0.1", port).put(f"{prefix}hostid/{r}",
                                            tpt.host_record_value(r))

        def pair(r, sock):
            built[r] = tpt.build_transports(
                r, 2, {1 - r: sock}, KVClient("127.0.0.1", port), prefix,
                timeout=30)

        ths = [threading.Thread(target=pair, args=(0, sa)),
               threading.Thread(target=pair, args=(1, sb))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        assert built[0][1].medium == "tcp" and built[1][0].medium == "tcp"
        assert not _own_names()
    finally:
        fi.clear()
        for trs in built.values():
            for t in trs.values():
                t.close(timeout=2.0)
        sa.close()
        sb.close()
        server.stop()
