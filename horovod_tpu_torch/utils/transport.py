"""Data-plane transports: the port of ``horovod_tpu/utils/transport.py``,
TCP sockets and same-host shared-memory rings.

:class:`Transport` is the contract the collectives use (a ticketed async
send, a frame receive, a segmented ``recv_exact_into``, teardown), with
two implementations:

* :class:`TcpTransport`: one mesh socket and its persistent
  :class:`~horovod_tpu_torch.utils.socketutil.PeerSender`; the
  ``sock.stall`` fault site fires once per received frame.
* :class:`ShmRingTransport`: a per-pair ``multiprocessing.shared_memory``
  segment holding two directed rings of seqlocked slots, one per
  direction.  A sender thread copies frame bytes into the mapped slots and
  the reader copies them out.  A slot's payload and length are stored
  first and its sequence word last, so that a reader that sees
  ``seq == expected`` sees a whole slot (one writer and one reader per
  ring).  Waits spin (``HVD_SHM_SPIN``), then yield, then sleep up to
  ``HVD_SHM_SLEEP_US``.

Over shm a frame is the same byte stream as on the wire (the 5-byte
``socketutil.HEADER``, then the payload, across slots), so receiver-local
segmentation and the reduction order are the same on both, and so are the
bits.

The segment's layout is the JAX package's, byte for byte, so that a port
rank and a JAX ``PyEngine`` rank on one host pair over one segment
(little-endian)::

    0    u32 magic "HSMR", u32 version 1, u32 nslots, u32 slot_bytes
    64   ring 0 write_seq (u64)   -- lower rank -> higher rank
    128  ring 0 read_seq  (u64)
    192  ring 1 write_seq (u64)   -- higher rank -> lower rank
    256  ring 1 read_seq  (u64)
    320  ring 0's slots, then ring 1's
    slot: u64 seq, u32 nbytes, 4 pad bytes, payload; stride 64-aligned

Pairing (:func:`build_transports`), leak-proof by construction:

1. every rank publishes a host record (hostname and boot id) to the KV
   rendezvous; a rank that cannot attach shm (``HVD_SHM_DISABLE``)
   publishes the rank-unique ``tcp-only-<rank>``, so no peer selects shm
   against it;
2. for each same-host pair, the lower rank creates the segment and
   publishes its name; the higher rank attaches (the ``shm.attach`` fault
   site) and acks;
3. on the ack the creator unlinks the ``/dev/shm`` name at once: both
   mappings persist, and no death of either peer can leak it;
4. a failed create or attach is acked as such, and both sides use TCP over
   the mesh socket they already hold.

Left out until telemetry and the trace are ported (ROADMAP Queue 1, item
5.5): the ``hvd_transport_bytes_total`` counter and the trace's
``transport.map`` instants.
"""

from __future__ import annotations

import collections
import os
import socket
import struct
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import socketutil as su


class Transport:
    """What a data-plane peer link must provide.

    ``send`` returns a ticket; ``wait(ticket)`` fences it (raising
    ``TimeoutError`` / ``ConnectionError`` as ``PeerSender.wait`` does).
    ``deadline`` arguments are absolute ``time.monotonic()`` timestamps or
    ``None`` for block-forever."""

    kind = "none"
    peer = -1

    @property
    def medium(self) -> str:
        """What carries the bytes now: ``"tcp"`` or ``"shm"``."""
        return self.kind

    def send(self, payload, tag: int = su.TAG_DATA) -> int:
        raise NotImplementedError

    def wait(self, seq: int, timeout: Optional[float] = None) -> None:
        raise NotImplementedError

    def recv_frame(self,
                   deadline: Optional[float] = None) -> Tuple[int, bytes]:
        raise NotImplementedError

    def recv_frame_header(self,
                          deadline: Optional[float] = None
                          ) -> Tuple[int, int]:
        raise NotImplementedError

    def recv_exact_into(self, view: memoryview,
                        deadline: Optional[float] = None) -> None:
        raise NotImplementedError

    def close(self, timeout: float = 5.0) -> None:
        raise NotImplementedError

    def join(self, timeout: float = 2.0) -> None:
        """Join the sender thread after the sockets and segments are torn
        down."""
        raise NotImplementedError


class TcpTransport(Transport):
    """The socket path behind :class:`Transport`.  The socket stays owned
    by the engine (closed in its shutdown, which also unblocks a sender
    thread wedged in the kernel)."""

    kind = "tcp"

    def __init__(self, sock: socket.socket, peer: int = -1,
                 sender: Optional[su.PeerSender] = None):
        self.sock = sock
        self.peer = peer
        self.sender = sender if sender is not None else su.PeerSender(
            sock, name=f"hvd-send-{peer}")

    def send(self, payload, tag: int = su.TAG_DATA) -> int:
        return self.sender.send(payload, tag)

    def wait(self, seq: int, timeout: Optional[float] = None) -> None:
        self.sender.wait(seq, timeout)

    def recv_frame(self,
                   deadline: Optional[float] = None) -> Tuple[int, bytes]:
        _fi.fire("sock.stall")
        return su.recv_frame(self.sock, deadline)

    def recv_frame_header(self,
                          deadline: Optional[float] = None
                          ) -> Tuple[int, int]:
        _fi.fire("sock.stall")
        return su.recv_frame_header(self.sock, deadline)

    def recv_exact_into(self, view: memoryview,
                        deadline: Optional[float] = None) -> None:
        su.recv_exact_into(self.sock, view, deadline)

    def close(self, timeout: float = 5.0) -> None:
        self.sender.close(timeout)

    def join(self, timeout: float = 2.0) -> None:
        self.sender.thread.join(timeout)


# ---------------------------------------------------------------------------
# the shared-memory segment
# ---------------------------------------------------------------------------

# The read_seq word is the writer's backpressure; the write_seq word is
# informational.  Readers follow each slot's own seq: that is the seqlock.
_MAGIC = 0x524D5348  # "HSMR"
_VERSION = 1
_HDR = struct.Struct("<IIII")
_CTRL = 64
_SLOTS_OFF = 320
_SLOT_HDR = 16

_SHM_PREFIX = "hvd-shm-"

# The waits' shape: spinning pays only where a spare core can run the peer
# meanwhile; on one core the yields hand the quantum to the producer.
_CPUS = os.cpu_count() or 1
_SPIN_HOT = env_util.shm_spin()
_SPIN_YIELD = _SPIN_HOT + (512 if _CPUS > 1 else 256)
_READ_SLEEP_CAP = env_util.shm_sleep_us() * 1e-6


def _slot_stride(slot_bytes: int) -> int:
    return (_SLOT_HDR + slot_bytes + 63) & ~63


_untracked: set = set()


def _untrack(shm) -> None:
    """Take a segment out of the resource tracker.  Python 3.12's
    ``SharedMemory`` has no ``track=``: every create and attach registers
    the name, and the tracker unlinks it when any registered process exits
    (and warns of a "leaked shared_memory").  Ownership here is explicit
    (create, attach, ack, unlink), so opt out, at most once a name: the
    tracker's cache is per process, and an in-process create and attach
    registers once."""
    if shm._name in _untracked:
        return
    _untracked.add(shm._name)
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


class ShmSegment:
    """One mapped peer-pair segment: two directed seqlocked rings."""

    def __init__(self, shm, nslots: int, slot_bytes: int, created: bool):
        self._shm = shm
        self.name = shm.name
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.created = created
        self._unlinked = False

    @classmethod
    def create(cls, slot_bytes: Optional[int] = None,
               nslots: Optional[int] = None,
               name: Optional[str] = None) -> "ShmSegment":
        from multiprocessing import shared_memory

        slot_bytes = slot_bytes if slot_bytes is not None \
            else env_util.shm_slot_bytes()
        nslots = nslots if nslots is not None else env_util.shm_slots()
        stride = _slot_stride(slot_bytes)
        total = _SLOTS_OFF + 2 * nslots * stride
        name = name or f"{_SHM_PREFIX}{os.getpid()}-{uuid.uuid4().hex[:12]}"
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=total)
        _untrack(shm)
        # Fresh tmpfs pages read zero, so every seq word is 0 already;
        # only the header needs writing.
        _HDR.pack_into(shm.buf, 0, _MAGIC, _VERSION, nslots, slot_bytes)
        return cls(shm, nslots, slot_bytes, created=True)

    @classmethod
    def attach(cls, name: str) -> "ShmSegment":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        _untrack(shm)
        magic, version, nslots, slot_bytes = _HDR.unpack_from(shm.buf, 0)
        if magic != _MAGIC or version != _VERSION or nslots < 1 \
                or slot_bytes < 1:
            shm.close()
            raise ValueError(
                f"shm segment {name!r} has an incompatible header "
                f"(magic={magic:#x} version={version})")
        return cls(shm, nslots, slot_bytes, created=False)

    @property
    def buf(self):
        return self._shm.buf

    def ring_offsets(self, ring: int) -> Tuple[int, int, int]:
        """(write_seq offset, read_seq offset, first slot offset)."""
        stride = _slot_stride(self.slot_bytes)
        return (_CTRL + ring * 128, _CTRL + ring * 128 + 64,
                _SLOTS_OFF + ring * self.nslots * stride)

    def unlink(self) -> None:
        """Remove the /dev/shm name; the mappings stay valid.  The raw
        ``shm_unlink``: ``SharedMemory.unlink`` would unregister from the
        tracker a second time, which makes it print a KeyError at exit."""
        if self._unlinked:
            return
        self._unlinked = True
        try:
            import _posixshmem

            _posixshmem.shm_unlink(self._shm._name)
        except (ImportError, FileNotFoundError, OSError):
            pass

    def close(self) -> None:
        try:
            self._shm.close()
        except (BufferError, OSError):
            pass


class _RingWriter:
    """The frame writer of one directed ring (one thread)."""

    def __init__(self, seg: ShmSegment, ring: int):
        self._buf = seg.buf
        self._nslots = seg.nslots
        self._slot_bytes = seg.slot_bytes
        self._stride = _slot_stride(seg.slot_bytes)
        self._w_off, self._r_off, self._slot0 = seg.ring_offsets(ring)
        self._wseq = struct.unpack_from("<Q", self._buf, self._w_off)[0]

    def _slot_base(self, seq: int) -> int:
        return self._slot0 + (seq % self._nslots) * self._stride

    def _acquire(self, stopped) -> int:
        """The next writable slot's seq; waits while the ring is full.
        ``stopped()`` breaks the wait, so that close() never hangs on a
        dead peer."""
        w = self._wseq
        n = 0
        while True:
            r = struct.unpack_from("<Q", self._buf, self._r_off)[0]
            if w - r < self._nslots:
                return w
            n += 1
            if n < _SPIN_HOT:
                continue
            if stopped():
                raise ConnectionError("shm transport closed")
            time.sleep(0 if n < _SPIN_YIELD else
                       min(_READ_SLEEP_CAP, 1e-6 * n))

    def _publish(self, w: int, nbytes: int) -> None:
        base = self._slot_base(w)
        struct.pack_into("<I", self._buf, base + 8, nbytes)
        # The seq store publishes: everything above is in the slot before
        # the reader can see seq == w + 1.
        struct.pack_into("<Q", self._buf, base, w + 1)
        self._wseq = w + 1
        struct.pack_into("<Q", self._buf, self._w_off, self._wseq)

    def write_frame(self, tag: int, payload, stopped) -> None:
        view = su._as_byte_view(payload)
        total = len(view)
        header = su.HEADER.pack(tag, total)
        hb = len(header)
        w = self._acquire(stopped)
        base = self._slot_base(w)
        k = min(self._slot_bytes - hb, total)
        self._buf[base + _SLOT_HDR:base + _SLOT_HDR + hb] = header
        if k:
            self._buf[base + _SLOT_HDR + hb:
                      base + _SLOT_HDR + hb + k] = view[:k]
        self._publish(w, hb + k)
        off = k
        while off < total:
            w = self._acquire(stopped)
            base = self._slot_base(w)
            k = min(self._slot_bytes, total - off)
            self._buf[base + _SLOT_HDR:
                      base + _SLOT_HDR + k] = view[off:off + k]
            self._publish(w, k)
            off += k


class _RingReader:
    """The byte-stream reader of one directed ring (one thread)."""

    def __init__(self, seg: ShmSegment, ring: int):
        self._buf = seg.buf
        self._nslots = seg.nslots
        self._stride = _slot_stride(seg.slot_bytes)
        self._w_off, self._r_off, self._slot0 = seg.ring_offsets(ring)
        self._rseq = struct.unpack_from("<Q", self._buf, self._r_off)[0]
        self._avail = 0  # unread payload bytes left in the current slot
        self._pos = 0    # the read cursor within the current slot

    def _slot_base(self, seq: int) -> int:
        return self._slot0 + (seq % self._nslots) * self._stride

    def _wait_slot(self, deadline: Optional[float], stopped) -> int:
        """Spin, then sleep, until slot ``_rseq`` is published; returns its
        offset.  Past ``deadline`` it raises the socket path's
        ``TimeoutError("receive deadline exceeded")``."""
        base = self._slot_base(self._rseq)
        want = self._rseq + 1
        n = 0
        while True:
            if struct.unpack_from("<Q", self._buf, base)[0] == want:
                return base
            n += 1
            if n < _SPIN_HOT:
                continue
            if stopped():
                raise ConnectionError("shm transport closed")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("receive deadline exceeded")
            time.sleep(0 if n < _SPIN_YIELD else
                       min(_READ_SLEEP_CAP, 1e-6 * n))

    def recv_into(self, view: memoryview, deadline: Optional[float],
                  stopped) -> None:
        if view.format != "B":
            view = view.cast("B")
        need = len(view)
        got = 0
        while got < need:
            if self._avail == 0:
                base = self._wait_slot(deadline, stopped)
                self._avail = struct.unpack_from(
                    "<I", self._buf, base + 8)[0]
                self._pos = 0
            base = self._slot_base(self._rseq)
            k = min(self._avail, need - got)
            src = base + _SLOT_HDR + self._pos
            view[got:got + k] = self._buf[src:src + k]
            got += k
            self._pos += k
            self._avail -= k
            if self._avail == 0:
                # The slot is drained: hand it back to the writer.
                self._rseq += 1
                struct.pack_into("<Q", self._buf, self._r_off,
                                 self._rseq)


class ShmRingTransport(Transport):
    """A same-host peer link over one mapped :class:`ShmSegment`.

    The send side is ``PeerSender``'s: a named daemon thread
    (``hvd-send-shm-<peer>``) fed through a deque, tickets that ``wait``
    fences, failures surfaced at ``wait``.  ``lower`` picks the ring this
    side writes (ring 0 belongs to the pair's lower rank)."""

    kind = "shm"

    def __init__(self, segment: ShmSegment, lower: bool, peer: int = -1,
                 name: Optional[str] = None):
        self._seg = segment
        self.peer = peer
        self._writer = _RingWriter(segment, 0 if lower else 1)
        self._reader = _RingReader(segment, 1 if lower else 0)
        self._hdr_buf = bytearray(su.HEADER.size)
        self._deque: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._enq_seq = 0
        self._done_seq = 0
        self._fail_seq: Optional[int] = None
        self._exc: Optional[BaseException] = None
        self._closing = False
        self._stop = False
        self.thread = threading.Thread(
            target=self._loop, name=name or f"hvd-send-shm-{peer}",
            daemon=True)
        self.thread.start()

    def _stopped(self) -> bool:
        return self._stop

    # -- send side ------------------------------------------------------

    def send(self, payload, tag: int = su.TAG_DATA) -> int:
        with self._cv:
            if self._closing:
                raise ConnectionError("sender is closed")
            if self._exc is not None:
                raise ConnectionError(
                    f"peer send failed: {self._exc!r}") from self._exc
            self._enq_seq += 1
            seq = self._enq_seq
            self._deque.append((seq, tag, payload))
            self._cv.notify_all()
        return seq

    def wait(self, seq: int, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._done_seq < seq and self._exc is None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "send did not complete in time")
                if not self._cv.wait(remaining):
                    raise TimeoutError("send did not complete in time")
            if self._exc is not None and self._fail_seq is not None \
                    and seq >= self._fail_seq:
                raise ConnectionError(
                    f"peer send failed: {self._exc!r}") from self._exc

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._deque and not self._closing:
                    self._cv.wait()
                if not self._deque and self._closing:
                    return
                seq, tag, payload = self._deque.popleft()
            try:
                if self._exc is None:
                    self._writer.write_frame(tag, payload, self._stopped)
            except BaseException as e:  # surfaced at wait()
                with self._cv:
                    self._exc = e
                    if self._fail_seq is None:
                        self._fail_seq = seq
                    self._cv.notify_all()
            with self._cv:
                self._done_seq = seq
                self._cv.notify_all()

    # -- receive side ---------------------------------------------------

    def recv_frame(self,
                   deadline: Optional[float] = None) -> Tuple[int, bytes]:
        tag, n = self.recv_frame_header(deadline)
        payload = bytearray(n)
        if n:
            self._reader.recv_into(memoryview(payload), deadline,
                                   self._stopped)
        return tag, bytes(payload)

    def recv_frame_header(self,
                          deadline: Optional[float] = None
                          ) -> Tuple[int, int]:
        # The TCP path's sock.stall, on shm: wedge this rank's next
        # data-plane receive while the process stays alive.
        _fi.fire("shm.stall")
        self._reader.recv_into(memoryview(self._hdr_buf), deadline,
                               self._stopped)
        return su.HEADER.unpack(bytes(self._hdr_buf))

    def recv_exact_into(self, view: memoryview,
                        deadline: Optional[float] = None) -> None:
        self._reader.recv_into(view, deadline, self._stopped)

    # -- teardown -------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Drain, then force: let the enqueued frames finish, break a
        writer blocked on a full ring (a dead peer) with the stop flag,
        join the thread, and unmap the segment."""
        with self._cv:
            closing = self._closing
            self._closing = True
            self._cv.notify_all()
        if not closing:
            self.thread.join(timeout)
            if self.thread.is_alive():
                self._stop = True
                self.thread.join(timeout)
            self._stop = True  # unblock a reader still spinning
            self._seg.close()
        else:
            self.thread.join(timeout)

    def join(self, timeout: float = 2.0) -> None:
        self._stop = True
        self.thread.join(timeout)


# ---------------------------------------------------------------------------
# transport selection: KV host records and per-pair create/attach/ack
# ---------------------------------------------------------------------------


def shm_enabled() -> bool:
    return not env_util.shm_disabled()


def host_fingerprint() -> str:
    """The same-host token: hostname and kernel boot id.  The pairing is
    the functional check: a failed attach falls back to TCP."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}|{boot}"


def host_record_value(rank: int) -> str:
    """What a rank publishes under ``{prefix}hostid/{rank}``: the host's
    fingerprint, or under ``HVD_SHM_DISABLE`` a rank-unique token, so that
    both sides of every pair with it agree on TCP with no negotiation."""
    if shm_enabled():
        return host_fingerprint()
    return f"tcp-only-{rank}"


# The KV value of a failed create (wait_get cannot tell an empty value
# from an absent key).
_CREATE_FAILED = "none"


def build_transports(rank: int, size: int, data: Dict[int, socket.socket],
                     kv, prefix: str,
                     timeout: Optional[float] = None,
                     tcp_factory=None, shm_factory=None
                     ) -> Dict[int, Transport]:
    """One :class:`Transport` per mesh peer (``data``: peer rank ->
    socket).

    Same-host peers (equal KV host records) pair a shm segment by
    create/attach/ack, the lower rank creating; the name is unlinked as
    the ack lands.  Other peers, and a pair whose shm pairing fails, get a
    :class:`TcpTransport` over the mesh socket.  Peers are paired in
    ascending rank order on every rank: the globally smallest unfinished
    pair can always complete, so the ack waits cannot deadlock.

    ``tcp_factory(sock, peer)`` and ``shm_factory(sock, seg, lower,
    peer)`` change what is built on the chosen medium (``utils/ladder.py``
    wraps every pair in a :class:`LadderLink`)."""
    if timeout is None:
        timeout = env_util.get_float(env_util.START_TIMEOUT, 120.0)
    if tcp_factory is None:
        def tcp_factory(sock, peer):
            return TcpTransport(sock, peer=peer)
    if shm_factory is None:
        def shm_factory(sock, seg, lower, peer):
            return ShmRingTransport(seg, lower=lower, peer=peer)
    transports: Dict[int, Transport] = {}
    mine = host_record_value(rank)
    want_shm = shm_enabled() and "|" in mine
    for r in sorted(data):
        sock = data[r]
        peer_fp = kv.wait_get(f"{prefix}hostid/{r}",
                              timeout=timeout) if want_shm else None
        if isinstance(peer_fp, bytes):
            peer_fp = peer_fp.decode()
        if not want_shm or peer_fp != mine:
            transports[r] = tcp_factory(sock, r)
            continue
        a, b = (rank, r) if rank < r else (r, rank)
        name_key = f"{prefix}shm/{a}_{b}"
        ack_key = f"{prefix}shmack/{a}_{b}"
        if rank == a:
            seg = None
            try:
                seg = ShmSegment.create()
                kv.put(name_key, seg.name)
            except Exception:
                kv.put(name_key, _CREATE_FAILED)
            if seg is None:
                transports[r] = tcp_factory(sock, r)
                continue
            try:
                ack = kv.wait_get(ack_key, timeout=timeout)
            finally:
                # Unlink now, ack or not (also when the attacher died
                # mid-pairing and the wait raised): the mappings persist,
                # the name must not.
                seg.unlink()
            if isinstance(ack, bytes):
                ack = ack.decode()
            if ack == "ok":
                transports[r] = shm_factory(sock, seg, True, r)
            else:
                seg.close()
                transports[r] = tcp_factory(sock, r)
        else:
            name = kv.wait_get(name_key, timeout=timeout)
            if isinstance(name, bytes):
                name = name.decode()
            seg = None
            if name and name != _CREATE_FAILED:
                try:
                    _fi.fire("shm.attach", name)
                    seg = ShmSegment.attach(name)
                except Exception:
                    seg = None
            if seg is None:
                kv.put(ack_key, "fail")
                transports[r] = tcp_factory(sock, r)
            else:
                kv.put(ack_key, "ok")
                transports[r] = shm_factory(sock, seg, False, r)
    return transports


def make_transport_pair(slot_bytes: int = 4096, nslots: int = 4
                        ) -> Tuple[ShmRingTransport, ShmRingTransport]:
    """An in-process shm transport pair (for tests): create, attach and
    unlink at once, as the KV pairing does, with no rendezvous."""
    seg_a = ShmSegment.create(slot_bytes=slot_bytes, nslots=nslots)
    seg_b = ShmSegment.attach(seg_a.name)
    seg_a.unlink()
    return (ShmRingTransport(seg_a, lower=True, peer=1),
            ShmRingTransport(seg_b, lower=False, peer=0))
