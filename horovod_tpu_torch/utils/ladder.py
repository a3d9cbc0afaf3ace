"""Self-healing data-plane links, the recovery ladder
(``HVD_WIRE_CRC=1``): the port of ``horovod_tpu/utils/ladder.py``.

A link climbs a ladder of cheap rungs in place, and gives up only when
every rung fails:

1. **hop retransmit**: every data frame carries an 8-byte seq and CRC-32
   trailer (``common/wire.py``).  The receiver validates before any byte
   reaches the reduction; a mismatch NACKs the expected seq and the sender
   replays from its retained copies, at most ``HVD_HOP_RETRIES``
   consecutive failures.
2. **peer reconnect**: a dropped TCP data socket is re-dialed (the lower
   rank dials the higher rank's kept-open bootstrap listener, with
   ``connect_retry``'s backoff and jitter); a RESUME handshake carries
   each side's next expected seq, so the stream resumes from the last
   validated frame.
3. **transport failover**: a shm ring that faults demotes that one pair
   to TCP in place, over the mesh socket it kept (a FAILOVER handshake is
   also the resume-point exchange); the rest of the gang keeps its
   transports.
4. **poison**: when a rung is exhausted the link raises
   :class:`~horovod_tpu_torch.common.wire.WireCorruptionError` (with the
   ``peer`` and the ``cause``) from its next send or receive, and the
   engine fails the collective with it.

The links are wire-compatible with the JAX package's ``LadderLink``: the
same trailer, tags, handshakes and shm segment, so that a port rank and a
JAX rank heal one link between them.

Design notes:

* A :class:`LadderLink` is built only with ``HVD_WIRE_CRC=1``; with the
  knob off the engine builds the plain transports and none of this runs.
* The **sender thread** assigns the link's data seq, copies the payload
  into a retention deque (``HVD_LADDER_RETAIN`` frames) before the first
  write, and acks the caller's ticket then: the fusion buffer is free for
  the next hop at once, and every retransmit replays the copy.
* On TCP the **recv thread** owns the socket's read side: it validates
  CRCs, sends NACKs, answers RESUME handshakes and queues validated
  frames for the main thread, so that a NACK is seen even while this
  rank's collective receives from another peer.
* On shm the main thread reads the ring a whole frame at a time (a failed
  CRC never leaks bytes into the reduction), and a **watcher thread**
  blocks on the idle mesh socket, which in shm mode carries exactly one
  possible frame: the peer's FAILOVER.  After the demotion the watcher
  becomes the TCP recv thread.
* Shared memory is not a lossy medium: a bad CRC there means the segment
  is sick, so it demotes straight to TCP (rung 3), whose handshake
  replays the gap.

Timeline instants: ``HOP_RETRY`` and ``TRANSPORT_FAILOVER``, on the rank
that healed.  Fault sites: ``sock.corrupt`` and ``sock.reset`` (TCP data
writes), ``shm.lost`` (ring reads and writes), ``shm.stall`` and
``sock.stall`` (receives).

Left out until telemetry is ported (ROADMAP Queue 1, item 5.5): the
``hvd_hop_retries_total``, ``hvd_peer_reconnects_total`` and
``hvd_transport_failovers_total`` counters, the flight recorder's notes
and the trace's spans.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import socketutil as su
from horovod_tpu_torch.utils import timeline as _tl
from horovod_tpu_torch.utils import transport as tpt

# Bootstrap ident channel for reconnect re-dials (bootstrap.py uses
# 0 = data, 1 = ctrl at mesh build time).
CHAN_RECONNECT = 2

_IDENT = struct.Struct("<ii")


class ReconnectListener:
    """The bootstrap listener, kept open for the life of the gang.

    Routes ``chan == CHAN_RECONNECT`` re-dials to the
    :class:`LadderLink` registered for the dialing rank.  Only the
    higher rank of a pair ever accepts (the lower rank dials), so each
    rank registers exactly its lower-ranked peers' links."""

    def __init__(self, listener: socket.socket):
        self._listener = listener
        self._links: Dict[int, "LadderLink"] = {}
        self._closing = False
        self._thread = threading.Thread(
            target=self._loop, name="hvd-ladder-accept", daemon=True)

    def register(self, peer_rank: int, link: "LadderLink") -> None:
        self._links[peer_rank] = link

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        # Polling accept: closing a listening fd does NOT wake a thread
        # already blocked in accept() on Linux, so a blocking loop would
        # pin close() to its join timeout every shutdown.
        self._listener.settimeout(0.25)
        while not self._closing:
            try:
                s, _addr = self._listener.accept()
            except TimeoutError:
                continue
            except OSError:
                return  # listener closed: shutdown
            try:
                su.configure_data_socket(s)
                peer_rank, chan = _IDENT.unpack(
                    su.recv_exact(s, _IDENT.size))
            except (ConnectionError, OSError):
                s.close()
                continue
            link = self._links.get(peer_rank) \
                if chan == CHAN_RECONNECT else None
            if link is None:
                s.close()  # stale bootstrap dial or unknown peer
                continue
            link._accept_q.put(s)

    def close(self, timeout: float = 2.0) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        self._thread.join(timeout)


class LadderLink(tpt.Transport):
    """One self-healing peer link (see the module docstring).

    Keeps the :class:`~horovod_tpu_torch.utils.transport.Transport`
    contract: ticketed async send, frame receive with absolute deadlines,
    drain-then-force close.  ``kind`` is ``"ladder"``, so that the engine's
    shutdown closes it as it closes a shm transport (the link owns its
    threads and, in shm mode, the segment's mapping); ``medium`` says
    whether shm or TCP carries it now."""

    kind = "ladder"

    @property
    def medium(self) -> str:
        return self._mode

    def __init__(self, rank: int, peer: int, sock: socket.socket, *,
                 seg: Optional[tpt.ShmSegment] = None, lower: bool = False,
                 epoch: int = 0,
                 peer_addr: Optional[Tuple[str, int]] = None):
        self.rank = int(rank)
        self.peer = int(peer)
        self.epoch = int(epoch)
        self._sock = sock
        self._sock_gen = 0
        self._peer_addr = peer_addr
        self._seg = seg
        self._mode = "shm" if seg is not None else "tcp"
        if seg is not None:
            self._writer = tpt._RingWriter(seg, 0 if lower else 1)
            self._reader = tpt._RingReader(seg, 1 if lower else 0)
        self._hdr_buf = bytearray(su.HEADER.size)
        self._shm_dead = False

        self._hop_retries = env_util.hop_retries()
        self._retain_max = env_util.ladder_retain()
        self._retain: collections.deque = collections.deque()
        self._next_seq = 0     # sender: seq of the next data frame
        self._expected = 0     # receiver: next data seq we will accept
        self._nack_streak = 0  # consecutive failed validations

        # sender state (PeerSender-mirror tickets)
        self._snd_cv = threading.Condition()
        self._snd_q: collections.deque = collections.deque()
        self._enq_seq = 0
        self._done_seq = 0
        self._closing = False
        self._poison: Optional[BaseException] = None

        # validated-frame queue (recv thread -> main thread, TCP mode)
        self._rcv_cv = threading.Condition()
        self._rcv_q: collections.deque = collections.deque()
        self._cur: Optional[memoryview] = None  # current frame body
        self._cur_off = 0

        # failover handshake state (shm mode)
        self._fo_lock = threading.Lock()
        self._fo_sent = False
        self._fo_done = threading.Event()

        # reconnect accept hand-off (higher rank side)
        self._accept_q: "queue_mod.Queue[socket.socket]" = queue_mod.Queue()

        self._snd_thread = threading.Thread(
            target=self._send_loop, name=f"hvd-ladder-send-{peer}",
            daemon=True)
        self._rcv_thread = threading.Thread(
            target=self._watch_loop if self._mode == "shm"
            else self._recv_loop,
            name=f"hvd-ladder-recv-{peer}", daemon=True)
        self._snd_thread.start()
        self._rcv_thread.start()

    # -- shared helpers ---------------------------------------------------

    def _ring_stopped(self) -> bool:
        return self._shm_dead or self._closing

    def _poison_exc(self) -> BaseException:
        return self._poison if self._poison is not None \
            else ConnectionError("ladder link closed")

    def _set_poison(self, exc: BaseException) -> None:
        """Exhausted ladder: poison every blocked thread.  The exception
        (normally a WireCorruptionError) surfaces from the main thread's
        next recv/send, where the engine fails the collective with it."""
        with self._snd_cv:
            if self._poison is None:
                self._poison = exc
            self._snd_cv.notify_all()
        with self._rcv_cv:
            self._rcv_cv.notify_all()
        self._fo_done.set()

    # -- send side --------------------------------------------------------

    def send(self, payload, tag: int = su.TAG_DATA) -> int:
        if tag != su.TAG_DATA:
            raise ValueError("ladder links carry only data frames")
        with self._snd_cv:
            if self._poison is not None:
                raise self._poison_exc()
            if self._closing:
                raise ConnectionError("sender is closed")
            self._enq_seq += 1
            ticket = self._enq_seq
            self._snd_q.append(("data", ticket, payload))
            self._snd_cv.notify_all()
        return ticket

    def wait(self, seq: int, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._snd_cv:
            while self._done_seq < seq:
                if self._poison is not None:
                    raise self._poison_exc()
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("send did not complete in time")
                if not self._snd_cv.wait(remaining):
                    raise TimeoutError("send did not complete in time")

    def _send_loop(self) -> None:
        while True:
            with self._snd_cv:
                while not self._snd_q and not self._closing:
                    self._snd_cv.wait()
                if not self._snd_q:
                    return  # closing, queue drained
                entry = self._snd_q.popleft()
            try:
                kind = entry[0]
                if kind == "replay":
                    self._do_replay(entry[1], entry[2])
                elif kind == "ctrl":
                    self._write_ctrl(entry[1], entry[2])
                else:
                    self._process_data(entry[1], entry[2])
            except BaseException as e:
                if self._closing:
                    return
                self._set_poison(
                    e if isinstance(e, ConnectionError)
                    else ConnectionError(f"ladder sender failed: {e!r}"))

    def _process_data(self, ticket: int, payload) -> None:
        # Retention copy FIRST: the caller's buffer (a fusion-buffer
        # slice the allgather phase will overwrite) is free the moment
        # the ticket acks, and every replay reads this copy.
        body = bytes(su._as_byte_view(payload))
        seq = self._next_seq
        self._next_seq = seq + 1
        frame = body + wire.pack_trailer(body, seq)
        self._retain.append((seq, frame))
        while len(self._retain) > self._retain_max:
            self._retain.popleft()
        with self._snd_cv:
            self._done_seq = ticket
            self._snd_cv.notify_all()
        self._write_wire(frame)

    def _do_replay(self, expected: int, cause: str) -> None:
        """Rung 1 in action: re-send every retained frame the peer has
        not validated yet (``seq >= expected``)."""
        if self._retain:
            oldest = self._retain[0][0]
        else:
            oldest = self._next_seq
        if expected < oldest:
            # The needed frames aged out of the retention window: this
            # rung cannot heal the link any more.
            self._set_poison(wire.WireCorruptionError(self.peer, cause))
            return
        frames = [f for s, f in self._retain if s >= expected]
        _tl.engine_event(_tl.HOP_RETRY, peer=self.peer, cause=cause,
                         expected=int(expected), frames=len(frames))
        for f in frames:
            if self._closing or self._poison is not None:
                return
            self._write_wire(f)

    def _write_ctrl(self, tag: int, payload: bytes) -> None:
        """NACKs (TCP rung only).  A write failure here means the socket
        died; the RESUME handshake that heals it re-synchronizes both
        seq cursors, so a lost NACK needs no retry of its own."""
        gen = self._sock_gen
        try:
            su.send_frame_zc(self._sock, tag, payload)
        except (ConnectionError, OSError):
            self._await_new_sock(gen)

    def _write_wire(self, frame: bytes) -> None:
        if self._poison is not None or self._closing:
            return
        if self._mode == "shm":
            try:
                _fi.fire("shm.lost", "write")
                self._writer.write_frame(su.TAG_DATA, frame,
                                         self._ring_stopped)
            except (ConnectionError, OSError) as e:
                # Ring is sick: demote.  The frame is retained; the
                # failover replay covers it, so no rewrite here.
                self._shm_fault(e)
            return
        sock = self._sock
        gen = self._sock_gen
        try:
            _fi.fire("sock.reset", str(self.peer))
        except _fi.InjectedFault:
            self._inject_reset(sock)
        out = frame
        if _fi.should_corrupt("sock.corrupt", str(self.peer)):
            # Flip one byte of a scratch copy: the wire sees garbage,
            # the retention deque keeps the good bytes for the replay.
            out = bytearray(frame)
            out[len(out) // 2] ^= 0x01
        try:
            su.send_frame_zc(sock, su.TAG_DATA, out)
        except (ConnectionError, OSError):
            # Socket died mid-send: the recv thread notices the same
            # death and runs the reconnect dance; its RESUME replay
            # covers this retained frame.
            self._await_new_sock(gen)

    def _await_new_sock(self, gen: int) -> bool:
        """Park the sender until the recv thread heals the socket (or
        the link poisons)."""
        deadline = time.monotonic() + env_util.reconnect_timeout_s() + 5.0
        with self._snd_cv:
            while self._sock_gen == gen and self._poison is None \
                    and not self._closing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._snd_cv.wait(remaining)
            healed = self._sock_gen != gen
        if not healed and self._poison is None and not self._closing:
            self._set_poison(wire.WireCorruptionError(self.peer, "reset"))
        return healed

    @staticmethod
    def _inject_reset(sock: socket.socket) -> None:
        """sock.reset chaos: kill the socket so BOTH sides observe it.
        shutdown() (not just close) matters — a real network reset
        delivers an RST that wakes our recv thread out of its blocked
        read, but closing our own fd would not, and that recv thread is
        the one that runs the reconnect dance."""
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    # -- receive side: main-thread API ------------------------------------

    def recv_frame(self,
                   deadline: Optional[float] = None) -> Tuple[int, bytes]:
        tag, n = self.recv_frame_header(deadline)
        buf = bytearray(n)
        if n:
            self.recv_exact_into(memoryview(buf), deadline)
        return tag, bytes(buf)

    def recv_frame_header(self,
                          deadline: Optional[float] = None
                          ) -> Tuple[int, int]:
        if self._mode == "shm":
            return self._shm_recv_header(deadline)
        return self._tcp_recv_header(deadline)

    def recv_exact_into(self, view: memoryview,
                        deadline: Optional[float] = None) -> None:
        if view.format != "B":
            view = view.cast("B")
        need = len(view)
        got = 0
        while got < need:
            cur = self._cur
            if cur is None or self._cur_off >= len(cur):
                # Segmented readers drain exactly one frame per header,
                # so crossing here means byte-stream continuation into
                # the next validated frame.
                self.recv_frame_header(deadline)
                cur = self._cur
            k = min(len(cur) - self._cur_off, need - got)
            view[got:got + k] = cur[self._cur_off:self._cur_off + k]
            self._cur_off += k
            got += k

    def _tcp_recv_header(self, deadline: Optional[float]) -> Tuple[int, int]:
        _fi.fire("sock.stall")
        with self._rcv_cv:
            while not self._rcv_q:
                if self._poison is not None:
                    raise self._poison_exc()
                if self._closing:
                    raise ConnectionError("ladder link closed")
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("receive deadline exceeded")
                self._rcv_cv.wait(remaining)
            body = self._rcv_q.popleft()
        self._cur = body
        self._cur_off = 0
        return su.TAG_DATA, len(body)

    def _shm_recv_header(self, deadline: Optional[float]) -> Tuple[int, int]:
        _fi.fire("shm.stall")
        while True:
            if self._mode != "shm":
                # Demoted under us (peer-initiated failover): the recv
                # thread is filling the validated queue now.
                return self._tcp_recv_header(deadline)
            try:
                _fi.fire("shm.lost", "read")
                self._reader.recv_into(memoryview(self._hdr_buf),
                                       deadline, self._ring_stopped)
                tag, n = su.HEADER.unpack(bytes(self._hdr_buf))
                payload = bytearray(n)
                if n:
                    self._reader.recv_into(memoryview(payload), deadline,
                                           self._ring_stopped)
            except TimeoutError:
                raise  # collective deadline, not a link fault
            except (ConnectionError, OSError) as e:
                self._shm_fault(e)
                continue
            if tag != su.TAG_DATA:
                continue  # shm carries only data frames
            try:
                body, seq, crc = wire.split_trailer(memoryview(payload))
                ok = crc == wire.data_crc(body, seq)
            except ValueError:
                ok, seq = False, -1
            if not ok:
                # Memory is not a lossy medium: a bad CRC here means the
                # segment is sick.  No NACK rung — demote to TCP, whose
                # handshake replays everything we have not validated.
                self._shm_fault(ConnectionError(
                    f"shm frame from rank {self.peer} failed CRC"))
                continue
            if seq != self._expected:
                continue  # stale duplicate from a replay
            self._expected += 1
            self._cur = body
            self._cur_off = 0
            return su.TAG_DATA, len(body)

    # -- TCP recv thread --------------------------------------------------

    def _recv_loop(self) -> None:
        while not self._closing and self._poison is None:
            sock = self._sock
            try:
                tag, n = su.recv_frame_header(sock)
                payload = bytearray(n)
                if n:
                    su.recv_exact_into(sock, memoryview(payload))
            except (ConnectionError, OSError, ValueError):
                if self._closing or self._poison is not None:
                    return
                if not self._heal_reconnect():
                    return
                continue
            if tag == su.TAG_DATA:
                self._on_data(payload)
            elif tag == su.TAG_NACK:
                self._push_replay(wire.decode_nack(bytes(payload)),
                                  "corrupt")
            # TAG_RESUME / TAG_FAILOVER here are stale handshake echoes
            # from an already-healed incident: ignore.

    def _on_data(self, payload: bytearray) -> None:
        try:
            body, seq, crc = wire.split_trailer(memoryview(payload))
            ok = crc == wire.data_crc(body, seq)
        except ValueError:
            ok = False
        if not ok:
            self._nack_streak += 1
            if self._nack_streak > self._hop_retries:
                self._set_poison(
                    wire.WireCorruptionError(self.peer, "corrupt"))
                return
            with self._snd_cv:
                self._snd_q.appendleft(
                    ("ctrl", su.TAG_NACK, wire.encode_nack(self._expected)))
                self._snd_cv.notify_all()
            return
        if seq != self._expected:
            # Replay duplicate (seq < expected) or an in-flight frame
            # past a corruption (seq > expected — its replay is coming):
            # drop either way, order stays monotonic.
            return
        self._expected += 1
        self._nack_streak = 0
        with self._rcv_cv:
            self._rcv_q.append(body)
            self._rcv_cv.notify_all()

    def _push_replay(self, expected: int, cause: str) -> None:
        with self._snd_cv:
            self._snd_q.appendleft(("replay", int(expected), cause))
            self._snd_cv.notify_all()

    def _heal_reconnect(self) -> bool:
        """Rung 2: re-dial (lower rank) or re-accept (higher rank) the
        data socket, exchange RESUME, and hand the sender a replay of
        everything the peer has not validated."""
        try:
            self._sock.close()
        except OSError:
            pass
        timeout = env_util.reconnect_timeout_s()
        deadline = time.monotonic() + timeout
        try:
            # Re-dial / re-accept in short slices so an overlapping
            # close() (our side OR the peer racing us down during gang
            # shutdown — its FIN looks exactly like a dropped socket)
            # stops the heal within a poll interval instead of pinning
            # this thread for the whole reconnect budget.
            s = None
            while s is None:
                if self._closing or self._poison is not None:
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(
                        f"reconnect to rank {self.peer} timed out")
                if self.rank < self.peer:
                    if self._peer_addr is None:
                        raise ConnectionError(
                            f"no reconnect address for rank {self.peer}")
                    try:
                        s = su.connect_retry(
                            self._peer_addr[0], self._peer_addr[1],
                            timeout=min(0.5, remaining))
                    except ConnectionError:
                        continue
                    s.sendall(_IDENT.pack(self.rank, CHAN_RECONNECT))
                else:
                    try:
                        s = self._accept_q.get(timeout=min(0.25, remaining))
                    except queue_mod.Empty:
                        continue
            # Both sides send first, then read: no ordering deadlock.
            su.send_frame(s, su.TAG_RESUME, wire.encode_resume(
                self.rank, self._expected, self.epoch))
            tag, pl = su.recv_frame(s, deadline)
            if tag != su.TAG_RESUME:
                raise ConnectionError(f"bad resume tag {tag}")
            prank, pexp, pepoch = wire.decode_resume(pl)
            if prank != self.peer or pepoch != self.epoch:
                raise ConnectionError(
                    f"resume from rank {prank} epoch {pepoch}, expected "
                    f"rank {self.peer} epoch {self.epoch}")
        except (ConnectionError, OSError, TimeoutError, queue_mod.Empty):
            self._set_poison(wire.WireCorruptionError(self.peer, "reset"))
            return False
        with self._snd_cv:
            self._sock = s
            self._sock_gen += 1
            self._snd_q.appendleft(("replay", int(pexp), "reset"))
            self._snd_cv.notify_all()
        return True

    # -- shm watcher / failover -------------------------------------------

    def _watch_loop(self) -> None:
        """shm mode: the mesh TCP socket is idle except for exactly one
        frame — the peer's FAILOVER.  Receiving it (or having sent ours
        and receiving the answer) completes the demotion, after which
        this thread becomes the TCP recv thread."""
        try:
            tag, pl = su.recv_frame(self._sock)
        except (ConnectionError, OSError):
            if not self._closing and self._poison is None:
                # The mesh socket under a healthy shm link died: peer
                # process is gone, which no rung can heal.
                self._set_poison(ConnectionError(
                    f"mesh socket to rank {self.peer} lost"))
            return
        if tag != su.TAG_FAILOVER:
            self._set_poison(ConnectionError(
                f"unexpected tag {tag} on idle mesh socket"))
            return
        try:
            prank, pexp, pepoch = wire.decode_resume(pl)
        except struct.error:
            self._set_poison(wire.WireCorruptionError(self.peer,
                                                      "failover"))
            return
        if prank != self.peer or pepoch != self.epoch:
            self._set_poison(ConnectionError(
                f"failover from rank {prank} epoch {pepoch}"))
            return
        self._begin_failover()  # our half of the handshake, if not out yet
        self._complete_failover(pexp)
        self._recv_loop()

    def _begin_failover(self) -> None:
        """Send our FAILOVER (rank, next-expected seq, epoch) exactly
        once, whichever thread detects first."""
        with self._fo_lock:
            if self._fo_sent:
                return
            self._fo_sent = True
            try:
                su.send_frame(self._sock, su.TAG_FAILOVER,
                              wire.encode_resume(self.rank, self._expected,
                                                 self.epoch))
            except (ConnectionError, OSError):
                self._set_poison(
                    wire.WireCorruptionError(self.peer, "failover"))

    def _complete_failover(self, peer_expected: int) -> None:
        """Swap the link to TCP in place (watcher thread only)."""
        self._shm_dead = True  # break ring readers/writers
        with self._snd_cv:
            self._mode = "tcp"
            self._snd_q.appendleft(
                ("replay", int(peer_expected), "failover"))
            self._snd_cv.notify_all()
        with self._rcv_cv:
            self._rcv_cv.notify_all()
        _tl.engine_event(_tl.TRANSPORT_FAILOVER, peer=self.peer,
                         rank=self.rank)
        self._fo_done.set()

    def _shm_fault(self, exc: BaseException) -> None:
        """A ring read/write faulted: initiate (or join) the demotion
        and wait for the watcher to complete it."""
        if self._closing:
            raise ConnectionError("ladder link closed")
        if self._poison is not None:
            raise self._poison_exc()
        self._begin_failover()
        if not self._fo_done.wait(env_util.reconnect_timeout_s() + 5.0):
            self._set_poison(
                wire.WireCorruptionError(self.peer, "failover"))
        if self._poison is not None:
            raise self._poison_exc()

    # -- teardown ---------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        with self._snd_cv:
            already = self._closing
            self._closing = True
            self._snd_cv.notify_all()
        self._shm_dead = True
        self._fo_done.set()
        with self._rcv_cv:
            self._rcv_cv.notify_all()
        self._snd_thread.join(timeout)
        # shutdown(), not just close(): closing an fd does not wake a
        # thread already blocked in recv()/send() on it, and the recv
        # thread lives in a blocking read whenever the link is idle.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._snd_thread.join(1.0)  # a sender wedged mid-write is free now
        self._rcv_thread.join(timeout)
        if self._seg is not None and not already:
            self._seg.close()

    def join(self, timeout: float = 2.0) -> None:
        self._snd_thread.join(timeout)
        self._rcv_thread.join(timeout)


# ---------------------------------------------------------------------------
# engine wiring
# ---------------------------------------------------------------------------


def build_ladder_links(rank: int, size: int,
                       data: Dict[int, socket.socket], kv, prefix: str,
                       peers: Dict[int, Tuple[str, int]],
                       listener: socket.socket, epoch: int = 0
                       ) -> Tuple[Dict[int, tpt.Transport],
                                  ReconnectListener]:
    """Ladder-mode replacement for ``tpt.build_transports``: the same
    KV shm pairing (create/attach/ack, leak-proof unlink), but every
    pair gets a :class:`LadderLink` — shm-backed for same-host peers,
    TCP otherwise — and the bootstrap listener stays open behind a
    :class:`ReconnectListener` for rung-2 re-dials."""
    rl = ReconnectListener(listener)

    def tcp_factory(sock, peer):
        link = LadderLink(rank, peer, sock, epoch=epoch,
                          peer_addr=peers.get(peer))
        rl.register(peer, link)
        return link

    def shm_factory(sock, seg, lower, peer):
        link = LadderLink(rank, peer, sock, seg=seg, lower=lower,
                          epoch=epoch, peer_addr=peers.get(peer))
        rl.register(peer, link)
        return link

    links = tpt.build_transports(rank, size, data, kv, prefix,
                                 tcp_factory=tcp_factory,
                                 shm_factory=shm_factory)
    rl.start()
    return links, rl


def make_ladder_pair(shm: bool = False, slot_bytes: int = 4096,
                     nslots: int = 4
                     ) -> Tuple[LadderLink, LadderLink, ReconnectListener]:
    """In-process pair over loopback for tests: real TCP sockets (so
    resets and reconnects behave like the wire) and a live
    :class:`ReconnectListener` on the higher-rank side.  The caller
    closes both links and the listener."""
    lst = su.listen_on("127.0.0.1")
    host, port = lst.getsockname()
    a = socket.create_connection((host, port))
    su.configure_data_socket(a)
    b, _ = lst.accept()
    su.configure_data_socket(b)
    seg_a = seg_b = None
    if shm:
        seg_a = tpt.ShmSegment.create(slot_bytes=slot_bytes, nslots=nslots)
        seg_b = tpt.ShmSegment.attach(seg_a.name)
        seg_a.unlink()
    link0 = LadderLink(0, 1, a, seg=seg_a, lower=True,
                       peer_addr=(host, port))
    link1 = LadderLink(1, 0, b, seg=seg_b, lower=False)
    rl = ReconnectListener(lst)
    rl.register(0, link1)
    rl.start()
    return link0, link1, rl
