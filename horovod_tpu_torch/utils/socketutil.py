"""Framed TCP helpers for the eager engine's control star and data
plane: the port of ``horovod_tpu/utils/socketutil.py``.

A frame is ``u8 tag, u32 LE length, payload``, as in the JAX package, so
that a port rank and a JAX rank talk on one socket.  The data plane's hot
path copies nothing in user space: :func:`send_frame_zc` writes header and
payload with one scatter-gather ``sendmsg``, :func:`recv_exact_into` and
:func:`recv_frame_into` receive straight into a caller's buffer, and
:class:`PeerSender` is one persistent sender thread per peer socket, fed
by a queue, so that a ring hop overlaps its send with its receive.

The ``sock.send`` (every frame send), ``sock.recv`` (every exact
receive), ``sock.connect`` (every dial) and ``sock.halfopen`` (the sender
thread's send) fault sites fire where the JAX package fires them.  The
recovery ladder's tags (``TAG_NACK``, ``TAG_RESUME``, ``TAG_FAILOVER``)
ride the data links themselves, never the control star.  The liveness
(``TAG_HEARTBEAT``), abort-agreement (``TAG_ABORT_REPORT``, ``TAG_PROBE``,
``TAG_PROBE_ACK``, ``TAG_ABORT_VERDICT``) and control-tree
(``TAG_TREE_UP``, ``TAG_TREE_DOWN``, ``TAG_REPARENT``) frames ride the
control star, each only while its knob is on.  Tags the port does not send
yet (the serving, clock, blackbox and fence frames) keep their numbers here
as the JAX package reserves them.

:data:`rx_chunks` counts the chunks the data plane of this process has
received (a socket's ``recv_into`` in a receive called with
``count=True``, as the TCP transport calls them; a drained shm slot in
``utils/transport.py``): a worker's control receive thread reads it to
tell a collective whose bytes still arrive, for which it beats, from one
that is wedged.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
import time
from typing import Optional, Tuple

from horovod_tpu_torch.common import fault_injection as _fi

# Data-plane chunks received by this process (see the module docstring).
rx_chunks = 0

HEADER = struct.Struct("<BI")

# Channel tags, numbered as in the JAX package.
TAG_REQUEST_LIST = 1
TAG_RESPONSE_LIST = 2
TAG_DATA = 3
TAG_KV = 4
TAG_HEARTBEAT = 5
TAG_ABORT_REPORT = 6
TAG_PROBE = 7
TAG_PROBE_ACK = 8
TAG_ABORT_VERDICT = 9
TAG_SERVE = 10
TAG_NACK = 11
TAG_RESUME = 12
TAG_FAILOVER = 13
TAG_CLOCK_PING = 14
TAG_CLOCK_PONG = 15
TAG_BLACKBOX = 16
TAG_BLACKBOX_DUMP = 17
TAG_TREE_UP = 18
TAG_TREE_DOWN = 19
TAG_REPARENT = 20
TAG_FENCE = 21


def send_frame(sock: socket.socket, tag: int, payload: bytes) -> None:
    _fi.fire("sock.send", str(tag))
    sock.sendall(HEADER.pack(tag, len(payload)) + payload)


def _as_byte_view(payload) -> memoryview:
    """A flat ``memoryview`` of bytes over ``payload`` without copying.

    Accepts bytes/bytearray/memoryview and C-contiguous numpy arrays —
    including dtypes whose PEP-3118 format memoryview rejects (bfloat16,
    fp8): those go through a uint8 reinterpret view of the same memory.
    """
    if isinstance(payload, memoryview):
        return payload.cast("B") if payload.format != "B" else payload
    if isinstance(payload, (bytes, bytearray)):
        return memoryview(payload)
    # numpy array (possibly an extension dtype): reinterpret as raw bytes.
    import numpy as np

    arr = payload
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    return memoryview(arr.reshape(-1).view(np.uint8))


def send_frame_zc(sock: socket.socket, tag: int, payload) -> None:
    """Scatter-gather frame send: header and payload go to the kernel as
    one ``sendmsg`` (falling back to two ``sendall``s), with the payload
    read directly from the caller's buffer — zero copies in user space.
    Fires the ``sock.send`` site, as :func:`send_frame` does.
    """
    _fi.fire("sock.send", str(tag))
    view = _as_byte_view(payload)
    header = HEADER.pack(tag, len(view))
    if not len(view):
        sock.sendall(header)
        return
    try:
        sent = sock.sendmsg([header, view])
    except (AttributeError, OSError):
        # No sendmsg (exotic platforms / wrapped sockets): two sendalls —
        # still no payload copy, just one extra syscall.
        sock.sendall(header)
        sock.sendall(view)
        return
    total = len(header) + len(view)
    while sent < total:
        # Short write: finish the remainder with sendall over views.
        if sent < len(header):
            sock.sendall(header[sent:])
            sock.sendall(view)
        else:
            sock.sendall(view[sent - len(header):])
        return


def recv_exact(sock: socket.socket, n: int,
               deadline: Optional[float] = None,
               count: bool = False) -> bytes:
    """Receive exactly ``n`` bytes as a new ``bytes`` object.

    Implemented over one preallocated ``bytearray`` + ``recv_into`` — no
    per-chunk ``bytes`` objects and no trailing ``b"".join``.
    """
    buf = bytearray(n)
    recv_exact_into(sock, memoryview(buf), deadline, count=count)
    return bytes(buf)


def recv_exact_into(sock: socket.socket, view: memoryview,
                    deadline: Optional[float] = None,
                    count: bool = False) -> None:
    """Fill ``view`` completely from the socket via ``recv_into``.

    The caller owns the buffer; nothing is allocated here.

    ``deadline`` is an absolute ``time.monotonic()`` timestamp; when
    set, every ``recv_into`` runs under ``settimeout(remaining)`` and a
    :class:`TimeoutError` is raised once the deadline passes.  When
    ``None`` (the default, and what the collectives pass with
    ``HVD_COLLECTIVE_TIMEOUT`` off) there are no clock reads and no
    ``settimeout`` calls: it blocks until the bytes arrive or the peer
    closes.  Fires the ``sock.recv`` site once a call.  ``count``: add
    each chunk to :data:`rx_chunks` (the data plane's receives).
    """
    global rx_chunks
    _fi.fire("sock.recv")
    got = 0
    n = len(view)
    if deadline is None:
        while got < n:
            r = sock.recv_into(view[got:], min(n - got, 1 << 20))
            if not r:
                raise ConnectionError("peer closed connection")
            got += r
            rx_chunks += count
        return
    try:
        while got < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("receive deadline exceeded")
            sock.settimeout(remaining)
            try:
                r = sock.recv_into(view[got:], min(n - got, 1 << 20))
            except socket.timeout:  # alias of TimeoutError on >=3.10
                raise TimeoutError("receive deadline exceeded") from None
            if not r:
                raise ConnectionError("peer closed connection")
            got += r
            rx_chunks += count
    finally:
        # Restore blocking mode; on the timeout path the socket is
        # poisoned (mid-frame) and the caller tears it down anyway.
        try:
            sock.settimeout(None)
        except OSError:
            pass


def recv_frame(sock: socket.socket, deadline: Optional[float] = None,
               count: bool = False) -> Tuple[int, bytes]:
    hdr = recv_exact(sock, HEADER.size, deadline, count=count)
    tag, n = HEADER.unpack(hdr)
    return tag, recv_exact(sock, n, deadline, count=count)


def recv_frame_into(sock: socket.socket, view: memoryview,
                    deadline: Optional[float] = None) -> Tuple[int, int]:
    """Receive one frame's payload straight into ``view`` (which must be
    at least the frame's length); returns ``(tag, nbytes)``."""
    hdr = recv_exact(sock, HEADER.size, deadline)
    tag, n = HEADER.unpack(hdr)
    if n > len(view):
        raise ValueError(
            f"frame payload of {n} bytes exceeds the receive buffer "
            f"({len(view)} bytes)")
    recv_exact_into(sock, view[:n], deadline)
    return tag, n


def recv_frame_header(sock: socket.socket,
                      deadline: Optional[float] = None,
                      count: bool = False) -> Tuple[int, int]:
    """Read just the frame header: ``(tag, payload_len)``.  The caller
    then drains exactly ``payload_len`` bytes with
    :func:`recv_exact_into` — in one gulp or in segments (the segmented
    ring reads a hop in ``HVD_RING_SEGMENT_BYTES`` slices so each
    slice's reduction overlaps the next slice's receive)."""
    hdr = recv_exact(sock, HEADER.size, deadline, count=count)
    return HEADER.unpack(hdr)


def configure_data_socket(sock: socket.socket) -> None:
    """Socket options for data-plane (and ctrl) mesh connections, applied
    on BOTH the dialing and the accepting side: ``TCP_NODELAY`` (ring
    frames are latency-bound; Nagle on either side would delay a ring
    link) and, when ``HVD_SOCK_BUF_BYTES`` is set,
    matching ``SO_SNDBUF``/``SO_RCVBUF`` so segment pipelining has kernel
    buffer to overlap into."""
    from horovod_tpu_torch.utils import env as env_util

    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not a TCP socket (tests use socketpairs)
    buf = env_util.get_int(env_util.SOCK_BUF_BYTES, 0)
    if buf > 0:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, buf)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, buf)
        except OSError:
            pass


class PeerSender:
    """Persistent sender thread for one peer socket.

    The thread is created once (at engine bootstrap) and fed through a
    deque; a ring
    hop enqueues its chunk view and gets back a ticket (sequence number)
    to wait on after its receive completes.  Waiting is a counter
    comparison under a condition variable — no per-send Event object, so
    the steady-state hop loop allocates nothing.

    Send failures (peer gone) are captured and re-raised at ``wait``, so
    the hop loop sees a ``ConnectionError``.
    """

    def __init__(self, sock: socket.socket, name: str = "hvd-send"):
        self._sock = sock
        self._deque: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._enq_seq = 0
        self._done_seq = 0
        self._fail_seq: Optional[int] = None
        self._exc: Optional[BaseException] = None
        self._closing = False
        self.thread = threading.Thread(
            target=self._loop, name=name, daemon=True)
        self.thread.start()

    def send(self, payload, tag: int = TAG_DATA) -> int:
        """Enqueue one frame; returns the ticket to pass to :meth:`wait`.
        ``payload`` may be bytes or a (contiguous) numpy array / view —
        the sender reads it in place, so the region must stay unmodified
        until ``wait`` returns."""
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
        """Block until ticket ``seq`` has hit the kernel (or raise the
        send error that stopped the thread).

        ``timeout`` bounds the *total* wait: remaining time is
        recomputed across spurious/partial wakeups, so the call returns
        (or raises :class:`TimeoutError`) within ``timeout`` seconds of
        entry, not per condition-variable wait."""
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
                # This ticket (or an earlier one it was queued behind)
                # never reached the kernel.
                raise ConnectionError(
                    f"peer send failed: {self._exc!r}") from self._exc

    def close(self, timeout: float = 5.0) -> None:
        """Stop the thread (after draining already-enqueued sends)."""
        with self._cv:
            if self._closing:
                self.thread.join(timeout)
                return
            self._closing = True
            self._cv.notify_all()
        self.thread.join(timeout)

    # -- internal ---------------------------------------------------------

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
                    # A peer whose outbound path silently blackholes:
                    # "halfopen" blocks here, then surfaces at wait().
                    _fi.fire("sock.halfopen", str(tag))
                    send_frame_zc(self._sock, tag, payload)
            except BaseException as e:  # surface at wait()
                with self._cv:
                    self._exc = e
                    if self._fail_seq is None:
                        self._fail_seq = seq
                    self._cv.notify_all()
            # _done_seq advances even past a failure so close() and
            # wait() never hang; wait() raises via _fail_seq instead.
            with self._cv:
                self._done_seq = seq
                self._cv.notify_all()


def listen_on(host: str = "0.0.0.0", port: int = 0) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(128)
    return s


def connect_retry(host: str, port: int, timeout: float = 30.0,
                  interval: float = 0.05) -> socket.socket:
    """Dial ``host:port`` until ``timeout``, with capped exponential
    backoff + jitter between attempts (``interval`` seeds the backoff
    base) so a gang of workers dialing one listener does not retry in
    lockstep."""
    from horovod_tpu_torch.common.retry import backoff_delays

    deadline = time.monotonic() + timeout
    delays = iter(backoff_delays(
        attempts=64, base_delay=interval, max_delay=1.0, jitter=0.5,
        seed=port))
    last: Optional[OSError] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            # Per-attempt dial timeout: the 5 s cap, shrunk to whatever
            # is left on the overall deadline near expiry — a negative
            # or zero timeout must never reach create_connection.
            _fi.fire("sock.connect", f"{host}:{port}")
            s = socket.create_connection(
                (host, port), timeout=min(5.0, remaining))
            configure_data_socket(s)
            s.settimeout(None)
            return s
        except OSError as e:
            last = e
            d = next(delays, 1.0)
            time.sleep(min(d, max(0.0, deadline - time.monotonic())))
    raise ConnectionError(f"cannot connect to {host}:{port}: {last}")
