"""Data-plane transports: the port of ``horovod_tpu/utils/transport.py``,
over TCP only.

:class:`Transport` is the contract the collectives use (a ticketed async
send, a frame receive, a segmented ``recv_exact_into``, teardown), and
:class:`TcpTransport` implements it over one mesh socket and its
persistent :class:`~horovod_tpu_torch.utils.socketutil.PeerSender`.

Pairing (:func:`build_transports`): every rank publishes a host record to
the rendezvous.  A port rank publishes the rank-unique ``tcp-only-<rank>``
(:func:`host_record_value`), as the JAX package's native engine does, so
no peer (a JAX ``PyEngine`` included) ever pairs shared memory with it:
every pair is TCP, with no extra negotiation.

Left out until their features are ported (ROADMAP Queue 1, item 5): the
same-host shared-memory ring (``ShmRingTransport``), the ``sock.stall``
fault site, the transport byte counter and the trace's transport map.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.utils import socketutil as su


class Transport:
    """What a data-plane peer link must provide.

    ``send`` returns a ticket; ``wait(ticket)`` fences it (raising
    ``TimeoutError`` / ``ConnectionError`` as ``PeerSender.wait`` does).
    ``deadline`` arguments are absolute ``time.monotonic()`` timestamps or
    ``None`` for block-forever."""

    kind = "none"
    peer = -1

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
        """Join the sender thread after the sockets are torn down."""
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
        return su.recv_frame(self.sock, deadline)

    def recv_frame_header(self,
                          deadline: Optional[float] = None
                          ) -> Tuple[int, int]:
        return su.recv_frame_header(self.sock, deadline)

    def recv_exact_into(self, view: memoryview,
                        deadline: Optional[float] = None) -> None:
        su.recv_exact_into(self.sock, view, deadline)

    def close(self, timeout: float = 5.0) -> None:
        self.sender.close(timeout)

    def join(self, timeout: float = 2.0) -> None:
        self.sender.thread.join(timeout)


def host_record_value(rank: int) -> str:
    """What a rank publishes under ``{prefix}hostid/{rank}``.  The port
    cannot attach the shared-memory ring, so it publishes a rank-unique
    token and every peer pairs with it over TCP."""
    return f"tcp-only-{rank}"


def build_transports(data: Dict[int, socket.socket]
                     ) -> Dict[int, Transport]:
    """One :class:`TcpTransport` per mesh peer (``data``: peer rank ->
    socket), in ascending rank order; a TCP-only rank needs no pairing
    round."""
    return {r: TcpTransport(data[r], peer=r) for r in sorted(data)}
