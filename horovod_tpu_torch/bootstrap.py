"""Process-group socket bootstrap for the eager engine: the port of
``horovod_tpu/bootstrap.py``.

Builds the TCP topology the engine runs on:

* a full **data mesh** (one socket per peer pair) for the ring data plane,
* a **control star** (worker -> rank 0) for the request/response protocol,
* on a control tree (``runtime_py.PyEngine._plan_tree``), one more link
  from each child to its host's sub-coordinator, on channel 2.

Rank addresses rendezvous through the launcher's HTTP KV store, over the
port's :class:`~horovod_tpu_torch.runner.http_client.KVClient`, with the
JAX package's keys and handshake (each dialed socket starts with
``i32 rank, i32 channel``: 0 data, 1 control, 2 tree), so that port ranks
and JAX ranks bootstrap into one mesh.

The ``bootstrap.start`` (entry) and ``bootstrap.accept`` (each accepted
dial) fault sites fire where the JAX package fires them.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import socketutil as su


def bootstrap_mesh(rank: int, size: int, rdv_addr: str, rdv_port: int,
                   keep_listener: bool = False, tree: Optional[dict] = None,
                   shm_capable: bool = True):
    """Returns ``(data, ctrl_sock, ctrl_socks, kv, prefix)``:

    * ``data``: peer rank -> connected data socket (full mesh),
    * ``ctrl_sock``: a worker's connection to the coordinator (None on
      rank 0),
    * ``ctrl_socks``: the coordinator's per-worker sockets (empty off
      rank 0),
    * ``kv`` / ``prefix``: the rendezvous client and key namespace, for the
      transport pairing after the mesh (``utils/transport.py``).

    The host record published for transport selection is the host's
    fingerprint, or ``tcp-only-<rank>`` under ``HVD_SHM_DISABLE`` and from
    a rank with no shm ring (``shm_capable=False``: the native engine).

    ``keep_listener=True`` (the recovery ladder, ``HVD_WIRE_CRC=1``)
    appends ``(peers, listener)`` instead of closing the listener:
    ``peers`` maps rank -> advertised ``(host, port)``, and the listener
    stays open for reconnect re-dials for the life of the gang
    (``utils/ladder.py``'s ``ReconnectListener``).

    ``tree`` (the control tree) is an in/out dict: in, ``parent`` (this
    rank's sub-coordinator, or None) and ``children`` (the ranks it
    folds); out, it gains ``parent_sock`` (a child's link up, or None) and
    ``child_socks`` (a sub-coordinator's rank -> socket).  Every rank keeps
    its direct control link besides, so that an orphan of a dead
    sub-coordinator falls back to the star without dialing."""
    from horovod_tpu_torch.runner.http_client import KVClient
    from horovod_tpu_torch.utils import transport as tpt

    _fi.fire("bootstrap.start", str(rank))
    start_timeout = env_util.get_float(env_util.START_TIMEOUT, 120.0)
    kv = KVClient(rdv_addr, rdv_port)
    listener = su.listen_on()
    port = listener.getsockname()[1]
    # A key namespace, so that a relaunched gang never rendezvouses
    # against a previous attempt's addresses on a running server.
    scope = os.environ.get(env_util.RDV_SCOPE, "")
    prefix = f"hvd/{scope}/" if scope else "hvd/"
    # Advertise the launcher's NIC when it named one; otherwise the
    # address of the route to the rendezvous server.
    my_host = None
    nic = os.environ.get(env_util.NIC)
    if nic:
        from horovod_tpu_torch.runner.run import interface_address_any

        try:
            my_host = interface_address_any(nic)
        except ValueError:
            my_host = None  # a NIC list from another host; fall back
    my_host = my_host or kv.local_address() or "127.0.0.1"
    kv.put(f"{prefix}addr/{rank}", f"{my_host}:{port}")
    kv.put(f"{prefix}hostid/{rank}", tpt.host_record_value(rank, shm_capable))
    peers = {}
    for i in range(size):
        if i == rank:
            continue
        v = kv.wait_get(f"{prefix}addr/{i}", timeout=start_timeout)
        host, p = v.rsplit(":", 1)
        peers[i] = (host, int(p))

    # A rank dials every lower rank and accepts from every higher one;
    # workers also dial a control connection to rank 0.
    data: Dict[int, socket.socket] = {}
    ctrl_sock: Optional[socket.socket] = None
    ctrl_socks: Dict[int, socket.socket] = {}

    tree_parent = tree.get("parent") if tree else None
    tree_children = list(tree.get("children") or []) if tree else []

    n_accept = size - 1 - rank
    if rank == 0:
        n_accept += size - 1  # control connections
    n_accept += len(tree_children)  # tree links
    accept_results: Dict[Tuple[int, int], socket.socket] = {}

    def _accept_loop():
        for _ in range(n_accept):
            s, _addr = listener.accept()
            _fi.fire("bootstrap.accept", str(rank))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hdr = su.recv_exact(s, 8)
            peer_rank, chan = struct.unpack("<ii", hdr)
            accept_results[(peer_rank, chan)] = s

    acceptor = threading.Thread(target=_accept_loop, daemon=True)
    acceptor.start()

    for j in range(rank):
        s = su.connect_retry(*peers[j], timeout=start_timeout)
        s.sendall(struct.pack("<ii", rank, 0))
        data[j] = s
    if rank != 0:
        s = su.connect_retry(*peers[0], timeout=start_timeout)
        s.sendall(struct.pack("<ii", rank, 1))
        ctrl_sock = s
    if tree_parent is not None:
        s = su.connect_retry(*peers[tree_parent], timeout=start_timeout)
        s.sendall(struct.pack("<ii", rank, 2))
        tree["parent_sock"] = s

    acceptor.join(timeout=start_timeout * 1.5)
    if acceptor.is_alive():
        listener.close()
        raise ConnectionError("timed out waiting for peer connections")
    tree_child_socks: Dict[int, socket.socket] = {}
    for (peer_rank, chan), s in accept_results.items():
        if chan == 0:
            data[peer_rank] = s
        elif chan == 2:
            tree_child_socks[peer_rank] = s
        else:
            ctrl_socks[peer_rank] = s
    if tree is not None:
        tree.setdefault("parent_sock", None)
        tree["child_socks"] = tree_child_socks
    if keep_listener:
        return data, ctrl_sock, ctrl_socks, kv, prefix, peers, listener
    listener.close()
    return data, ctrl_sock, ctrl_socks, kv, prefix
