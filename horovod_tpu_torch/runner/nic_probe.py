"""Pre-launch NIC discovery, per-host agents and a ring routability probe:
the port of ``horovod_tpu/runner/nic_probe.py``.

Before a multi-host job is spawned with no ``--network-interface``, an
agent runs on every host, registers its IPv4 interfaces, and probes the
interfaces of the next host in a ring; the launcher intersects the
per-host routable sets, so that the job rendezvouses on a network every
host reaches instead of on the default route's guess.  The agents talk
through the launcher's HMAC-signed KV store, and a probe is one TCP
connect per candidate interface.

Flow (n hosts, host index h):
  1. agent h: listen on an ephemeral TCP port, enumerate interfaces,
     ``PUT nicprobe/addrs/h = {ifname: [addr, port], ...}``;
  2. agent h: wait for ``nicprobe/addrs/(h+1) % n``; try a TCP connect to
     every advertised (addr, port); ``PUT nicprobe/routable/(h+1)%n`` =
     names of the next host's interfaces reachable from here;
  3. launcher: intersect all ``nicprobe/routable/*`` sets, ``PUT
     nicprobe/done`` so that the agents close their listeners and exit.
"""

from __future__ import annotations

import array
import fcntl
import json
import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

_SIOCGIFCONF = 0x8912
_DONE_KEY = "nicprobe/done"


def enumerate_interfaces() -> Dict[str, str]:
    """All IPv4-configured interface names -> addresses (SIOCGIFCONF)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # struct ifreq is 40 bytes on LP64 (16 name + 24 ifr_ifru), 32 on
        # 32-bit; ifc_len comes back truncated to whole records, and the
        # ioctl reports success even when truncating: grow until the
        # kernel leaves slack (many-veth container hosts exceed any
        # fixed guess).
        step = 40 if struct.calcsize("P") == 8 else 32
        n_records = 64
        while True:
            bufsize = step * n_records
            buf = array.array("B", b"\0" * bufsize)
            ifconf = struct.pack("iL", bufsize, buf.buffer_info()[0])
            outbytes = struct.unpack(
                "iL", fcntl.ioctl(s.fileno(), _SIOCGIFCONF, ifconf))[0]
            if outbytes < bufsize:
                break
            n_records *= 2
        data = buf.tobytes()[:outbytes]
        out: Dict[str, str] = {}
        for i in range(0, outbytes, step):
            name = data[i:i + 16].split(b"\0", 1)[0].decode()
            addr = socket.inet_ntoa(data[i + 20:i + 24])
            out[name] = addr
        return out
    finally:
        s.close()


def _can_connect(addr: str, port: int, timeout: float) -> bool:
    try:
        with socket.create_connection((addr, port), timeout=timeout):
            return True
    except OSError:
        return False


def run_agent(host_index: int, n_hosts: int, kv,
              probe_timeout: float = 3.0,
              wait_timeout: float = 60.0) -> List[str]:
    """One host's side of the ring probe (steps 1-2 above).

    Returns the list of next-host interface names this host could reach
    (also PUT to the KV store for the launcher).
    """
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("0.0.0.0", 0))
    listener.listen(n_hosts * 8)
    port = listener.getsockname()[1]
    stop = threading.Event()

    def _accept_loop():
        listener.settimeout(0.25)
        while not stop.is_set():
            try:
                conn, _ = listener.accept()
                conn.close()
            except socket.timeout:
                continue
            except OSError:
                break

    acceptor = threading.Thread(target=_accept_loop, daemon=True)
    acceptor.start()
    try:
        ifaces = enumerate_interfaces()
        kv.put(f"nicprobe/addrs/{host_index}",
               json.dumps({n: [a, port] for n, a in ifaces.items()}))
        nxt = (host_index + 1) % n_hosts
        theirs = json.loads(
            kv.wait_get(f"nicprobe/addrs/{nxt}", timeout=wait_timeout))
        routable = [name for name, (addr, p) in theirs.items()
                    if _can_connect(addr, p, probe_timeout)]
        kv.put(f"nicprobe/routable/{nxt}", json.dumps(routable))
        # Keep answering probes until every host has reported and the
        # launcher signals completion (step 3).
        deadline = time.monotonic() + wait_timeout
        while time.monotonic() < deadline:
            if kv.get(_DONE_KEY) is not None:
                break
            time.sleep(0.1)
        return routable
    finally:
        stop.set()
        acceptor.join(timeout=2.0)
        listener.close()


def common_interfaces(kv, n_hosts: int,
                      wait_timeout: float = 60.0) -> List[str]:
    """Launcher side (step 3): intersect the per-host routable sets.

    Returns interface names routable on every host, non-loopback first.
    Signals the agents to exit before returning.
    """
    try:
        sets = []
        for i in range(n_hosts):
            routable = json.loads(
                kv.wait_get(f"nicprobe/routable/{i}",
                            timeout=wait_timeout))
            sets.append(set(routable))
        common = set.intersection(*sets) if sets else set()
    finally:
        kv.put(_DONE_KEY, "1")
    if not common:
        raise RuntimeError(
            "NIC ring probe found no interface reachable from every "
            f"host (per-host routable sets: {sets}); pass "
            "--network-interface explicitly")
    return sorted(common, key=lambda n: (n.startswith("lo"), n))


def main(argv: Optional[List[str]] = None) -> int:
    """Agent entry point: ``python -m horovod_tpu_torch.runner.nic_probe``.

    Host coordinates and the rendezvous location arrive in the same env
    block every worker gets (HVD_RANK here is the *host* index: the
    launcher runs one agent per host, not per slot).
    """
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_client import KVClient

    host_index = int(os.environ["HVD_RANK"])
    n_hosts = int(os.environ["HVD_SIZE"])
    kv = KVClient(os.environ["HVD_RENDEZVOUS_ADDR"],
                  int(os.environ["HVD_RENDEZVOUS_PORT"]),
                  secret=os.environ.get(secret_mod.ENV_VAR))
    routable = run_agent(host_index, n_hosts, kv)
    print(f"nic_probe[{host_index}]: routable -> {routable}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
