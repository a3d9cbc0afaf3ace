"""Launcher helpers: the port's copy of what it needs of
``horovod_tpu/runner/run.py`` so far, the address of a named network
interface (``HVD_NIC``).  The launcher itself (``hvdrun``) is not ported
yet; the port's workers run under the JAX package's."""

from __future__ import annotations

import fcntl
import socket
import struct
from typing import Optional


def interface_address(ifname: str) -> Optional[str]:
    """IPv4 address of a named interface (the SIOCGIFADDR ioctl), or
    None."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        packed = struct.pack("256s", ifname.strip().encode()[:15])
        addr = fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24]  # SIOCGIFADDR
        return socket.inet_ntoa(addr)
    except OSError:
        return None
    finally:
        s.close()


def interface_address_any(nics: str) -> Optional[str]:
    """First resolvable address from a comma-separated NIC list; raises if
    the user named interfaces and none of them resolve (falling back would
    rendezvous on the wrong network)."""
    names = [n for n in (nics or "").split(",") if n.strip()]
    for n in names:
        addr = interface_address(n)
        if addr:
            return addr
    if names:
        raise ValueError(
            f"--network-interface: none of {names} has an IPv4 address")
    return None
