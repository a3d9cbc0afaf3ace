"""Host parsing, slot allocation and the relaunch blacklist: the port of
``horovod_tpu/runner/hosts.py``.

Ranks are assigned host by host; ``local_rank`` is the index within the
host; ``cross_rank`` is the index of the host among all hosts that have a
process at the same local rank (the cross-communicator layout: on GPU
hosts, which node).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

from horovod_tpu_torch.utils import env as env_util


@dataclass(frozen=True)
class HostSlots:
    hostname: str
    slots: int


@dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


# hostname/IPv4, or bracketed IPv6; optional ":slots" suffix
_HOST_RE = re.compile(
    r"^(?P<host>[\w.\-]+|\[[0-9a-fA-F:]+\])(:(?P<slots>\d+))?$")


def parse_hosts(hosts_str: str) -> List[HostSlots]:
    """``"hostA:2,hostB:4"`` -> ``[HostSlots("hostA", 2), ...]``.  A host
    with no ``:slots`` suffix gets 1 slot."""
    out = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        m = _HOST_RE.match(part)
        if not m:
            raise ValueError(f"invalid host string: {part!r}")
        out.append(HostSlots(m.group("host"),
                             int(m.group("slots") or 1)))
    if not out:
        raise ValueError(f"no hosts found in {hosts_str!r}")
    return out


def parse_hostfile(path: str) -> List[HostSlots]:
    """Hostfile lines: ``hostname slots=N`` (mpirun style) or
    ``hostname:N`` or bare ``hostname``."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+)\s+slots\s*=\s*(\d+)\s*$", line)
            if m:
                out.append(HostSlots(m.group(1), int(m.group(2))))
            else:
                out.extend(parse_hosts(line))
    if not out:
        raise ValueError(f"no hosts found in hostfile {path}")
    return out


class HostBlacklist:
    """Failure tracking for the relaunch loop (``hvdrun --max-restarts``).

    A host whose workers died ``threshold`` times inside the cool-down
    window is *blacklisted*: skipped on the next allocation while the
    remaining hosts still cover ``np`` slots.  Failures age out after
    ``cooldown_s``: a flaky host is re-probed instead of banned forever.
    """

    def __init__(self, threshold: int = None, cooldown_s: float = None):
        self.threshold = threshold if threshold is not None else \
            env_util.get_int(env_util.BLACKLIST_THRESHOLD, 2)
        self.cooldown_s = cooldown_s if cooldown_s is not None else \
            env_util.get_float(env_util.BLACKLIST_COOLDOWN_S, 300.0)
        self._failures: Dict[str, List[float]] = {}

    def record_failure(self, hostname: str, now: float = None) -> None:
        if not hostname:
            return
        self._failures.setdefault(hostname, []).append(
            time.monotonic() if now is None else now)

    def failure_count(self, hostname: str, now: float = None) -> int:
        now = time.monotonic() if now is None else now
        recent = [t for t in self._failures.get(hostname, ())
                  if now - t <= self.cooldown_s]
        self._failures[hostname] = recent
        return len(recent)

    def is_blacklisted(self, hostname: str, now: float = None) -> bool:
        return self.failure_count(hostname, now) >= self.threshold

    def filter_hosts(self, hosts: List[HostSlots],
                     np: int) -> List[HostSlots]:
        """``hosts`` minus blacklisted entries — unless that leaves fewer
        than ``np`` slots, in which case the full list comes back (a
        degraded host is better than no relaunch at all)."""
        keep = [h for h in hosts if not self.is_blacklisted(h.hostname)]
        if keep and sum(h.slots for h in keep) >= np:
            return keep
        return hosts


def allocate(hosts: List[HostSlots], np: int) -> List[SlotInfo]:
    """Assign ``np`` ranks to hosts in order.

    Raises if the hosts provide fewer than ``np`` slots.  Extra slots are
    left unused (matches ``horovodrun -np`` semantics).
    """
    # Merge duplicate hostname entries (mpirun hostfiles add slots by
    # repeating the host), preserving first-seen order.
    merged: Dict[str, int] = {}
    for h in hosts:
        merged[h.hostname] = merged.get(h.hostname, 0) + h.slots
    hosts = [HostSlots(name, slots) for name, slots in merged.items()]

    total = sum(h.slots for h in hosts)
    if total < np:
        raise ValueError(
            f"requested {np} processes but hosts only provide {total} "
            f"slots")
    # Host-by-host assignment.
    assignment: List[Tuple[str, int]] = []  # (hostname, local_rank)
    per_host: List[Tuple[str, int]] = []    # (hostname, local_size)
    remaining = np
    for h in hosts:
        if remaining == 0:
            break
        use = min(h.slots, remaining)
        if use == 0:
            continue  # zero-slot entry excludes a host; keep scanning
        per_host.append((h.hostname, use))
        for lr in range(use):
            assignment.append((h.hostname, lr))
        remaining -= use

    local_sizes = dict(per_host)
    # cross_rank: index of this host among hosts having a slot at the same
    # local_rank; cross_size: number of such hosts.
    hosts_order = [h for h, _ in per_host]
    out = []
    for rank, (hostname, lr) in enumerate(assignment):
        hosts_with_lr = [h for h in hosts_order if local_sizes[h] > lr]
        out.append(SlotInfo(
            hostname=hostname,
            rank=rank,
            size=np,
            local_rank=lr,
            local_size=local_sizes[hostname],
            cross_rank=hosts_with_lr.index(hostname),
            cross_size=len(hosts_with_lr),
        ))
    return out
