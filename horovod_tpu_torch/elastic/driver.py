"""Host discovery and the membership loop of elastic training: the port of
``horovod_tpu/elastic/driver.py``.

The driver runs on the coordinator's side (in the launcher, or in rank 0's
process when a job opts in directly, ``elastic/run.py``) and polls the host
set on an interval:

* ``HVD_HOST_DISCOVERY_SCRIPT``: an executable that prints one
  ``hostname[:slots]`` a line (:class:`HostDiscoveryScript`);
* a blacklist, any object with ``is_blacklisted(host)``, filters hosts
  that recently killed workers;
* :class:`FixedHostDiscovery`: a static set, or the TPU pod's
  ``TPU_WORKER_HOSTNAMES`` (the JAX package's default seed, kept for the
  same launcher environment).

Every accepted change of the host set bumps the driver's epoch and calls
``on_hosts_updated(epoch, added, removed)`` from the poll thread.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
import time
from typing import Callable, Dict, Optional

from horovod_tpu_torch.utils import env as env_util

log = logging.getLogger("horovod_tpu_torch.elastic")


class HostsUpdatedInterrupt(Exception):
    """The discovered host set changed: re-form the gang at a commit
    instead of waiting for a failure.  Raised on every rank by the same
    ``State.commit()`` (``state.check_host_updates``), caught by
    ``@hvd.elastic.run``."""

    def __init__(self, res: Optional[dict] = None):
        self.res = res or {}
        super().__init__("host set updated; gang re-form requested")


class HostDiscoveryScript:
    """Runs a script that prints ``hostname[:slots]`` a line; blank lines
    and ``#`` comments are skipped, a host without slots gets
    ``default_slots``."""

    def __init__(self, script: str, default_slots: int = 1,
                 timeout_s: float = 30.0):
        self.script = script
        self.default_slots = default_slots
        self.timeout_s = timeout_s

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(
            self.script, shell=True, timeout=self.timeout_s)
        hosts: Dict[str, int] = {}
        for line in out.decode("utf-8").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                hosts[host.strip()] = int(slots)
            else:
                hosts[line] = self.default_slots
        return hosts


class FixedHostDiscovery:
    """A static host set: ``hosts``, or by default the hosts named in
    ``TPU_WORKER_HOSTNAMES`` (one slot each)."""

    def __init__(self, hosts: Optional[Dict[str, int]] = None):
        if hosts is None:
            hosts = {h.strip(): 1 for h in os.environ.get(
                "TPU_WORKER_HOSTNAMES", "").split(",") if h.strip()}
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class ElasticDriver:
    """Polls discovery, filters the blacklist, and bumps the epoch on
    every accepted change.  ``start`` polls once before it returns, so
    that :meth:`wait_for_available_slots` has a host set at once."""

    def __init__(self, discovery, min_np: int, max_np: int,
                 blacklist=None, interval_s: Optional[float] = None,
                 on_hosts_updated: Optional[Callable] = None):
        self.discovery = discovery
        self.min_np = min_np
        self.max_np = max_np
        self.blacklist = blacklist
        self.interval_s = interval_s if interval_s is not None else \
            env_util.get_float(env_util.ELASTIC_DISCOVERY_INTERVAL_S, 1.0)
        self.on_hosts_updated = on_hosts_updated
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._hosts: Dict[str, int] = {}
        self._epoch = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- polling ----------------------------------------------------------

    def start(self) -> None:
        self._poll_once()
        self._thread = threading.Thread(
            target=self._poll_loop, name="hvd-elastic-driver", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._poll_once()

    def _poll_once(self) -> None:
        try:
            found = self.discovery.find_available_hosts_and_slots()
        except Exception as e:
            # A failing or hanging script keeps the last host set: stale
            # but sane data beats evicting everyone on a hiccup.
            log.warning("host discovery failed (%r); keeping the current "
                        "host set", e)
            return
        if self.blacklist is not None:
            found = {h: s for h, s in found.items()
                     if not self.blacklist.is_blacklisted(h)}
        with self._cv:
            if found == self._hosts:
                return
            added = sorted(set(found) - set(self._hosts))
            removed = sorted(set(self._hosts) - set(found))
            self._hosts = found
            self._epoch += 1
            epoch = self._epoch
            self._cv.notify_all()
        log.info("host set changed (epoch %d): +%s -%s", epoch, added,
                 removed)
        if self.on_hosts_updated is not None:
            self.on_hosts_updated(epoch, added, removed)

    # -- queries ----------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def hosts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hosts)

    def slots(self) -> int:
        with self._lock:
            return sum(self._hosts.values())

    def wait_for_available_slots(self, np: int,
                                 timeout: float = 600.0) -> Dict[str, int]:
        """Block until discovery reports at least ``np`` slots; raises
        ``TimeoutError`` after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while sum(self._hosts.values()) < np:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"discovery found {sum(self._hosts.values())} "
                        f"slot(s), need {np} (after {timeout:.0f}s)")
                self._cv.wait(min(remaining, self.interval_s))
            return dict(self._hosts)
