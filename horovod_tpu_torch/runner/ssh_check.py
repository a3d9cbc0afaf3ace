"""ssh reachability checks before a launch, with an on-disk result cache:
the port of ``horovod_tpu/runner/ssh_check.py``.

An unreachable host fails the launch with a named error before any worker
is spawned; a repeat launch with the same parameters skips the probe of a
host that answered inside the cache's staleness window; only successes are
cached, and ``--disable-cache`` forces a fresh probe.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import threading
import time
from typing import List, Optional

# How long a host's successful probe stays good.
CACHE_STALENESS_MINUTES = 60.0
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.expanduser("~"), ".horovod_tpu")


class LaunchCache:
    """Tiny JSON file cache for launcher init checks.

    One file per parameter hash, holding ``{key: [timestamp, value]}``.
    A corrupt or unreadable cache file reads as empty: the cache never
    fails a launch.
    """

    def __init__(self, params_hash: str,
                 cache_dir: Optional[str] = None,
                 staleness_minutes: float = CACHE_STALENESS_MINUTES):
        cache_dir = cache_dir or os.environ.get(
            "HVD_CACHE_DIR", _DEFAULT_CACHE_DIR)
        self._path = os.path.join(cache_dir, f"cache_{params_hash}.json")
        self._window_s = staleness_minutes * 60.0
        self._lock = threading.Lock()

    def _load(self) -> dict:
        try:
            with open(self._path) as f:
                d = json.load(f)
            return d if isinstance(d, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, key: str):
        """Cached value, or None if absent/stale."""
        with self._lock:
            entry = self._load().get(key)
        if not entry:
            return None
        ts, value = entry
        if time.time() - ts > self._window_s:
            return None
        return value

    def put(self, key: str, value) -> None:
        with self._lock:
            d = self._load()
            d[key] = [time.time(), value]
            tmp = f"{self._path}.tmp.{os.getpid()}"
            try:
                os.makedirs(os.path.dirname(self._path), exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(d, f)
                os.replace(tmp, self._path)
            except OSError:
                pass  # a cache write failure must not fail the launch


def params_hash(np: int, hosts: Optional[str],
                ssh_port: Optional[int],
                ssh_identity_file: Optional[str] = None) -> str:
    """Hash of the launch parameters that affect the checks (np, hosts, ssh
    port and identity file: new credentials invalidate a verdict probed
    with the old ones); sha256, which FIPS-mode hosts allow."""
    params = (f"{np} {hosts or ''} {ssh_port or ''} "
              f"{ssh_identity_file or ''}")
    return hashlib.sha256(params.encode()).hexdigest()


class SSHUnreachableError(RuntimeError):
    """One or more remote hosts did not answer an ssh probe."""


def check_hosts_ssh(
    hostnames: List[str],
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
    cache: Optional[LaunchCache] = None,
    timeout: float = 15.0,
) -> None:
    """Probe ``ssh <host> true`` on every host in parallel; raise
    :class:`SSHUnreachableError` naming the failures.

    A cached success within the staleness window skips the probe for
    that host.  Only successes are cached: an unreachable host is
    re-probed on the next launch (it may have come back).
    """
    to_probe = []
    for h in hostnames:
        if cache is not None and cache.get(f"ssh:{h}") is True:
            continue
        to_probe.append(h)
    if not to_probe:
        return

    failures: dict = {}

    def probe(host: str) -> None:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
               "-o", "BatchMode=yes",
               "-o", f"ConnectTimeout={max(1, int(timeout) - 1)}"]
        if ssh_port:
            cmd += ["-p", str(ssh_port)]
        if ssh_identity_file:
            cmd += ["-i", ssh_identity_file]
        cmd += [host, "true"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
            if proc.returncode != 0:
                failures[host] = (proc.stderr or proc.stdout
                                  or f"rc={proc.returncode}").strip()[-200:]
        except subprocess.TimeoutExpired:
            failures[host] = f"no answer within {timeout}s"
        except OSError as e:  # ssh binary itself missing/broken
            failures[host] = str(e)

    threads = [threading.Thread(target=probe, args=(h,), daemon=True)
               for h in to_probe]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    if failures:
        detail = "; ".join(f"{h}: {msg}" for h, msg in
                           sorted(failures.items()))
        raise SSHUnreachableError(
            f"ssh unreachable on {len(failures)} host(s); not spawning "
            f"any worker. {detail}")
    if cache is not None:
        for h in to_probe:
            cache.put(f"ssh:{h}", True)
