"""KV client for the launcher's rendezvous server: the port's copy of
``horovod_tpu/runner/http_client.py`` (``parse_kv_addrs`` and
``KVClient``'s ``put``, ``get``, ``get_bytes``, ``wait_get`` and
``local_address``).

Requests carry an HMAC of method, path and body under the job's secret
(``HVD_SECRET_KEY``, which the launcher hands its workers), so the port's
workers rendezvous through the JAX package's launcher.  Every request
retries with capped exponential backoff and jitter (``HVD_KV_RETRIES``
attempts, each bounded by ``HVD_KV_TIMEOUT``); a 5xx or a connection error
is retried, a 4xx is not (a 404 is the "not there yet" answer that
``wait_get`` polls on).  ``HVD_KV_ADDRS`` (``host:port,host:port``, primary
first) makes the client rotate to the next endpoint on each retryable
failure.  Writes under ``elastic/`` carry the process's membership epoch
(``HVD_ELASTIC_EPOCH``), and the server's 409 for a stale one raises
:class:`~horovod_tpu_torch.common.types.FencedError`.

Every attempt of a request fires its fault site (``kv.put`` or
``kv.get``, with the key as detail) before it goes out, so that an
injected fault rides the retries.

Left out until telemetry is ported (ROADMAP Queue 1, item 5.5): the retry
counter and the flight recorder's note.
"""

from __future__ import annotations

import os
import re
import socket
import time
import urllib.error
import urllib.request
import zlib
from typing import List, Optional, Tuple

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common.retry import retry_call
from horovod_tpu_torch.common.types import FencedError
from horovod_tpu_torch.runner import secret as secret_mod
from horovod_tpu_torch.utils import env as env_util

# The rendezvous server's membership-epoch header
# (``horovod_tpu/runner/http_server.py``).
EPOCH_HEADER = "X-HVD-Epoch"


def _retryable(e: BaseException) -> bool:
    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500
    return isinstance(e, (urllib.error.URLError, ConnectionError,
                          socket.timeout, TimeoutError, OSError))


def parse_kv_addrs(spec: str) -> List[Tuple[str, int]]:
    """Parse a comma-separated ``host:port`` endpoint list (the
    ``HVD_KV_ADDRS`` format); raises ``ValueError`` on a malformed
    entry."""
    endpoints: List[Tuple[str, int]] = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            raise ValueError(
                f"HVD_KV_ADDRS has an empty entry in {spec!r}; expected "
                f"a comma-separated host:port list")
        host, sep, port_s = entry.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"HVD_KV_ADDRS entry {entry!r} is not host:port")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"HVD_KV_ADDRS entry {entry!r} has a non-numeric "
                f"port {port_s!r}") from None
        if not 1 <= port <= 65535:
            raise ValueError(
                f"HVD_KV_ADDRS entry {entry!r} has port {port} outside "
                f"1..65535")
        endpoints.append((host, port))
    if not endpoints:
        raise ValueError("HVD_KV_ADDRS is empty")
    return endpoints


class KVClient:
    def __init__(self, host: str, port: int,
                 secret: Optional[str] = None):
        addrs = os.environ.get(env_util.KV_ADDRS, "").strip()
        if addrs:
            self.endpoints = parse_kv_addrs(addrs)
        else:
            self.endpoints = [(host, int(port))]
        self._active = 0
        self.secret = (secret if secret is not None
                       else os.environ.get(secret_mod.ENV_VAR) or None)
        self.attempts = max(1, env_util.get_int(env_util.KV_RETRIES, 4))
        self.timeout = env_util.get_float(env_util.KV_TIMEOUT, 10.0)
        self.retry_base = env_util.get_float(env_util.KV_RETRY_BASE_S, 0.05)
        self.retry_max = env_util.get_float(env_util.KV_RETRY_MAX_S, 2.0)

    @property
    def host(self) -> str:
        return self.endpoints[self._active][0]

    @property
    def port(self) -> int:
        return self.endpoints[self._active][1]

    def _rotate_endpoint(self) -> None:
        # Primary, standby 1, standby 2, wrap; sticky across calls.
        if len(self.endpoints) > 1:
            self._active = (self._active + 1) % len(self.endpoints)

    def _url(self, path: str) -> str:
        return f"http://{self.host}:{self.port}{path}"

    def _request(self, key: str, method: str, body: Optional[bytes] = None):
        path = f"/kv/{key}"
        req = urllib.request.Request(self._url(path), data=body,
                                     method=method)
        if method == "PUT" and "elastic/" in key:
            # Stamp elastic writes with this process's membership epoch,
            # so that a stale one is refused with a 409.
            epoch = os.environ.get(env_util.ELASTIC_EPOCH, "")
            if epoch:
                req.add_header(EPOCH_HEADER, epoch)
        if self.secret is not None:
            req.add_header(secret_mod.HEADER, secret_mod.sign(
                self.secret, method, path, body or b""))
        return req

    def _with_retry(self, fn, site: str, key: str):
        def attempt():
            _fi.fire(site, key)
            return fn()

        return retry_call(
            attempt, attempts=self.attempts,
            base_delay=self.retry_base, max_delay=self.retry_max,
            is_retryable=_retryable,
            on_retry=lambda attempt, exc: self._rotate_endpoint(),
            seed=zlib.crc32(key.encode("utf-8")))

    def _raise_if_fenced(self, e: urllib.error.HTTPError,
                         key: str) -> None:
        """Turn the server's 409 epoch-fence rejection into
        :class:`FencedError`."""
        if e.code != 409:
            return
        try:
            detail = e.read().decode("utf-8", "replace")
        except Exception:
            detail = ""
        m = re.search(r"epoch (\d+) is stale.* epoch (\d+)", detail)
        if m:
            stale, current = int(m.group(1)), int(m.group(2))
        else:
            stale = env_util.get_int(env_util.ELASTIC_EPOCH, 0)
            current = -1
        raise FencedError(f"kv write {key!r}", stale, current) from None

    def put(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode("utf-8")

        def go():
            try:
                with urllib.request.urlopen(
                        self._request(key, "PUT", value),
                        timeout=self.timeout):
                    pass
            except urllib.error.HTTPError as e:
                self._raise_if_fenced(e, key)
                raise

        self._with_retry(go, "kv.put", key)

    def get(self, key: str) -> Optional[str]:
        b = self.get_bytes(key)
        return None if b is None else b.decode("utf-8")

    def get_bytes(self, key: str) -> Optional[bytes]:
        def go():
            try:
                with urllib.request.urlopen(self._request(key, "GET"),
                                            timeout=self.timeout) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return None
                raise

        return self._with_retry(go, "kv.get", key)

    def wait_get(self, key: str, timeout: float = 60.0,
                 interval: float = 0.05) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            v = self.get(key)
            if v is not None:
                return v
            time.sleep(interval)
        raise TimeoutError(f"rendezvous key {key!r} not available "
                           f"after {timeout}s")

    def local_address(self) -> Optional[str]:
        """The local interface address that routes to the rendezvous
        server: an address the peers can reach without NIC
        configuration."""
        try:
            s = socket.create_connection((self.host, self.port), timeout=5)
            addr = s.getsockname()[0]
            s.close()
            return addr
        except OSError:
            return None
