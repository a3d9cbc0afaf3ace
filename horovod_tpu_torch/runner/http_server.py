"""Rendezvous KV server: the port of ``horovod_tpu/runner/http_server.py``
(``RendezvousServer``), the store the eager engine's ranks exchange their
addresses through.

Protocol: ``PUT /kv/<key>`` stores the body; ``GET /kv/<key>`` returns it
or 404; ``DELETE /kv/<key>`` removes it; ``GET /health`` returns ``ok``.

When the server holds a job secret, every ``/kv/`` request must carry a
valid ``X-HVD-Auth: HMAC-SHA256(method, path, body)`` header, or it is
refused with 403.  A mutation of an ``elastic/*`` key may carry
``X-HVD-Epoch: <n>``, the writer's membership epoch: the server remembers
the newest epoch of each elastic namespace and answers an older write with
409, so that a zombie rank cannot corrupt a re-formed gang's state.

The ``kv.server.request`` fault site turns a request into a 503, the
retryable shed of a loaded or restarting server.

Left out until their features are ported: write-through mirroring to
standbys with its ``kv.mirror`` fault site, the ``/kvsync`` catch-up, the
command line and the launcher's direct reads (ROADMAP Queue 1, item 6,
the periphery), ``/kvlist/`` (the elastic driver's roster, item 5.7) and
the fenced-writes counter (item 5.5).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.runner import secret as secret_mod

# A writer's membership epoch on elastic/* mutations.
EPOCH_HEADER = "X-HVD-Epoch"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _chaos_unavailable(self) -> bool:
        """The ``kv.server.request`` fault site: an injected fault answers
        this request with a 503."""
        try:
            _fi.fire("kv.server.request", f"{self.command} {self.path}")
        except _fi.InjectedFault:
            self._reply(503)
            return True
        return False

    def _store(self) -> Dict[str, bytes]:
        return self.server.kv_store  # type: ignore[attr-defined]

    def _authorized(self, body: bytes = b"") -> bool:
        secret = self.server.kv_secret  # type: ignore[attr-defined]
        if secret is None:
            return True
        return secret_mod.verify(
            secret, self.command, self.path, body,
            self.headers.get(secret_mod.HEADER, ""))

    def _reply(self, code: int, body: bytes = b"") -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _fenced(self, key: Optional[str]) -> bool:
        """True (and 409 already sent) when this mutation carries a stale
        membership epoch for its elastic namespace.  Writes without the
        header never fence."""
        hdr = self.headers.get(EPOCH_HEADER)
        if not key or hdr is None:
            return False
        idx = key.find("elastic/")
        if idx < 0:
            return False
        try:
            epoch = int(hdr)
        except ValueError:
            return False
        scope = key[:idx]
        srv = self.server
        with srv.kv_lock:  # type: ignore[attr-defined]
            newest = srv.kv_epochs.get(scope, -1)  # type: ignore
            stale = epoch < newest
            if not stale:
                srv.kv_epochs[scope] = epoch  # type: ignore
        if stale:
            self._reply(409, (f"fenced: epoch {epoch} is stale, the gang "
                              f"re-formed at epoch {newest}").encode())
        return stale

    def _key(self) -> Optional[str]:
        return self.path[len("/kv/"):] if self.path.startswith("/kv/") \
            else None

    def do_GET(self):
        if self._chaos_unavailable():
            return
        if self.path == "/health":
            self._reply(200, b"ok")
            return
        if not self._authorized():
            self._reply(403)
            return
        key = self._key()
        with self.server.kv_lock:  # type: ignore[attr-defined]
            val = self._store().get(key) if key else None
        if val is None:
            self._reply(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        key = self._key()
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n)
        # After the body's read, so that a 503 leaves the keep-alive
        # stream framed.
        if self._chaos_unavailable():
            return
        if not self._authorized(body):
            self._reply(403)
            return
        if self._fenced(key):
            return
        if key:
            with self.server.kv_lock:  # type: ignore[attr-defined]
                self._store()[key] = body
        self._reply(200)

    def do_DELETE(self):
        if self._chaos_unavailable():
            return
        if not self._authorized():
            self._reply(403)
            return
        key = self._key()
        if self._fenced(key):
            return
        with self.server.kv_lock:  # type: ignore[attr-defined]
            self._store().pop(key, None)
        self._reply(200)


class _KVServer(ThreadingHTTPServer):
    daemon_threads = True


class RendezvousServer:
    """Threaded KV server; ``start()`` returns the bound port.

    ``secret``: when given, requests must be HMAC-signed; ``None`` (the
    default) keeps the store open, for loopback fixtures."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 secret: Optional[str] = None):
        self._httpd = _KVServer((host, port), _Handler)
        self._httpd.kv_store = {}
        self._httpd.kv_epochs = {}
        self._httpd.kv_lock = threading.Lock()
        self._httpd.kv_secret = secret
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, name: str = "hvd-rendezvous") -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=name, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()
