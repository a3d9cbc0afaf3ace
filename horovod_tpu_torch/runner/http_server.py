"""Rendezvous KV server: the port of ``horovod_tpu/runner/http_server.py``
(``RendezvousServer``), the store the eager engine's ranks exchange their
addresses through.

Protocol: ``PUT /kv/<key>`` stores the body; ``GET /kv/<key>`` returns it
or 404; ``DELETE /kv/<key>`` removes it; ``GET /kvlist/<prefix>`` returns
the keys under a prefix, sorted, one a line (the elastic leader's list of
pending joiners); ``GET /health`` returns ``ok``; ``GET /kvsync`` returns
the whole store as JSON (base64 values), from which a standby catches up.

When the server holds a job secret, every ``/kv/`` request must carry a
valid ``X-HVD-Auth: HMAC-SHA256(method, path, body)`` header, or it is
refused with 403.  A mutation of an ``elastic/*`` key may carry
``X-HVD-Epoch: <n>``, the writer's membership epoch: the server remembers
the newest epoch of each elastic namespace and answers an older write with
409, so that a zombie rank cannot corrupt a re-formed gang's state; each
such rejection adds one to ``hvd_fenced_writes_total``.

Replication: a server constructed with ``mirrors=[(host, port), ...]``
forwards every accepted ``PUT``/``DELETE`` to each mirror over the same
signed protocol, its epoch header included, so that a standby fences as
the primary does (the ``kv.mirror`` fault site drops a forward; a failed
forward is dropped, and a restarted standby repairs itself from
``/kvsync``).  Clients fail over down ``HVD_KV_ADDRS`` (``http_client``).
``python -m horovod_tpu_torch.runner.http_server`` runs a primary or a
standby as a process of its own.

The ``kv.server.request`` fault site turns a request into a 503, the
retryable shed of a loaded or restarting server.
"""

from __future__ import annotations

import base64
import json
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.runner import secret as secret_mod
from horovod_tpu_torch.telemetry import registry as _tmx

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
            _tmx.inc_counter("hvd_fenced_writes_total")
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
        if self.path == "/kvsync":
            # The whole store for a standby's catch-up: {key: b64(value)}.
            with self.server.kv_lock:  # type: ignore[attr-defined]
                snap = {k: base64.b64encode(v).decode("ascii")
                        for k, v in self._store().items()}
            self._reply(200, json.dumps(snap).encode("utf-8"))
            return
        if self.path.startswith("/kvlist/"):
            prefix = self.path[len("/kvlist/"):]
            with self.server.kv_lock:  # type: ignore[attr-defined]
                keys = sorted(k for k in self._store()
                              if k.startswith(prefix))
            self._reply(200, "\n".join(keys).encode("utf-8"))
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
            self.server.mirror_write(  # type: ignore[attr-defined]
                "PUT", key, body, epoch=self.headers.get(EPOCH_HEADER))
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
        if key:
            self.server.mirror_write(  # type: ignore[attr-defined]
                "DELETE", key, None, epoch=self.headers.get(EPOCH_HEADER))
        self._reply(200)


class _KVServer(ThreadingHTTPServer):
    """A threaded HTTP server that mirrors its writes to standbys."""

    daemon_threads = True

    kv_store: Dict[str, bytes]
    kv_lock: threading.Lock
    kv_secret: Optional[str]
    kv_mirrors: List[Tuple[str, int]]
    kv_mirror_timeout: float
    kv_epochs: Dict[str, int]  # elastic namespace -> newest epoch seen

    def mirror_write(self, method: str, key: str, body: Optional[bytes],
                     epoch: Optional[str] = None) -> None:
        """Forward an accepted mutation to every standby.  Best effort: a
        dead or slow mirror costs one short timeout, never the request."""
        for host, port in self.kv_mirrors:
            try:
                _fi.fire("kv.mirror", f"{method} {key} -> {host}:{port}")
                path = f"/kv/{key}"
                req = urllib.request.Request(
                    f"http://{host}:{port}{path}", data=body, method=method)
                if epoch is not None:
                    # A standby fences as the primary does: a zombie that
                    # fails over after a 409 gets the same answer there.
                    req.add_header(EPOCH_HEADER, epoch)
                if self.kv_secret is not None:
                    req.add_header(secret_mod.HEADER, secret_mod.sign(
                        self.kv_secret, method, path, body or b""))
                with urllib.request.urlopen(req,
                                            timeout=self.kv_mirror_timeout):
                    pass
            except Exception:
                # Unreachable or dropped: the write stands on this server.
                pass


class RendezvousServer:
    """Threaded KV server; ``start()`` returns the bound port.

    ``secret``: when given, requests must be HMAC-signed; ``None`` (the
    default) keeps the store open, for loopback fixtures.  ``mirrors``:
    ``(host, port)`` standbys that get a copy of every PUT and DELETE."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 secret: Optional[str] = None,
                 mirrors: Optional[Sequence[Tuple[str, int]]] = None,
                 mirror_timeout: float = 2.0):
        self._httpd = _KVServer((host, port), _Handler)
        self._httpd.kv_store = {}
        self._httpd.kv_epochs = {}
        self._httpd.kv_lock = threading.Lock()
        self._httpd.kv_secret = secret
        self._httpd.kv_mirrors = [(h, int(p)) for h, p in (mirrors or [])]
        self._httpd.kv_mirror_timeout = mirror_timeout
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def set_mirrors(self, mirrors: Sequence[Tuple[str, int]]) -> None:
        self._httpd.kv_mirrors = [(h, int(p)) for h, p in mirrors]

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

    def get(self, key: str) -> Optional[bytes]:
        """A direct read, for the launcher's own process (the function
        mode's results)."""
        with self._httpd.kv_lock:
            return self._httpd.kv_store.get(key)

    def sync_from(self, host: str, port: int, timeout: float = 5.0) -> bool:
        """A standby's catch-up: replace this store with the source's
        ``/kvsync`` snapshot.  False, leaving the store as it was, when the
        source is unreachable (a standby started before its primary begins
        empty and fills through the mirroring)."""
        path = "/kvsync"
        req = urllib.request.Request(f"http://{host}:{port}{path}",
                                     method="GET")
        secret = self._httpd.kv_secret
        if secret is not None:
            req.add_header(secret_mod.HEADER,
                           secret_mod.sign(secret, "GET", path, b""))
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                snap = json.loads(r.read().decode("utf-8"))
        except Exception:
            return False
        store = {k: base64.b64decode(v) for k, v in snap.items()}
        with self._httpd.kv_lock:
            self._httpd.kv_store.clear()
            self._httpd.kv_store.update(store)
        return True


def _main(argv: Optional[List[str]] = None) -> int:
    """A rendezvous KV server as a process of its own (``python -m
    horovod_tpu_torch.runner.http_server``): a primary or a standby that an
    operator, or a test, can kill.  The secret is ``HVD_SECRET_KEY`` when
    set."""
    import argparse
    import os
    import signal

    from horovod_tpu_torch.runner.http_client import parse_kv_addrs

    parser = argparse.ArgumentParser(
        prog="horovod_tpu_torch.runner.http_server",
        description="Standalone rendezvous KV server (primary or standby).")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default="",
                        help="write the bound port here (atomic rename)")
    parser.add_argument("--mirror", action="append", default=[],
                        metavar="HOST:PORT",
                        help="standby to write-through mirror to "
                             "(repeatable)")
    parser.add_argument("--sync-from", default="", metavar="HOST:PORT",
                        help="catch up from this server's /kvsync at start")
    args = parser.parse_args(argv)

    mirrors = [parse_kv_addrs(m)[0] for m in args.mirror]
    secret = os.environ.get(secret_mod.ENV_VAR) or None
    server = RendezvousServer(host=args.host, port=args.port,
                              secret=secret, mirrors=mirrors)
    if args.sync_from:
        src = parse_kv_addrs(args.sync_from)[0]
        server.sync_from(src[0], src[1])
    port = server.start(name="hvd-kv-main")
    if args.port_file:
        with open(args.port_file + ".tmp", "w") as f:
            f.write(str(port))
        os.replace(args.port_file + ".tmp", args.port_file)
    print(f"KV {args.host}:{port}", flush=True)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    done.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
