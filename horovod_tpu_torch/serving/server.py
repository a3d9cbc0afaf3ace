"""Per-rank HTTP front door for the serving gang: the port of
``horovod_tpu/serving/server.py``, stdlib only.

A ThreadingHTTPServer with HTTP/1.1 keep-alive and silent request
logging.  ``POST /generate`` blocks the handler thread until the scheduler
completes (or fails) the request; ``GET /stats`` and ``GET /health``
answer immediately.

On the leader (``door.scheduler`` set) requests are admitted locally.  On
a follower (``door.scheduler is None``) the door forwards the body to the
leader's door (the address ``leader_addr_fn`` gives) and relays the
answer, so clients keep one endpoint per rank.

Shedding is typed: a full admission queue answers 503 (the client's signal
to back off), a malformed body 400, and a request that outlives
``timeout_s`` 504 (the request itself stays admitted).  A follower whose
leader is unknown or unreachable answers 503 too.

The ``serve.admit`` fault site turns a request into a 503 shed.  Every
shed, bad or failed request adds one to ``hvd_serve_requests_total`` by
status (a completed one is counted by the scheduler as ``ok``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.serving.scheduler import QueueFull, Scheduler
from horovod_tpu_torch.telemetry import registry as _tmx


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    door: "FrontDoor" = None  # class attr installed by FrontDoor

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _chaos_unavailable(self) -> bool:
        """The ``serve.admit`` fault site: an injected fault sheds this
        request with a 503."""
        try:
            _fi.fire("serve.admit", f"{self.command} {self.path}")
        except _fi.InjectedFault:
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("shed",))
            self._send(503, b"", "text/plain")
            return True
        return False

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode("utf-8"),
                   "application/json")

    def do_GET(self):
        if self._chaos_unavailable():
            return
        if self.path == "/health":
            self._send(200, b"ok", "text/plain")
            return
        if self.path == "/stats":
            scheduler = self.door.scheduler
            if scheduler is None:
                self._send_json(200, {
                    "role": "follower",
                    "leader": self.door.leader_addr() or None,
                })
                return
            stats = scheduler.stats()
            stats["role"] = "leader"
            self._send_json(200, stats)
            return
        self._send(404, b"", "text/plain")

    def do_POST(self):
        if self._chaos_unavailable():
            return
        if self.path != "/generate":
            self._send(404, b"", "text/plain")
            return
        n = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(n)
        scheduler = self.door.scheduler
        if scheduler is None:
            self._forward(raw)
            return
        try:
            body = json.loads(raw or b"{}")
            prompt = [int(t) for t in body["prompt"]]
            max_new = int(body.get("max_new_tokens", 16))
            req_id = body.get("id")
            if req_id is not None and (not isinstance(req_id, str)
                                       or not req_id):
                raise ValueError("id must be a non-empty string")
        except (ValueError, KeyError, TypeError, json.JSONDecodeError):
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("error",))
            self._send_json(400, {"error": "bad request body"})
            return
        try:
            req = scheduler.submit(prompt, max_new, req_id=req_id)
        except QueueFull as e:
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("shed",))
            self._send_json(503, {"error": str(e)})
            return
        except ValueError as e:
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("error",))
            self._send_json(400, {"error": str(e)})
            return
        if not req.done.wait(self.door.timeout_s):
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("error",))
            self._send_json(504, {"error": "request timed out",
                                  "id": req.id})
            return
        if req.error is not None:
            _tmx.inc_counter("hvd_serve_requests_total",
                             labels=("error",))
            self._send_json(500, {"error": req.error, "id": req.id})
            return
        now = time.monotonic()
        self._send_json(200, {
            "id": req.id,
            "tokens": req.tokens,
            "attempts": req.attempts,
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3)
            if req.t_first_token else None,
            "latency_ms": round((now - req.t_submit) * 1e3, 3),
        })

    # -- follower: proxy to the current leader --------------------------

    def _forward(self, raw: bytes) -> None:
        """Relay the POST body to the leader's /generate and stream the
        answer back.  One refresh+retry on a dead leader address (the
        re-elected leader republishes under the KV key); still
        unreachable -> 503, the retryable answer."""
        addr = self.door.leader_addr()
        for attempt in (0, 1):
            if attempt:
                addr = self.door.leader_addr(refresh=True)
            if not addr or addr == self.door.advertised_addr():
                # Unknown leader, or a stale pointer at ourselves while
                # we hold no scheduler: nothing to proxy to yet.
                continue
            try:
                req = urllib.request.Request(
                    f"http://{addr}/generate", data=raw, method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(
                        req, timeout=self.door.timeout_s) as r:
                    self._send(r.status, r.read(),
                               r.headers.get("Content-Type",
                                             "application/json"))
                return
            except urllib.error.HTTPError as e:
                # The leader answered (400/503/...): relay its verdict.
                self._send(e.code, e.read(),
                           e.headers.get("Content-Type",
                                         "application/json"))
                return
            except (urllib.error.URLError, ConnectionError, OSError):
                continue
        _tmx.inc_counter("hvd_serve_requests_total", labels=("shed",))
        self._send_json(503, {"error": "serving leader unreachable; "
                                       "retry after re-election"})


class FrontDoor:
    """Threaded /generate endpoint, one per rank; ``start()`` returns
    the bound port.  Survives gang re-forms — the scheduler (and the
    handler threads parked on request Events) belong to the process,
    not to an engine incarnation.  ``scheduler`` is mutable: flipping it
    from None to a live Scheduler promotes the door from forwarding
    follower to admitting leader (and back is never needed — a demoted
    leader is a dead process).

    ``leader_addr_fn(refresh)``: returns the current leader's
    ``host:port`` or None; ``refresh=True`` asks for an authoritative
    re-read (the KV key) rather than the frame-cached value."""

    def __init__(self, scheduler: Optional[Scheduler], *,
                 host: str = "0.0.0.0", port: int = 0,
                 timeout_s: float = 120.0,
                 leader_addr_fn:
                 Optional[Callable[..., Optional[str]]] = None,
                 advertise_host: str = "127.0.0.1"):
        self.scheduler = scheduler
        self.timeout_s = timeout_s
        self._leader_addr_fn = leader_addr_fn
        self._advertise_host = advertise_host
        handler = type("_BoundHandler", (_Handler,), {"door": self})
        try:
            self._httpd = ThreadingHTTPServer((host, port), handler)
        except OSError:
            if port == 0:
                raise
            # Configured port taken (several ranks of one host): an
            # ephemeral port keeps the door up; the launcher/KV carries
            # the real address to clients.
            self._httpd = ThreadingHTTPServer((host, 0), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def leader_addr(self, refresh: bool = False) -> Optional[str]:
        if self._leader_addr_fn is None:
            return None
        return self._leader_addr_fn(refresh=refresh)

    def advertised_addr(self) -> str:
        return f"{self._advertise_host}:{self.port}"

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-serve-http",
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()
