"""Per-rank metrics debug server: the port of
``horovod_tpu/telemetry/server.py``.

``GET /metrics`` returns the Prometheus text exposition of this worker's
registry; ``GET /metrics.json`` the JSON snapshot; ``GET /health`` is an
open liveness probe — the same trio of concerns as the rendezvous server
(runner/http_server.py), and the same ThreadingHTTPServer shape.

Each worker binds ``HVD_METRICS_PORT + local_rank`` so co-located
workers on one host don't collide; a failed bind logs a warning and the
job runs on (observability must never take down training).  The chaos
site ``metrics.server.request`` turns a request into a 503 shed,
mirroring ``kv.server.request``, so scrapers' retry behavior is testable
(tests/test_torch_telemetry.py).
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.telemetry import registry as _reg

log = logging.getLogger("horovod_tpu_torch.telemetry")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _chaos_unavailable(self) -> bool:
        try:
            _fi.fire("metrics.server.request", f"{self.command} {self.path}")
        except _fi.InjectedFault:
            self.send_response(503)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return True
        return False

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self._chaos_unavailable():
            return
        if self.path == "/health":
            self._send(200, b"ok", "text/plain")
            return
        if self.path == "/metrics":
            body = _reg.render_prometheus().encode("utf-8")
            self._send(200, body,
                       "text/plain; version=0.0.4; charset=utf-8")
            return
        if self.path == "/metrics.json":
            import json

            body = json.dumps(_reg.snapshot()).encode("utf-8")
            self._send(200, body, "application/json")
            return
        if self.path == "/debug/blackbox":
            # Live flight-recorder peek: the current ring as bounded
            # JSON (the ring is capacity-capped, so the body is too) —
            # a wedged-but-alive rank can be inspected without killing
            # it.  The handler thread stays responsive even while the
            # engine's background thread hangs in the data plane.
            import json

            from horovod_tpu_torch.telemetry import blackbox as _bb

            bb = _bb.get()
            if bb is None:
                self._send(404, b'{"error": "blackbox disabled"}',
                           "application/json")
                return
            doc = bb.snapshot()
            doc["role"] = "coordinator" if bb.rank == 0 else "worker"
            body = json.dumps(doc).encode("utf-8")
            self._send(200, body, "application/json")
            return
        if self.path in ("/gang/metrics", "/gang/metrics.json",
                         "/gang/health"):
            # Gang-wide view: the live aggregator's latest fold (rank 0
            # only — other ranks run no aggregator and answer 404).
            import json

            from horovod_tpu_torch.telemetry import aggregate as _agg

            agg = _agg.get()
            if agg is None:
                self._send(404, b'{"error": "no gang aggregator"}',
                           "application/json")
                return
            if self.path == "/gang/metrics":
                self._send(200, agg.render().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/gang/metrics.json":
                self._send(200, json.dumps(agg.view()).encode("utf-8"),
                           "application/json")
            else:
                self._send(200, json.dumps(agg.health()).encode("utf-8"),
                           "application/json")
            return
        self._send(404, b"", "text/plain")


class MetricsServer:
    """Threaded scrape endpoint; ``start()`` returns the bound port."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-metrics",
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()


def maybe_start(port: int, local_rank: int) -> Optional[MetricsServer]:
    """Bind ``port + local_rank`` and serve; on failure warn and return
    ``None`` — a taken port must not kill the worker."""
    try:
        srv = MetricsServer(port=port + local_rank)
        srv.start()
        return srv
    except OSError as e:
        log.warning("metrics server: could not bind port %d (%s); "
                    "scrape endpoint disabled for this worker",
                    port + local_rank, e)
        return None
