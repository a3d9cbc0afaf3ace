"""horovod_tpu_torch.telemetry: the port of ``horovod_tpu.telemetry``, the
unified metrics of the eager engine.

One registry (``registry.KNOWN_METRICS``) instruments the engine's
coordination cycles, eager/bridge collectives, the response cache, and
the robustness layers (heartbeats, KV retries, elastic, integrity); on
top of it sit a per-worker Prometheus ``/metrics`` debug server, a JSONL
flusher with rendezvous KV publication, and a straggler detector.  See
docs/metrics.md for the metric table, endpoint protocol, and knobs.

Lifecycle: the engines call ``init_from_env`` at construction;
``basics.shutdown`` calls ``stop``.  ``stop`` tears down the server and
flusher but keeps the registry counting — an elastic re-form
re-initializes the engine in the same process and the counters must
span it.  ``reset`` (tests) drops everything.

The elastic series: the engine sets ``hvd_elastic_epoch`` at each
incarnation; ``elastic/run.py`` counts ``hvd_elastic_reforms_total`` and
``hvd_leader_failovers_total``; the coordinator's control-frame fence and
the rendezvous server's 409 count ``hvd_fenced_writes_total``.

Enablement: ``HVD_METRICS`` truthy, or either ``HVD_METRICS_PORT`` /
``HVD_METRICS_FILE`` set.  When none are, the instrumentation hooks are
a single global load + None check (pinned by tests/test_torch_telemetry.py).
"""

from __future__ import annotations

import threading
from typing import Optional

from horovod_tpu_torch.telemetry import aggregate as _agg_mod
from horovod_tpu_torch.telemetry import flush as _flush_mod
from horovod_tpu_torch.telemetry import registry
from horovod_tpu_torch.telemetry import server as _server_mod
from horovod_tpu_torch.telemetry.registry import (  # noqa: F401
    KNOWN_METRICS,
    enabled,
    histogram_quantile,
    inc_counter,
    known_metrics,
    observe,
    quantile,
    render_prometheus,
    set_gauge,
    snapshot,
)
from horovod_tpu_torch.telemetry.straggler import StragglerDetector  # noqa: F401
from horovod_tpu_torch.utils import env as env_util

_lock = threading.Lock()
_server: Optional[_server_mod.MetricsServer] = None
_flusher: Optional[_flush_mod.Flusher] = None


def enabled_in_env() -> bool:
    return (env_util.get_bool(env_util.METRICS)
            or bool(env_util.get_str(env_util.METRICS_PORT))
            or bool(env_util.get_str(env_util.METRICS_FILE)))


def init_from_env(rank: int, local_rank: int = 0, size: int = 1) -> bool:
    """Engine-construction hook: turn the registry on and start the
    debug server / flusher per the env — plus, on rank 0, the gang
    aggregator that folds every rank's snapshot into the single gang
    view (``/gang/metrics*``).  Idempotent — an elastic re-form
    re-enters here with the server already up."""
    global _server, _flusher
    if not enabled_in_env():
        return False
    registry.configure(True)
    with _lock:
        if _server is None:
            port = env_util.get_int(env_util.METRICS_PORT, 0)
            if port > 0:
                _server = _server_mod.maybe_start(port, local_rank)
        kv = _flush_mod.kv_from_env()
        if _flusher is None:
            path = env_util.get_str(env_util.METRICS_FILE)
            interval = env_util.get_float(env_util.METRICS_INTERVAL, 10.0)
            if path or kv is not None:
                scrape = ""
                if _server is not None:
                    scrape = f"127.0.0.1:{_server.port}"
                _flusher = _flush_mod.Flusher(
                    rank, path=path, interval_s=interval, kv=kv,
                    scrape=scrape,
                    epoch=env_util.get_int(env_util.ELASTIC_EPOCH, 0))
                _flusher.start()
        if rank == 0 and size > 1 and kv is not None:
            _agg_mod.start_from_env(size, kv=kv)
    return True


def stop() -> None:
    """Stop the server and flusher (final flush included); the registry
    keeps its series — see module docstring."""
    global _server, _flusher
    with _lock:
        srv, fl = _server, _flusher
        _server, _flusher = None, None
    _agg_mod.stop()
    if fl is not None:
        fl.stop()
    if srv is not None:
        srv.stop()


def reset() -> None:
    """Test helper: full teardown, registry included."""
    stop()
    registry.configure(False)


def server_port() -> Optional[int]:
    srv = _server
    return srv.port if srv is not None else None
