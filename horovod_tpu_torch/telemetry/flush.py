"""Periodic metrics flusher, JSONL file and rendezvous KV publication: the
port of ``horovod_tpu/telemetry/flush.py``.

A daemon thread snapshots the registry every ``HVD_METRICS_INTERVAL``
seconds (default 10) and

- appends one JSON object per flush to ``HVD_METRICS_FILE`` (offline
  analysis: each line round-trips through ``json.loads``), and
- publishes the same snapshot to the rendezvous KV store under
  ``metrics/<rank>`` when a rendezvous server is in play
  (``HVD_RENDEZVOUS_ADDR``/``PORT``) — so the launcher host can read
  every rank's numbers from one place without reaching worker ports.

Flush failures are logged once per kind and never propagate: telemetry
must not take down training.  ``flush_once`` is the synchronous unit the
thread loops on, exposed for tests and for a final flush at stop.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional

from horovod_tpu_torch.telemetry import registry as _reg

log = logging.getLogger("horovod_tpu_torch.telemetry")


class Flusher:
    def __init__(self, rank: int, path: str = "",
                 interval_s: float = 10.0, kv=None,
                 scrape: str = "", epoch: int = 0):
        self.rank = rank
        self.path = path
        self.interval_s = max(0.1, interval_s)
        self.kv = kv  # KVClient or None
        # Stamped on every record: the rank's own debug-server address
        # (the gang aggregator's direct-scrape fallback when the KV
        # entry goes missing) and the elastic epoch (so the aggregator
        # rejects a pre-re-form incarnation's numbers as stale).
        self.scrape = scrape
        self.epoch = int(epoch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned = set()
        self._seq = 0

    def flush_once(self) -> Optional[dict]:
        snap = _reg.snapshot()
        if not snap:
            return None
        record = {"rank": self.rank, "seq": self._seq,
                  "epoch": self.epoch, **snap}
        if self.scrape:
            record["scrape"] = self.scrape
        self._seq += 1
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            except OSError as e:
                self._warn_once("file", f"{self.path}: {e}")
        if self.kv is not None:
            try:
                self.kv.put(f"metrics/{self.rank}", json.dumps(record))
            except Exception as e:
                self._warn_once("kv", str(e))
        return record

    def _warn_once(self, kind: str, detail: str) -> None:
        if kind not in self._warned:
            self._warned.add(kind)
            log.warning("metrics flush (%s) failing: %s", kind, detail)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush_once()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="hvd-metrics-flush", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.flush_once()  # final state always lands


def kv_from_env():
    """A KVClient for the job's rendezvous server, or ``None`` outside a
    launched job.  Imported lazily: the runner package pulls in config
    machinery workers don't otherwise need."""
    addr = os.environ.get("HVD_RENDEZVOUS_ADDR", "")
    port = os.environ.get("HVD_RENDEZVOUS_PORT", "")
    if not addr or not port:
        return None
    try:
        from horovod_tpu_torch.runner.http_client import KVClient

        return KVClient(addr, int(port))
    except Exception:
        return None
