"""Environment knobs: the port's copy of what it reads of
``horovod_tpu/utils/env.py`` (the same variable names, defaults and
floors)."""

from __future__ import annotations

import os

# The non-finite gradient guard (integrity/nonfinite.py).
NONFINITE_POLICY = "HVD_NONFINITE_POLICY"
NONFINITE_LIMIT = "HVD_NONFINITE_LIMIT"
# The replica-divergence audit's pace, in steps; 0 = off
# (integrity/audit.py).
AUDIT_INTERVAL = "HVD_AUDIT_INTERVAL"
# Verified checkpoints (utils/checkpoint.py): how many to keep, and the
# elastic membership epoch written into each manifest (and stamped on the
# KV client's elastic writes).
CKPT_KEEP = "HVD_CKPT_KEEP"
ELASTIC_EPOCH = "HVD_ELASTIC_EPOCH"
# The rendezvous KV client's retry policy (runner/http_client.py), and its
# ordered endpoint list "host:port,host:port" (primary first; unset = the
# single HVD_RENDEZVOUS_ADDR/PORT).
KV_RETRIES = "HVD_KV_RETRIES"
KV_TIMEOUT = "HVD_KV_TIMEOUT"
KV_RETRY_BASE_S = "HVD_KV_RETRY_BASE_S"
KV_RETRY_MAX_S = "HVD_KV_RETRY_MAX_S"
KV_ADDRS = "HVD_KV_ADDRS"
# Inference serving (serving/): the front door's port (0 = ephemeral), the
# continuous-batching decode slots, and the admission queue's bound (a full
# queue sheds with HTTP 503).
SERVE_PORT = "HVD_SERVE_PORT"
SERVE_MAX_BATCH = "HVD_SERVE_MAX_BATCH"
SERVE_MAX_QUEUE = "HVD_SERVE_MAX_QUEUE"


def get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def get_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def serve_port() -> int:
    """The serving front door's port; 0 (default) binds ephemeral."""
    return max(0, get_int(SERVE_PORT, 0))


def serve_max_batch() -> int:
    """Continuous-batching decode slots; floor 1."""
    return max(1, get_int(SERVE_MAX_BATCH, 8))


def serve_max_queue() -> int:
    """Admission queue bound (beyond it, /generate sheds with a 503);
    floor 1."""
    return max(1, get_int(SERVE_MAX_QUEUE, 64))
