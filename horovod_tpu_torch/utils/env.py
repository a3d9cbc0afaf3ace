"""Environment knobs: the port's copy of what it reads of
``horovod_tpu/utils/env.py`` (the same variable names, defaults and
floors)."""

from __future__ import annotations

import os

# The launcher's rendezvous (the KV server the eager engine bootstraps
# through) and the engine's startup budget.
RENDEZVOUS_ADDR = "HVD_RENDEZVOUS_ADDR"
RENDEZVOUS_PORT = "HVD_RENDEZVOUS_PORT"
START_TIMEOUT = "HVD_START_TIMEOUT"
RDV_SCOPE = "HVD_RDV_SCOPE"
NIC = "HVD_NIC"
# The eager engine (runtime_py.py): fusion threshold in bytes, background
# cycle in ms, response-cache entries, the ring hop's receive segment
# (0 = whole chunks), socket buffer sizes (0 = the kernel's), and the
# stall inspector.
FUSION_THRESHOLD = "HVD_FUSION_THRESHOLD"
CYCLE_TIME = "HVD_CYCLE_TIME"
CACHE_CAPACITY = "HVD_CACHE_CAPACITY"
RING_SEGMENT_BYTES = "HVD_RING_SEGMENT_BYTES"
SOCK_BUF_BYTES = "HVD_SOCK_BUF_BYTES"
SEND_WAIT_CAP_S = "HVD_SEND_WAIT_CAP_S"
STALL_CHECK_DISABLE = "HVD_STALL_CHECK_DISABLE"
STALL_CHECK_TIME = "HVD_STALL_CHECK_TIME_SECONDS"
STALL_SHUTDOWN_TIME = "HVD_STALL_SHUTDOWN_TIME_SECONDS"
# The two-level data plane (ops/cpu_backend.py): a node-local ring, a
# cross-node ring over the owned slice, and a node-local allgather.
# Effective only at a block topology (runtime_py.hierarchical_topology_ok).
HIERARCHICAL_ALLREDUCE = "HVD_HIERARCHICAL_ALLREDUCE"
HIERARCHICAL_ALLGATHER = "HVD_HIERARCHICAL_ALLGATHER"
# The Chrome-tracing timeline (utils/timeline.py): the file rank 0
# writes, and a CYCLE_START instant per background cycle.
TIMELINE = "HVD_TIMELINE"
TIMELINE_MARK_CYCLES = "HVD_TIMELINE_MARK_CYCLES"
# The same-host shm transport (utils/transport.py).  SHM_DISABLE forces
# every peer link onto TCP; SLOT_BYTES and SLOTS size each directed ring
# (per peer pair: two rings of SLOTS slots of SLOT_BYTES payload each,
# floors 4096 bytes and 2 slots); SPIN is the hot-spin count before a
# wait starts yielding, SLEEP_US the ceiling of its micro-sleeps.
SHM_DISABLE = "HVD_SHM_DISABLE"
SHM_SLOT_BYTES = "HVD_SHM_SLOT_BYTES"
SHM_SLOTS = "HVD_SHM_SLOTS"
SHM_SPIN = "HVD_SHM_SPIN"
SHM_SLEEP_US = "HVD_SHM_SLEEP_US"
# The recovery ladder (utils/ladder.py).  WIRE_CRC=1 arms it: every data
# frame gains a CRC-32 and sequence trailer, a corrupt frame is NACKed and
# retransmitted (at most HOP_RETRIES times in a row a link), a dropped data
# socket is re-dialed for up to RECONNECT_TIMEOUT_S, and a faulted shm
# ring demotes its pair to TCP in place.  LADDER_RETAIN bounds each link's
# replay buffer, in frames.  Off (default): the plain framing, no new
# threads.
WIRE_CRC = "HVD_WIRE_CRC"
HOP_RETRIES = "HVD_HOP_RETRIES"
RECONNECT_TIMEOUT_S = "HVD_RECONNECT_TIMEOUT_S"
LADDER_RETAIN = "HVD_LADDER_RETAIN"

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


def get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def get_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def fusion_threshold_bytes() -> int:
    """Default 64 MiB, like the reference."""
    return get_int(FUSION_THRESHOLD, 64 * 1024 * 1024)


def cycle_time_ms() -> float:
    """The background loop's cadence; default 5 ms."""
    return get_float(CYCLE_TIME, 5.0)


def ring_segment_bytes() -> int:
    """Ring-hop receive segment; 0 (default) disables segmentation."""
    return max(0, get_int(RING_SEGMENT_BYTES, 0))


def shm_disabled() -> bool:
    """True when the same-host shm transport is forced off: every peer
    link is TCP."""
    return get_bool(SHM_DISABLE, False)


def shm_slot_bytes() -> int:
    """Payload bytes per shm ring slot; floor 4096."""
    return max(4096, get_int(SHM_SLOT_BYTES, 256 * 1024))


def shm_slots() -> int:
    """Slots per directed shm ring; floor 2 (the writer fills one while
    the reader drains another)."""
    return max(2, get_int(SHM_SLOTS, 16))


def shm_spin() -> int:
    """Hot-spin iterations before a shm wait starts yielding: 64 where a
    spare core can run the peer meanwhile, 0 on a single core."""
    cpus = os.cpu_count() or 1
    return max(0, get_int(SHM_SPIN, 64 if cpus > 1 else 0))


def shm_sleep_us() -> int:
    """Ceiling of a shm wait's escalating micro-sleeps, in microseconds;
    default 200, floor 10."""
    return max(10, get_int(SHM_SLEEP_US, 200))


def wire_crc() -> bool:
    """True when the recovery ladder is armed (default off)."""
    return get_bool(WIRE_CRC, False)


def hop_retries() -> int:
    """A link's NACK-retransmit budget (consecutive failures) before it
    is declared corrupt; floor 0."""
    return max(0, get_int(HOP_RETRIES, 8))


def reconnect_timeout_s() -> float:
    """How long one dropped data socket may take to re-dial or
    re-accept; floor 0.1 s."""
    return max(0.1, get_float(RECONNECT_TIMEOUT_S, 20.0))


def ladder_retain() -> int:
    """Retained sent frames per link (the replay buffer); floor 2."""
    return max(2, get_int(LADDER_RETAIN, 32))


def send_wait_cap_s() -> float:
    """Hard cap on any one wait for a send to leave, always on, so that a
    dead sender thread never hangs a hop silently."""
    return get_float(SEND_WAIT_CAP_S, 300.0)


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
