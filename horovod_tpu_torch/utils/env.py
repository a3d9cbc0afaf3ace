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
# Liveness (runtime_py.py): a worker silent past HEARTBEAT_TIMEOUT seconds
# is evicted (0 = off; HOROVOD_HEARTBEAT_TIMEOUT is its alias), and an idle
# worker proves it is alive every HEARTBEAT_INTERVAL seconds.
HEARTBEAT_TIMEOUT = "HVD_HEARTBEAT_TIMEOUT"
HEARTBEAT_INTERVAL = "HVD_HEARTBEAT_INTERVAL"
# Collective deadlines (ops/cpu_backend.py, runtime_py.py): every eager
# collective's hops get COLLECTIVE_TIMEOUT seconds (0 = off: they block),
# and a local timeout starts the gang-wide abort agreement, whose probe
# round waits COLLECTIVE_PROBE_TIMEOUT seconds for acks.
COLLECTIVE_TIMEOUT = "HVD_COLLECTIVE_TIMEOUT"
COLLECTIVE_PROBE_TIMEOUT = "HVD_COLLECTIVE_PROBE_TIMEOUT"
# The control tree (runtime_py.py): on a multi-host block topology the
# lowest local rank of each host but the root's folds its host's control
# frames (CTRL_TREE, default on); CTRL_FANOUT caps its children (0 = the
# whole host; the rest talk to the root directly).
CTRL_TREE = "HVD_CTRL_TREE"
CTRL_FANOUT = "HVD_CTRL_FANOUT"

# The non-finite gradient guard (integrity/nonfinite.py).
NONFINITE_POLICY = "HVD_NONFINITE_POLICY"
NONFINITE_LIMIT = "HVD_NONFINITE_LIMIT"
# The replica-divergence audit's pace, in steps; 0 = off
# (integrity/audit.py).
AUDIT_INTERVAL = "HVD_AUDIT_INTERVAL"
# Verified checkpoints (utils/checkpoint.py): how many to keep.
CKPT_KEEP = "HVD_CKPT_KEEP"
# Elastic training (elastic/).  EPOCH is the gang's membership incarnation
# (stamped on every wire list frame, written into each checkpoint manifest
# and on the KV client's elastic writes); MIN_NP/MAX_NP bound the re-formed
# world; JOINER marks a late worker that waits for an epoch assignment
# instead of bootstrapping at rank 0; UID is a stable worker identity
# across incarnations; the two intervals pace the commit-time membership
# check and the discovery driver's poll.  HOST_DISCOVERY_SCRIPT prints one
# ``hostname[:slots]`` a line.  QUORUM gates a re-form on a strict majority
# of the last-committed roster (default on): a partition's minority stops
# with PARTITION_MINORITY instead of re-forming a split-brain sibling gang.
ELASTIC_EPOCH = "HVD_ELASTIC_EPOCH"
ELASTIC_MIN_NP = "HVD_ELASTIC_MIN_NP"
ELASTIC_MAX_NP = "HVD_ELASTIC_MAX_NP"
ELASTIC_JOINER = "HVD_ELASTIC_JOINER"
ELASTIC_UID = "HVD_ELASTIC_UID"
ELASTIC_CHECK_INTERVAL_S = "HVD_ELASTIC_CHECK_INTERVAL_S"
ELASTIC_DISCOVERY_INTERVAL_S = "HVD_ELASTIC_DISCOVERY_INTERVAL_S"
HOST_DISCOVERY_SCRIPT = "HVD_HOST_DISCOVERY_SCRIPT"
QUORUM = "HVD_QUORUM"
# The rendezvous KV client's retry policy (runner/http_client.py), and its
# ordered endpoint list "host:port,host:port" (primary first; unset = the
# single HVD_RENDEZVOUS_ADDR/PORT).
KV_RETRIES = "HVD_KV_RETRIES"
KV_TIMEOUT = "HVD_KV_TIMEOUT"
KV_RETRY_BASE_S = "HVD_KV_RETRY_BASE_S"
KV_RETRY_MAX_S = "HVD_KV_RETRY_MAX_S"
KV_ADDRS = "HVD_KV_ADDRS"
# The launcher's host blacklist (hvdrun --max-restarts and elastic jobs): a
# host whose workers failed THRESHOLD times inside COOLDOWN_S is skipped on
# a relaunch.
BLACKLIST_THRESHOLD = "HVD_BLACKLIST_THRESHOLD"
BLACKLIST_COOLDOWN_S = "HVD_BLACKLIST_COOLDOWN_S"
# hvdrun --adasum-mode, passed through to the workers for the JAX
# launcher's flags; nothing in the port reads it (its Adasum has one mode).
ADASUM_MODE = "HVD_ADASUM_MODE"
# Inference serving (serving/): the front door's port (0 = ephemeral), the
# continuous-batching decode slots, and the admission queue's bound (a full
# queue sheds with HTTP 503).
SERVE_PORT = "HVD_SERVE_PORT"
SERVE_MAX_BATCH = "HVD_SERVE_MAX_BATCH"
SERVE_MAX_QUEUE = "HVD_SERVE_MAX_QUEUE"
# The autotuner (autotune/): rank 0 tunes the engine's knobs by Bayesian
# optimization, scored by allreduced bytes a second, and broadcasts them in
# the response list.  A knob pinned in the environment is not tuned.  LOG
# is the CSV of samples; WARMUP_SAMPLES are discarded, MAX_SAMPLES scored
# before it settles, each over SAMPLE_DURATION_SECONDS.
AUTOTUNE = "HVD_AUTOTUNE"
AUTOTUNE_LOG = "HVD_AUTOTUNE_LOG"
AUTOTUNE_WARMUP_SAMPLES = "HVD_AUTOTUNE_WARMUP_SAMPLES"
AUTOTUNE_MAX_SAMPLES = "HVD_AUTOTUNE_MAX_SAMPLES"
AUTOTUNE_SAMPLE_DURATION = "HVD_AUTOTUNE_SAMPLE_DURATION_SECONDS"
# Telemetry (telemetry/).  METRICS turns the registry on by itself; a PORT
# or FILE turns it on too.  PORT is the per-rank debug server's base port
# (bound at PORT + local_rank; 0 binds an ephemeral one), FILE the JSONL
# flush destination, written every INTERVAL seconds; STRAGGLER_WARN_MS is
# the consistent-last-rank skew past which the coordinator writes a
# STRAGGLER record.
METRICS = "HVD_METRICS"
METRICS_PORT = "HVD_METRICS_PORT"
METRICS_FILE = "HVD_METRICS_FILE"
METRICS_INTERVAL = "HVD_METRICS_INTERVAL"
STRAGGLER_WARN_MS = "HVD_STRAGGLER_WARN_MS"
# The gang fold and its alerts (telemetry/aggregate.py): AGG_INTERVAL paces
# rank 0's fold of every rank's snapshot; the ALERT knobs tune the EWMA
# rules: the baseline's smoothing, the folds before a rule may fire, the
# throughput fraction that is a collapse, the straggler skew's growth
# multiple and floor, the growth multiples of the queue depth and of the
# retry rate, and the serving p99 ceiling in ms (0 = off).
AGG_INTERVAL = "HVD_AGG_INTERVAL"
ALERT_EWMA_ALPHA = "HVD_ALERT_EWMA_ALPHA"
ALERT_WARMUP = "HVD_ALERT_WARMUP"
ALERT_COLLAPSE_FRAC = "HVD_ALERT_COLLAPSE_FRAC"
ALERT_SKEW_FACTOR = "HVD_ALERT_SKEW_FACTOR"
ALERT_SKEW_FLOOR_MS = "HVD_ALERT_SKEW_FLOOR_MS"
ALERT_QUEUE_FACTOR = "HVD_ALERT_QUEUE_FACTOR"
ALERT_RETRY_FACTOR = "HVD_ALERT_RETRY_FACTOR"
ALERT_SERVE_P99_MS = "HVD_ALERT_SERVE_P99_MS"
# The gang-wide trace (telemetry/trace.py): TRACE=1 makes every rank write
# its spans to ``trace_rank<r>.jsonl`` under TRACE_DIR (default the working
# directory); a worker pings the coordinator's clock at its first cycle and
# every TRACE_CLOCK_SYNC_CYCLES cycles after.
TRACE = "HVD_TRACE"
TRACE_DIR = "HVD_TRACE_DIR"
TRACE_CLOCK_SYNC_CYCLES = "HVD_TRACE_CLOCK_SYNC_CYCLES"
# The flight recorder (telemetry/blackbox.py), on by default: each rank
# keeps its last BLACKBOX_EVENTS events and dumps ``blackbox_rank<r>.json``
# into BLACKBOX_DIR at a terminal failure; BLACKBOX=0 turns it off.
BLACKBOX = "HVD_BLACKBOX"
BLACKBOX_EVENTS = "HVD_BLACKBOX_EVENTS"
BLACKBOX_DIR = "HVD_BLACKBOX_DIR"


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


def heartbeat_timeout_s() -> float:
    """Seconds of silence after which the coordinator evicts a worker; 0
    (default) turns liveness off.  ``HOROVOD_HEARTBEAT_TIMEOUT`` is read
    when ``HVD_HEARTBEAT_TIMEOUT`` is unset."""
    return get_float(HEARTBEAT_TIMEOUT,
                     get_float("HOROVOD_HEARTBEAT_TIMEOUT", 0.0))


def heartbeat_interval_s(timeout: float) -> float:
    """An idle worker's heartbeat cadence; default max(0.05, timeout / 4)."""
    return get_float(HEARTBEAT_INTERVAL, max(0.05, timeout / 4.0))


def collective_timeout_s() -> float:
    """Per-collective deadline in seconds; 0 (default) = no deadline."""
    return max(0.0, get_float(COLLECTIVE_TIMEOUT, 0.0))


def collective_probe_timeout_s(timeout: float) -> float:
    """The abort agreement's probe window; default max(0.5, timeout / 2)."""
    return get_float(COLLECTIVE_PROBE_TIMEOUT, max(0.5, timeout / 2.0))


def ctrl_fanout() -> int:
    """Children a sub-coordinator folds; 0 (default) = its whole host."""
    return max(0, get_int(CTRL_FANOUT, 0))


def ctrl_tree_on() -> bool:
    """The control tree's switch (default on)."""
    return get_bool(CTRL_TREE, True)


def quorum_on() -> bool:
    """The elastic re-form's majority gate (default on)."""
    return get_bool(QUORUM, True)


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


def trace_enabled() -> bool:
    """True when the gang-wide trace is on: every rank writes spans."""
    return get_bool(TRACE, False)


def trace_dir() -> str:
    """Directory of the per-rank ``trace_rank<r>.jsonl`` span files."""
    return get_str(TRACE_DIR, ".") or "."


def trace_clock_sync_cycles() -> int:
    """A worker's clock-ping cadence in background cycles (floor 1); the
    first ping goes out on the first cycle."""
    return max(1, get_int(TRACE_CLOCK_SYNC_CYCLES, 200))


def blackbox_enabled() -> bool:
    """True unless HVD_BLACKBOX=0: the flight recorder is always on."""
    return get_bool(BLACKBOX, True)


def blackbox_events() -> int:
    """The recorder's ring capacity in events; floor 16."""
    return max(16, get_int(BLACKBOX_EVENTS, 512))


def blackbox_dir() -> str:
    """Directory the ``blackbox_rank<r>.json`` dumps land in."""
    return get_str(BLACKBOX_DIR, "hvd_blackbox") or "hvd_blackbox"


def agg_interval_s() -> float:
    """The gang fold's cadence on rank 0; floor 0.05 s."""
    return max(0.05, get_float(AGG_INTERVAL, 2.0))


def alert_ewma_alpha() -> float:
    """The baselines' EWMA smoothing factor, clamped to [0.01, 1]."""
    return min(1.0, max(0.01, get_float(ALERT_EWMA_ALPHA, 0.3)))


def alert_warmup() -> int:
    """Folds a rule's baseline observes before it may fire; floor 1."""
    return max(1, get_int(ALERT_WARMUP, 3))


def alert_collapse_frac() -> float:
    """throughput_collapse fires below this fraction of the baseline;
    clamped to [0.01, 0.99]."""
    return min(0.99, max(0.01, get_float(ALERT_COLLAPSE_FRAC, 0.5)))


def alert_skew_factor() -> float:
    """straggler_skew's growth multiple over a rank's baseline; floor 1."""
    return max(1.0, get_float(ALERT_SKEW_FACTOR, 3.0))


def alert_skew_floor_ms() -> float:
    """The straggler skew below which growth never fires, in ms."""
    return max(0.0, get_float(ALERT_SKEW_FLOOR_MS, 50.0))


def alert_queue_factor() -> float:
    """queue_growth's multiple over the queue-depth baseline; floor 1."""
    return max(1.0, get_float(ALERT_QUEUE_FACTOR, 3.0))


def alert_retry_factor() -> float:
    """retry_spike's multiple over the retries-a-fold baseline; floor 1."""
    return max(1.0, get_float(ALERT_RETRY_FACTOR, 3.0))


def alert_serve_p99_ms() -> float:
    """serve_p99_breach's ceiling on the decode step's p99, in ms; 0
    (default) turns the rule off."""
    return max(0.0, get_float(ALERT_SERVE_P99_MS, 0.0))
