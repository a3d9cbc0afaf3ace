"""The launcher's flags and YAML config file as ``HVD_*`` variables: the
port of ``horovod_tpu/runner/config_parser.py``.

Three layers, later ones winning: the environment, the YAML file
(``--config-file``), the command line's flags.  The variable names are
``utils/env.py``'s, the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

from horovod_tpu_torch.utils import env as E

# argparse dest -> env var
_ARG_ENV = {
    "fusion_threshold_mb": E.FUSION_THRESHOLD,
    "cycle_time_ms": E.CYCLE_TIME,
    "cache_capacity": E.CACHE_CAPACITY,
    "hierarchical_allreduce": E.HIERARCHICAL_ALLREDUCE,
    "hierarchical_allgather": E.HIERARCHICAL_ALLGATHER,
    "ring_segment_bytes": E.RING_SEGMENT_BYTES,
    "sock_buf_bytes": E.SOCK_BUF_BYTES,
    "ctrl_fanout": E.CTRL_FANOUT,
    "collective_timeout": E.COLLECTIVE_TIMEOUT,
    "no_shm": E.SHM_DISABLE,
    "shm_slot_bytes": E.SHM_SLOT_BYTES,
    "shm_slots": E.SHM_SLOTS,
    "timeline_filename": E.TIMELINE,
    "timeline_mark_cycles": E.TIMELINE_MARK_CYCLES,
    "no_stall_check": E.STALL_CHECK_DISABLE,
    "stall_warning_time_seconds": E.STALL_CHECK_TIME,
    "stall_shutdown_time_seconds": E.STALL_SHUTDOWN_TIME,
    "autotune": E.AUTOTUNE,
    "autotune_log_file": E.AUTOTUNE_LOG,
    "adasum_mode": E.ADASUM_MODE,
    "log_level": "HVD_LOG_LEVEL",
    "min_np": E.ELASTIC_MIN_NP,
    "max_np": E.ELASTIC_MAX_NP,
    "host_discovery_script": E.HOST_DISCOVERY_SCRIPT,
    "metrics_port": E.METRICS_PORT,
    "serve_port": E.SERVE_PORT,
    "serve_max_batch": E.SERVE_MAX_BATCH,
    "serve_max_queue": E.SERVE_MAX_QUEUE,
    "kv_addrs": E.KV_ADDRS,
}

_MB = {"fusion_threshold_mb"}
_BOOL = {"hierarchical_allreduce", "hierarchical_allgather",
         "timeline_mark_cycles", "no_stall_check", "autotune", "no_shm"}


def _convert(dest: str, v) -> Optional[str]:
    """One flag value as its variable's string; None when the flag was not
    set.  A legitimate 0 (``--cache-capacity 0``) survives."""
    if v is None or v is False:
        return None
    if dest in _BOOL:
        # YAML may spell booleans as 0/1/"false"/"true"; only truthy
        # values enable the feature (argparse store_true always passes
        # the literal True here).
        if isinstance(v, str):
            v = v.strip().lower() not in ("", "0", "false", "no", "off")
        if not v:
            return None
        return "1"
    if dest in _MB:
        return str(int(float(v) * 1024 * 1024))
    return str(v)


def env_from_args(args) -> Dict[str, str]:
    """Collect env assignments from parsed argparse flags (only flags the
    user actually set — unset flags are skipped so they don't override the
    YAML/env layers)."""
    out: Dict[str, str] = {}
    for dest, env_name in _ARG_ENV.items():
        s = _convert(dest, getattr(args, dest, None))
        if s is not None:
            out[env_name] = s
    # --disable-cache is the command line's spelling of cache capacity 0.
    if getattr(args, "disable_cache", False):
        out[E.CACHE_CAPACITY] = "0"
    return out


def env_from_config_file(path: str) -> Dict[str, str]:
    """YAML config: top-level keys are the argparse dests (dashes or
    underscores), e.g. ``fusion-threshold-mb: 32``."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    out: Dict[str, str] = {}
    for key, v in cfg.items():
        dest = key.replace("-", "_")
        env_name = _ARG_ENV.get(dest)
        if env_name is None:
            raise ValueError(f"unknown config key {key!r}")
        s = _convert(dest, v)
        if s is not None:
            out[env_name] = s
    return out
