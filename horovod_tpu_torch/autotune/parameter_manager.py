"""Autotuning parameter manager: the port of
``horovod_tpu/autotune/parameter_manager.py``.

Role parity: ``horovod/common/parameter_manager.cc/.h`` — the runtime
knobs of the coordination loop (tensor-fusion threshold, cycle time,
response-cache toggle) tuned online by Bayesian optimization, scored by
throughput (bytes per second of allreduced payload; the reference scores
bytes/µs).  Rank 0 owns the tuner; tuned values are broadcast to workers
in the response stream and applied before they take effect on any
coherence-relevant path (fusion of cached hits must use the same
threshold on every rank).

Knobs: fusion threshold, cycle time, cache on/off, and — on hierarchical
topologies (local_size>1 and cross_size>1) — the hierarchical
allreduce/allgather toggles, matching the reference's tunable set
(``parameter_manager.cc:44-60``).  One difference by design: categorical
dims ride the same GP with rounding instead of separate per-category
optimizers.

Explicitly set env knobs are *fixed* and excluded from tuning (parity:
``parameter_manager.h:60-78`` — fixed=true wins over tuning).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from horovod_tpu_torch.autotune.bayesian import BayesianOptimization
from horovod_tpu_torch.utils import env as env_util

_MAX_FUSION = 64 << 20  # tuning range upper bound, parity with reference
_MIN_CYCLE_S = 0.0005
_MAX_CYCLE_S = 0.025
# Ring-hop segment (docs/performance.md): 0 = unsegmented; tuned over
# 64 KiB steps up to 4 MiB — past that a segment no longer fits typical
# kernel socket buffers and the recv/reduce overlap disappears.
_MAX_SEGMENT = 4 << 20
_SEGMENT_STEP = 64 << 10


def autotune_options_from_env(hierarchical_ok: bool = False
                              ) -> Optional[dict]:
    """The single source of the autotune env policy, shared by the Python
    engine (ParameterManager.from_env) and the native engine (which ships
    these values through hvd_create).  None when tuning is off or every
    knob is env-pinned.  ``hierarchical_ok``: the hierarchy toggles are
    only tunable on a topology where they do anything."""
    if not env_util.get_bool(env_util.AUTOTUNE, False):
        return None
    opts = dict(
        tune_fusion=env_util.FUSION_THRESHOLD not in os.environ,
        tune_cycle=env_util.CYCLE_TIME not in os.environ,
        tune_cache=env_util.CACHE_CAPACITY not in os.environ,
        tune_hier_allreduce=(
            hierarchical_ok
            and env_util.HIERARCHICAL_ALLREDUCE not in os.environ),
        tune_hier_allgather=(
            hierarchical_ok
            and env_util.HIERARCHICAL_ALLGATHER not in os.environ),
        tune_segment=env_util.RING_SEGMENT_BYTES not in os.environ,
        warmup_samples=env_util.get_int(env_util.AUTOTUNE_WARMUP_SAMPLES, 3),
        max_samples=env_util.get_int(env_util.AUTOTUNE_MAX_SAMPLES, 20),
        sample_duration_s=env_util.get_float(
            env_util.AUTOTUNE_SAMPLE_DURATION, 0.5),
        log_path=env_util.get_str(env_util.AUTOTUNE_LOG) or None,
    )
    if not any(opts[k] for k in ("tune_fusion", "tune_cycle", "tune_cache",
                                 "tune_hier_allreduce",
                                 "tune_hier_allgather", "tune_segment")):
        return None
    return opts


@dataclass
class TunedParams:
    """The knob vector shipped coordinator → workers."""

    fusion_threshold: int
    cycle_time_s: float
    cache_enabled: bool
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    ring_segment_bytes: int = 0

    def __eq__(self, other) -> bool:
        return (self.fusion_threshold == other.fusion_threshold
                and abs(self.cycle_time_s - other.cycle_time_s) < 1e-9
                and self.cache_enabled == other.cache_enabled
                and self.hierarchical_allreduce
                == other.hierarchical_allreduce
                and self.hierarchical_allgather
                == other.hierarchical_allgather
                and self.ring_segment_bytes == other.ring_segment_bytes)


class ParameterManager:
    """Bayesian-optimization autotuner over the coordination knobs."""

    def __init__(self, initial: TunedParams, *,
                 tune_fusion: bool = True, tune_cycle: bool = True,
                 tune_cache: bool = True,
                 tune_hier_allreduce: bool = False,
                 tune_hier_allgather: bool = False,
                 tune_segment: bool = False,
                 warmup_samples: int = 3, max_samples: int = 20,
                 sample_duration_s: float = 0.5,
                 log_path: Optional[str] = None):
        self.current = initial
        self.initial = initial
        self.done = False
        self._dims = []
        if tune_fusion:
            self._dims.append("fusion")
        if tune_cycle:
            self._dims.append("cycle")
        if tune_cache:
            self._dims.append("cache")
        if tune_hier_allreduce:
            self._dims.append("hier_ar")
        if tune_hier_allgather:
            self._dims.append("hier_ag")
        if tune_segment:
            self._dims.append("segment")
        self._bo = BayesianOptimization(dim=max(1, len(self._dims)))
        self._warmup_left = warmup_samples
        self._max_samples = max_samples
        self._samples = 0
        self._bytes = 0
        self._sample_start: Optional[float] = None
        self._current_x = self._params_to_x(initial)
        self._sample_duration_s = sample_duration_s
        self._log = open(log_path, "w") if log_path else None
        if self._log:
            self._log.write(
                "sample,score_bytes_per_s,fusion_threshold,"
                "cycle_time_ms,cache_enabled,hierarchical_allreduce,"
                "hierarchical_allgather,ring_segment_bytes\n")

    @classmethod
    def from_env(cls, fusion_threshold: int, cycle_time_s: float,
                 hierarchical_allreduce: bool = False,
                 hierarchical_allgather: bool = False,
                 hierarchical_ok: bool = False,
                 ring_segment_bytes: int = 0
                 ) -> Optional["ParameterManager"]:
        """None unless HVD_AUTOTUNE is on.  Env-pinned knobs are fixed;
        if every knob is pinned there is nothing to tune."""
        opts = autotune_options_from_env(hierarchical_ok)
        if opts is None:
            return None
        return cls(TunedParams(fusion_threshold, cycle_time_s, True,
                               hierarchical_allreduce,
                               hierarchical_allgather,
                               ring_segment_bytes), **opts)

    # -- parameter vector mapping ----------------------------------------

    def _params_to_x(self, p: TunedParams) -> np.ndarray:
        x = []
        for d in self._dims:
            if d == "fusion":
                x.append(p.fusion_threshold / _MAX_FUSION)
            elif d == "cycle":
                x.append((p.cycle_time_s - _MIN_CYCLE_S) /
                         (_MAX_CYCLE_S - _MIN_CYCLE_S))
            elif d == "hier_ar":
                x.append(1.0 if p.hierarchical_allreduce else 0.0)
            elif d == "hier_ag":
                x.append(1.0 if p.hierarchical_allgather else 0.0)
            elif d == "segment":
                x.append(p.ring_segment_bytes / _MAX_SEGMENT)
            else:
                x.append(1.0 if p.cache_enabled else 0.0)
        return np.asarray(x or [0.0], np.float64)

    def _x_to_params(self, x: np.ndarray) -> TunedParams:
        p = TunedParams(self.current.fusion_threshold,
                        self.current.cycle_time_s,
                        self.current.cache_enabled,
                        self.current.hierarchical_allreduce,
                        self.current.hierarchical_allgather,
                        self.current.ring_segment_bytes)
        for i, d in enumerate(self._dims):
            v = float(np.clip(x[i], 0.0, 1.0))
            if d == "fusion":
                # snap to 1 MiB steps, like the reference's discretization
                p.fusion_threshold = int(round(v * _MAX_FUSION /
                                               (1 << 20))) << 20
            elif d == "cycle":
                p.cycle_time_s = _MIN_CYCLE_S + v * (_MAX_CYCLE_S -
                                                     _MIN_CYCLE_S)
            elif d == "hier_ar":
                p.hierarchical_allreduce = v >= 0.5
            elif d == "hier_ag":
                p.hierarchical_allgather = v >= 0.5
            elif d == "segment":
                # snap to 64 KiB steps; the bottom step rounds to 0 = off
                p.ring_segment_bytes = int(
                    round(v * _MAX_SEGMENT / _SEGMENT_STEP)) * _SEGMENT_STEP
            else:
                p.cache_enabled = v >= 0.5
        return p

    # -- scoring loop -----------------------------------------------------

    def record_bytes(self, nbytes: int, now: Optional[float] = None
                     ) -> Optional[TunedParams]:
        """Feed allreduced payload bytes; returns new params to apply+
        broadcast when a tuning step fires, else None.
        Parity: ParameterManager::Update (parameter_manager.cc:89-181)."""
        if self.done:
            return None
        now = time.monotonic() if now is None else now
        if self._sample_start is None:
            self._sample_start = now
        self._bytes += nbytes
        elapsed = now - self._sample_start
        if elapsed > 5 * self._sample_duration_s:
            # Idle gap (eval, checkpointing, …): the window no longer
            # measures the knobs, it measures the pause — discard it
            # rather than attribute a near-zero score to the incumbent.
            self._bytes = nbytes
            self._sample_start = now
            return None
        if elapsed < self._sample_duration_s or self._bytes <= 0:
            return None

        score = self._bytes / elapsed
        self._bytes = 0
        self._sample_start = now

        if self._warmup_left > 0:
            self._warmup_left -= 1
            return None

        self._samples += 1
        self._bo.add_sample(self._current_x, score)
        if self._log:
            self._log.write(
                f"{self._samples},{score:.1f},"
                f"{self.current.fusion_threshold},"
                f"{self.current.cycle_time_s * 1e3:.3f},"
                f"{int(self.current.cache_enabled)},"
                f"{int(self.current.hierarchical_allreduce)},"
                f"{int(self.current.hierarchical_allgather)},"
                f"{self.current.ring_segment_bytes}\n")
            self._log.flush()

        if self._samples >= self._max_samples:
            # settle on the best observed configuration
            best = self._bo.best()
            self.current = self._x_to_params(best)
            self.done = True
            if self._log:
                self._log.write(
                    f"final,,{self.current.fusion_threshold},"
                    f"{self.current.cycle_time_s * 1e3:.3f},"
                    f"{int(self.current.cache_enabled)},"
                    f"{int(self.current.hierarchical_allreduce)},"
                    f"{int(self.current.hierarchical_allgather)},"
                    f"{self.current.ring_segment_bytes}\n")
                self._log.close()
                self._log = None
            return self.current

        self._current_x = self._bo.next_sample()
        self.current = self._x_to_params(self._current_x)
        return self.current
