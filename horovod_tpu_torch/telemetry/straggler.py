"""Straggler detection from negotiation ready ticks: the port of
``horovod_tpu/telemetry/straggler.py``.

The coordinator already sees every rank's readiness for every tensor
(``runtime_py._coordinator_cycle`` absorbs one request per rank per
tensor).  This detector folds those ticks into a per-negotiation skew —
last rank ready minus first rank ready — observed into the
``hvd_straggler_skew_seconds`` histogram labeled by the *last* rank.

A rank that is merely last once is noise (someone is always last); a
straggler is a rank that is **consistently** last by a material margin.
The detector flags one when the same rank has been last for
``streak_needed`` consecutive completed negotiations with skew above
``warn_ms`` (``HVD_STRAGGLER_WARN_MS``).  The engine turns the flag into
a ``STRAGGLER`` timeline record plus a throttled warning;
``hvd_straggler_events_total{rank=...}`` counts the emissions.

Coordinator-only and engine-thread-only, so no locking; the registry
hooks it calls are themselves thread-safe.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.telemetry import registry as _reg

# Same rank last this many consecutive negotiations -> STRAGGLER.
DEFAULT_STREAK = 3


class StragglerDetector:
    """Feed ``note_ready`` per (tensor, rank) tick and ``note_complete``
    when the tensor goes globally ready; the latter returns
    ``(rank, skew_s)`` when the streak threshold trips."""

    def __init__(self, warn_ms: float, size: int,
                 streak_needed: int = DEFAULT_STREAK):
        self.warn_s = warn_ms / 1000.0
        self.size = size
        self.streak_needed = streak_needed
        # key -> {rank: first-ready monotonic tick}
        self._ready: Dict[str, Dict[int, float]] = {}
        self._streak_rank: Optional[int] = None
        self._streak = 0

    def note_ready(self, key: str, rank: int,
                   now: Optional[float] = None) -> None:
        ticks = self._ready.setdefault(key, {})
        if rank not in ticks:  # first tick wins; re-sends don't reset it
            ticks[rank] = time.monotonic() if now is None else now

    def note_complete(self, key: str) -> Optional[Tuple[int, float]]:
        ticks = self._ready.pop(key, None)
        if not ticks or len(ticks) < 2:
            return None
        last_rank = max(ticks, key=ticks.get)
        skew = ticks[last_rank] - min(ticks.values())
        _reg.observe("hvd_straggler_skew_seconds", skew,
                     labels=(str(last_rank),))
        # warn_ms == 0 -> histogram-only mode, no STRAGGLER records.
        if self.warn_s <= 0 or skew <= self.warn_s:
            self._streak_rank, self._streak = None, 0
            return None
        if last_rank == self._streak_rank:
            self._streak += 1
        else:
            self._streak_rank, self._streak = last_rank, 1
        if self._streak < self.streak_needed:
            return None
        self._streak = 0  # re-arm: one record per full streak
        _reg.inc_counter("hvd_straggler_events_total",
                         labels=(str(last_rank),))
        return last_rank, skew

    def forget(self, key: str) -> None:
        """Drop a pending negotiation (tensor evicted with its rank)."""
        self._ready.pop(key, None)
