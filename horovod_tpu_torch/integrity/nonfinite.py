"""Non-finite gradient guard: agreed skip/zero/raise on NaN or Inf.

The port of ``horovod_tpu/integrity/nonfinite.py``.  One rank's NaN
gradient poisons every replica through the allreduce, and ranks that
decide on their own whether to apply a step strand each other in
collectives.  The guard makes the decision collective:

1. each rank computes a one-element "any non-finite" flag over its
   gradients (on their device),
2. the flags agree by a one-element int32 MAX allreduce (NCCL on the card,
   gloo on the CPU) over the ranks the gradients are reduced over: if any
   rank saw a non-finite value, every rank sees 1,
3. every rank applies the same policy to the same step:

   * ``skip``: drop the step (no gradient allreduce, no inner step:
     parameters and optimizer state unchanged) and count it,
   * ``zero``: replace non-finite gradient entries with zeros
     (``torch.where``, never a multiply: NaN times 0 is NaN) and apply the
     step,
   * ``raise``: as ``skip``, but raise :class:`NonFiniteGradientError` once
     ``HVD_NONFINITE_LIMIT`` consecutive steps agreed non-finite,
   * ``off``: no guard and no extra collective (the default).

The policy comes from ``HVD_NONFINITE_POLICY`` unless passed explicitly to
:class:`~horovod_tpu_torch.parallel.optimizer.DistributedOptimizer`.  The
port is eager, so every policy, ``raise`` included, works with any axis.
Agreed steps are counted in process-global counters (:func:`counters`) and
on the guard itself; a skipped step records a ``NONFINITE_SKIP`` instant on
the engine's timeline (``utils/timeline.py``).  The ``grad.nonfinite``
fault site (a ``corrupt`` fault, detail: the guard's call serial) fills
this rank's first floating gradient with NaN before the check.

Left out until telemetry is ported (ROADMAP Queue 1, item 5.5): the
``hvd_nonfinite_skips_total`` counter.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import timeline as timeline_mod

POLICIES = ("off", "skip", "zero", "raise")

_agg_lock = threading.Lock()
_agg = {"agreed": 0, "skipped": 0}


class NonFiniteGradientError(RuntimeError):
    """``HVD_NONFINITE_LIMIT`` consecutive steps agreed non-finite under
    policy ``raise``: the model has diverged (or the loss scale collapsed),
    and skipping further steps cannot recover it."""

    def __init__(self, consecutive: int, limit: int):
        self.consecutive = consecutive
        self.limit = limit
        super().__init__(
            f"{consecutive} consecutive step(s) had non-finite gradients "
            f"on some rank (limit {limit}); every rank agreed via "
            f"MAX-allreduce and raised together: restore from the last "
            f"good checkpoint (HVD_NONFINITE_POLICY governs this policy)")


def resolve_policy(policy: Optional[str] = None) -> str:
    """Explicit argument beats ``HVD_NONFINITE_POLICY`` beats ``off``."""
    p = (policy if policy is not None
         else env_util.get_str(env_util.NONFINITE_POLICY, "off"))
    p = (p or "off").strip().lower()
    if p not in POLICIES:
        raise ValueError(
            f"unknown non-finite policy {p!r}; expected one of {POLICIES}")
    return p


def consecutive_limit(limit: Optional[int] = None) -> int:
    k = limit if limit is not None else env_util.get_int(
        env_util.NONFINITE_LIMIT, 3)
    if k < 1:
        raise ValueError("non-finite consecutive limit must be >= 1")
    return k


def counters() -> dict:
    """Process-global guard counters: ``agreed`` (steps the ranks agreed
    were non-finite) and ``skipped`` (steps actually dropped)."""
    with _agg_lock:
        return dict(_agg)


def reset_counters() -> None:
    with _agg_lock:
        _agg["agreed"] = 0
        _agg["skipped"] = 0


def _bump(key: str) -> None:
    with _agg_lock:
        _agg[key] += 1


def _local_flag(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[1]`` int32 on the gradients' device: 1 where any floating entry
    is NaN or Inf."""
    bad = [~torch.isfinite(g).all() for g in grads if g.is_floating_point()]
    if not bad:
        dev = grads[0].device if grads else "cpu"
        return torch.zeros(1, dtype=torch.int32, device=dev)
    return torch.stack(bad).any().to(torch.int32).reshape(1)


def _poison_first_float(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The ``grad.nonfinite`` fault: NaN-fill this rank's first floating
    gradient (what a bad kernel or an overflowed loss scale produces)."""
    for i, g in enumerate(grads):
        if g.is_floating_point():
            grads[i] = torch.full_like(g, float("nan"))
            break
    return grads


class NonFiniteGuard:
    """The guard; one instance per optimizer (or shared).

    ``intercept(grads, axis)`` returns ``(grads, skip)``: with ``skip``
    True the caller must drop the step.  Collective: every rank of
    ``axis`` (every rank when None) calls it once per step, in step order.
    ``nonfinite_steps``, ``skipped`` and ``consecutive`` count this guard's
    agreed steps; :func:`counters` those of every guard of the process."""

    def __init__(self, policy: Optional[str] = None,
                 limit: Optional[int] = None):
        self.policy = resolve_policy(policy)
        if self.policy == "off":
            raise ValueError(
                "NonFiniteGuard with policy 'off' is a contradiction; "
                "simply do not install a guard")
        self.limit = consecutive_limit(limit)
        self.nonfinite_steps = 0   # steps the ranks agreed were bad
        self.skipped = 0           # steps actually dropped
        self.consecutive = 0       # current agreed-bad run length
        self._serial = 0           # intercept calls, the fault's detail

    def intercept(self, grads: Sequence[torch.Tensor], axis=None
                  ) -> Tuple[List[torch.Tensor], bool]:
        grads = list(grads)
        self._serial += 1
        if _fi.should_corrupt("grad.nonfinite", str(self._serial)):
            grads = _poison_first_float(grads)
        agreed = C.allreduce(_local_flag(grads), op=ReduceOp.MAX, axis=axis)
        if int(agreed.item()) == 0:
            self.consecutive = 0
            return grads, False
        self.nonfinite_steps += 1
        self.consecutive += 1
        _bump("agreed")
        if self.policy == "zero":
            return [torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                    if g.is_floating_point() else g for g in grads], False
        self.skipped += 1
        _bump("skipped")
        timeline_mod.engine_event(
            timeline_mod.NONFINITE_SKIP, serial=self._serial,
            policy=self.policy, consecutive=self.consecutive)
        if self.policy == "raise" and self.consecutive >= self.limit:
            raise NonFiniteGradientError(self.consecutive, self.limit)
        return grads, True
