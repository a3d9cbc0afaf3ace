"""Training-loop helpers mirroring the reference's Keras callbacks: the port
of ``horovod_tpu/callbacks.py`` for users writing plain torch loops.

* ``metric_average`` — epoch-end metric averaging across ranks
  (MetricAverageCallback), on the port's eager engine.
* ``warmup_schedule`` — LR warmup from the single-worker value to
  size× over N steps (LearningRateWarmupCallback's recipe).
* ``schedule_with_multipliers`` — epoch-ranged LR multipliers
  (LearningRateScheduleCallback).

The JAX package returns optax schedules over ``jax.numpy``; here each
schedule is a plain function of the step, which takes an ``int`` (and
gives a ``float``) or a tensor (and gives a float32 tensor), with the
JAX schedules' float32 roundings, so that both give the same learning
rate at every step.  It fits a torch loop, for example as
``LambdaLR(opt, lambda s: sched(s) / base_lr)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import eager as _eager


def metric_average(value, name: str):
    """Average a scalar (or array) metric across all ranks; returns a
    float for scalars (parity: _keras/callbacks.py:46-84)."""
    out = _eager.allreduce(np.asarray(value, np.float64),
                           op=ReduceOp.AVERAGE, name=f"metric.{name}")
    return float(out) if np.ndim(out) == 0 or np.size(out) == 1 else out


def _is_tensor(step) -> bool:
    return type(step).__module__.startswith("torch")


def warmup_schedule(base_lr: float, warmup_steps: int,
                    size: Optional[int] = None) -> Callable:
    """lr(step) ramps base_lr → base_lr*size over warmup_steps, then
    stays at base_lr*size (parity: the gradual warmup of
    _keras/callbacks.py:162-200)."""
    n = basics.size() if size is None else size
    w = max(1, warmup_steps)

    def schedule(step):
        if _is_tensor(step):
            import torch

            frac = torch.clamp(step / w, max=1.0).to(torch.float32)
            return (frac * (n - 1) + 1) * base_lr
        frac = np.minimum(np.float32(step / w), np.float32(1.0))
        return float(np.float32(base_lr)
                     * (frac * np.float32(n - 1) + np.float32(1)))

    return schedule


def schedule_with_multipliers(
        base_lr: float,
        multipliers: Sequence[Tuple[int, float]],
        steps_per_epoch: int) -> Callable:
    """The LR from (start_epoch, multiplier) pairs — the classic ImageNet
    staircase the reference's examples build from
    LearningRateScheduleCallback stacks."""
    starts = np.asarray([e * steps_per_epoch for e, _ in multipliers],
                        np.int64)
    # multiplier 1.0 applies before the first boundary
    mults = np.asarray([1.0] + [m for _, m in multipliers], np.float32)

    def schedule(step):
        if _is_tensor(step):
            import torch

            idx = torch.clamp((step >= torch.as_tensor(starts)).sum(),
                              0, len(mults) - 1)
            return torch.as_tensor(mults)[idx] * base_lr
        idx = int(np.clip(np.sum(step >= starts), 0, len(mults) - 1))
        return float(np.float32(base_lr) * mults[idx])

    return schedule
