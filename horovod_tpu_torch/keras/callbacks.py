"""Keras callbacks for distributed training: the port of
``horovod_tpu/keras/callbacks.py``.

Role parity: ``horovod/_keras/callbacks.py`` — broadcast initial state,
average metrics across ranks at epoch end, and learning-rate
warmup/schedule callbacks that scale with the number of workers.
Implemented against Keras 3 (framework-agnostic weight access via
get_weights/set_weights numpy arrays), over the port's eager engine
(``horovod_tpu_torch/ops/eager.py``).  Nothing is left out.
"""

from __future__ import annotations

import keras
import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import eager as _eager


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcasts model (and optimizer) state from root at the start of
    training, so random initializations agree (parity:
    _keras/callbacks.py:20-43)."""

    def __init__(self, root_rank=0):
        super().__init__()
        self.root_rank = root_rank
        self._model_done = False
        self._opt_done = False

    def on_batch_begin(self, batch, logs=None):
        if basics.size() <= 1:
            return
        if not self._model_done:
            weights = self.model.get_weights()
            handles = [_eager.broadcast_async(w, self.root_rank,
                                              name=f"kbc.model.{i}")
                       for i, w in enumerate(weights)]
            self.model.set_weights(
                [_eager.synchronize(h) for h in handles])
            self._model_done = True
        if not self._opt_done:
            # Keras 3 builds optimizer variables lazily inside the first
            # apply, so the state broadcast waits until they exist
            # (typically the second batch) instead of latching early.
            opt = getattr(self.model, "optimizer", None)
            ovars = list(getattr(opt, "variables", None) or [])
            if ovars:
                handles = [
                    _eager.broadcast_async(np.asarray(v), self.root_rank,
                                           name=f"kbc.opt.{i}")
                    for i, v in enumerate(ovars)]
                for v, h in zip(ovars, handles):
                    out = np.asarray(_eager.synchronize(h))
                    # the engine flattens 0-d scalars to shape (1,)
                    v.assign(out.reshape(np.asarray(v).shape))
                self._opt_done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Averages epoch-end metrics over all ranks so rank-0 logging and
    checkpoint decisions reflect the whole job (parity:
    _keras/callbacks.py:46-84)."""

    def on_epoch_end(self, epoch, logs=None):
        if logs is None or basics.size() <= 1:
            return
        for key in sorted(logs.keys()):
            value = logs[key]
            if isinstance(value, (int, float, np.floating, np.integer)):
                logs[key] = float(_eager.allreduce(
                    np.asarray(value, np.float64),
                    op=_eager.ReduceOp.AVERAGE,
                    name=f"metric.{epoch}.{key}"))


def _get_lr(optimizer) -> float:
    return float(np.asarray(optimizer.learning_rate))


def _set_lr(optimizer, lr: float, momentum_correction: bool) -> None:
    # Momentum correction (Goyal et al., the recipe behind
    # _keras/callbacks.py:120-134): when the LR changes old→new, the SGD
    # velocity v (which has the LR folded in: v ← m·v − lr·g) must be
    # rescaled by new/old.  The reference does it by scaling the momentum
    # *coefficient* for exactly the next update and restoring it
    # afterwards:  v' = (m·new/old)·v − new·g.  Here we rescale the
    # momentum *buffers* once at the change instead:  v ← (new/old)·v,
    # then v' = m·v − new·g — algebraically identical, including under a
    # per-batch warmup ramp (each change applies its own old/new ratio
    # exactly once).  This intentional divergence exists because in
    # Keras 3 ``optimizer.momentum`` is a plain Python float baked into
    # the compiled update step — mutating it between batches does not
    # reliably take effect — while the velocity slots
    # (``optimizer.momentums``) are real variables whose assignment
    # always does.
    old = _get_lr(optimizer)
    optimizer.learning_rate = lr
    if momentum_correction and old > 0 and lr != old and \
            getattr(optimizer, "momentums", None):
        scale = lr / old
        for m in optimizer.momentums:
            m.assign(m * scale)


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiplies the initial LR by ``multiplier`` inside
    [start_epoch, end_epoch) — multiplier is a constant or a function of
    epoch; ``staircase`` applies per epoch, else per batch with epoch
    fractions (parity: _keras/callbacks.py:87-159)."""

    def __init__(self, multiplier, start_epoch=0, end_epoch=None,
                 staircase=True, momentum_correction=True,
                 steps_per_epoch=None):
        super().__init__()
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr = None
        self.current_epoch = None
        if not callable(multiplier):
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _in_range(self, epoch) -> bool:
        return (epoch >= self.start_epoch and
                (self.end_epoch is None or epoch < self.end_epoch))

    def on_train_begin(self, logs=None):
        if self.initial_lr is None:
            self.initial_lr = _get_lr(self.model.optimizer)
        if not self.staircase and not self.steps_per_epoch:
            raise ValueError(
                "steps_per_epoch is required when staircase=False")

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            _set_lr(self.model.optimizer,
                    self.initial_lr * self.multiplier(epoch),
                    self.momentum_correction)
        elif not self.staircase and self.end_epoch is not None and \
                epoch == self.end_epoch:
            # Batch fractions stop just short of end_epoch; land exactly
            # on the final value when the ramp completes.
            _set_lr(self.model.optimizer,
                    self.initial_lr * self.multiplier(self.end_epoch),
                    self.momentum_correction)

    def on_batch_begin(self, batch, logs=None):
        if not self.staircase and self._in_range(self.current_epoch):
            epoch = self.current_epoch + float(batch) / self.steps_per_epoch
            _set_lr(self.model.optimizer,
                    self.initial_lr * self.multiplier(epoch),
                    self.momentum_correction)

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = _get_lr(self.model.optimizer)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR warmup, the "facebook 1-hour" recipe (parity:
    _keras/callbacks.py:162-200).  The optimizer's configured LR is the
    already-size-scaled target; the ramp starts at target/size() and
    reaches the target after ``warmup_epochs``:
    lr(epoch) = target * (epoch * (size-1) / warmup + 1) / size."""

    def __init__(self, warmup_epochs=5, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        self.verbose = verbose
        n = basics.size()

        def multiplier(epoch):
            return (epoch * (n - 1) / warmup_epochs + 1) / n

        super().__init__(multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose and \
                basics.rank() == 0:
            print(f"Epoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {_get_lr(self.model.optimizer):.6g}.")
