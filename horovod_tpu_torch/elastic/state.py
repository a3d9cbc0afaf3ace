"""Elastic training state: commit, rollback and sync.  The port of
``horovod_tpu/elastic/state.py`` (``State``, ``ObjectState``,
``TorchState`` and ``KerasState``).

What ``@hvd.elastic.run`` relies on:

* ``commit()``: an in-memory snapshot at a point the training loop could
  restart from.  It is collective (the same count on every rank): it also
  runs the host-update check, whose one-element MIN allreduce
  (``elastic.commit_check.<serial>``, the JAX package's name, so that a
  mixed gang agrees) makes every rank raise
  :class:`~horovod_tpu_torch.elastic.driver.HostsUpdatedInterrupt` at the
  same commit or none;
* ``restore()``: roll back to the last commit.  After a failure the
  survivors may have applied a step that the dead rank never finished;
  the commit is the state every survivor agrees on;
* ``sync(root=0)``: broadcast the state from ``root``.  The re-form makes
  the lowest surviving old rank the new rank 0, and a joiner receives the
  whole state here.

Snapshots copy numpy arrays and torch tensors (``clone()``, on their
device); ``sync`` carries the state as the pickles of
``broadcast_object``, the JAX package's names included.  Nothing is left
out.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, List, Optional

import numpy as np
import torch


class State:
    """Base elastic state; a subclass says what save, restore and sync
    move.  ``register_reset_callbacks``: hooks run after every re-form (a
    new world size: re-partition the data, rescale the learning rate)."""

    def __init__(self):
        self._reset_callbacks: List[Callable] = []
        # Attached by @hvd.elastic.run; None outside it (commit() is then
        # a plain snapshot).
        self._elastic_ctx = None
        self._commit_serial = 0
        self._last_host_poll = 0.0
        self._update_pending = False

    def register_reset_callbacks(self, callbacks: List[Callable]) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        # The commit checks are named by this serial, which every member
        # of the re-formed gang must agree on, and a joiner starts at 0:
        # the survivors rewind theirs too.
        self._commit_serial = 0
        self._last_host_poll = 0.0
        self._update_pending = False
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def reset(self) -> None:  # a subclass's hook
        pass

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self, root: int = 0) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise ``HostsUpdatedInterrupt`` once every rank has seen a
        pending membership update (a joiner's announcement or a discovery
        change the driver published)."""
        ctx = self._elastic_ctx
        if ctx is None:
            return
        from horovod_tpu_torch.elastic.driver import HostsUpdatedInterrupt
        from horovod_tpu_torch.ops import eager

        now = time.monotonic()
        if not self._update_pending and \
                now - self._last_host_poll >= ctx.check_interval_s:
            self._last_host_poll = now
            self._update_pending = ctx.has_pending_update()
        # MIN over "I have seen it": 1 only when every rank has, so that
        # all interrupt together.
        self._commit_serial += 1
        flag = np.array([1 if self._update_pending else 0], np.int32)
        agreed = eager.allreduce(
            flag, op=eager.ReduceOp.MIN,
            name=f"elastic.commit_check.{self._commit_serial}")
        if int(agreed[0]) >= 1:
            self._update_pending = False
            raise HostsUpdatedInterrupt()


def _snapshot(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return copy.deepcopy(value)


class ObjectState(State):
    """State over attributes: ``ObjectState(model=params, step=0)`` makes
    each keyword an attribute, which save, restore and sync move."""

    def __init__(self, **kwargs):
        super().__init__()
        self._known = list(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._saved = {}
        self.save()

    def save(self) -> None:
        self._saved = {k: _snapshot(getattr(self, k)) for k in self._known}

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, _snapshot(v))

    def sync(self, root: int = 0) -> None:
        from horovod_tpu_torch.ops import eager

        values = {k: getattr(self, k) for k in self._known}
        synced = eager.broadcast_object(values, root_rank=root,
                                        name="elastic.state")
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()


class _ExtraKeywords:
    """A state's extra keywords, an embedded :class:`ObjectState` in
    ``_extra``, read and set as the state's own attributes (so that
    ``state.step += 1`` is saved and restored)."""

    def __getattr__(self, name):
        extra = self.__dict__.get("_extra")
        if extra is not None and name in extra._known:
            return getattr(extra, name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        extra = self.__dict__.get("_extra")
        if extra is not None and name in extra._known:
            setattr(extra, name, value)
        else:
            super().__setattr__(name, value)


class TorchState(_ExtraKeywords, State):
    """State over a torch ``model`` (an ``nn.Module``) and ``optimizer``;
    more keywords ride along as an embedded :class:`ObjectState`.
    ``restore`` and ``sync`` load into the live module and optimizer, so
    that their tensors stay on their device."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        super().__init__()
        self.model = model
        self.optimizer = optimizer
        self._extra = ObjectState(**kwargs) if kwargs else None
        self._saved_model = None
        self._saved_opt = None
        self.save()


    def save(self) -> None:
        if self.model is not None:
            self._saved_model = copy.deepcopy(self.model.state_dict())
        if self.optimizer is not None:
            self._saved_opt = copy.deepcopy(self.optimizer.state_dict())
        if self._extra is not None:
            self._extra.save()

    def restore(self) -> None:
        if self.model is not None and self._saved_model is not None:
            self.model.load_state_dict(self._saved_model)
        if self.optimizer is not None and self._saved_opt is not None:
            # The optimizer keeps the loaded dict's tensors: load a copy.
            self.optimizer.load_state_dict(copy.deepcopy(self._saved_opt))
        if self._extra is not None:
            self._extra.restore()

    def sync(self, root: int = 0) -> None:
        from horovod_tpu_torch.ops import eager

        if self.model is not None:
            sd = eager.broadcast_object(self.model.state_dict(),
                                        root_rank=root,
                                        name="elastic.torch.model")
            self.model.load_state_dict(sd)
        if self.optimizer is not None:
            sd = eager.broadcast_object(self.optimizer.state_dict(),
                                        root_rank=root,
                                        name="elastic.torch.opt")
            self.optimizer.load_state_dict(sd)
        if self._extra is not None:
            self._extra.sync(root)
        self.save()


class KerasState(_ExtraKeywords, State):
    """Elastic state over a Keras ``model`` (weights move as numpy via
    ``get_weights``/``set_weights``); parity:
    ``horovod/tensorflow/keras/elastic.py``.  Its extra keywords are set
    through the state, as :class:`TorchState`'s are."""

    def __init__(self, model=None, **kwargs):
        if model is not None and not (hasattr(model, "get_weights")
                                      and hasattr(model, "set_weights")):
            raise TypeError(
                "KerasState needs a model with get_weights/set_weights")
        super().__init__()
        self.model = model
        self._extra = ObjectState(**kwargs) if kwargs else None
        self._saved_weights: Optional[list] = None
        self.save()


    def save(self) -> None:
        if self.model is not None:
            self._saved_weights = [np.array(w)
                                   for w in self.model.get_weights()]
        if self._extra is not None:
            self._extra.save()

    def restore(self) -> None:
        if self.model is not None and self._saved_weights is not None:
            self.model.set_weights([w.copy()
                                    for w in self._saved_weights])
        if self._extra is not None:
            self._extra.restore()

    def sync(self, root: int = 0) -> None:
        from horovod_tpu_torch.ops import eager

        if self.model is not None:
            weights = eager.broadcast_object(self.model.get_weights(),
                                             root_rank=root,
                                             name="elastic.keras.model")
            self.model.set_weights(weights)
        if self._extra is not None:
            self._extra.sync(root)
        self.save()
