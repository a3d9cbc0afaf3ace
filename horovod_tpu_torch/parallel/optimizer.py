"""Distributed optimizer: the port of ``horovod_tpu/parallel/optimizer.py``.

``DistributedOptimizer(inner)`` wraps a ``torch.optim.Optimizer``: on
``step()`` it reduces every parameter's gradient across the ranks of
``axis`` (default: every rank) with one :func:`grouped_allreduce` (one
collective per dtype; ``hierarchical=True`` for the reduce-scatter,
allreduce, all-gather route over an inner axis and ``outer_axis``), then
runs the inner optimizer.  With ``backward_passes_per_step=n`` it adds the
gradients of n calls locally and reduces and applies their mean on every
n-th call only, leaving parameters and inner state untouched on the others
(the JAX package reduces every step and masks the update; the updates and
state are the same).

``nonfinite_policy`` arms the non-finite gradient guard
(:mod:`horovod_tpu_torch.integrity.nonfinite`).  :func:`distributed_grad`
and :func:`distributed_value_and_grad` are the DistributedGradientTape
analogs: ``torch.func`` gradients, allreduced.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.utils import _pytree

from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.integrity import nonfinite as _nf
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel.mesh import Axis


def allreduce_gradients(grads: Sequence[torch.Tensor], *,
                        op: ReduceOp = ReduceOp.AVERAGE,
                        axis: Optional[Axis] = None,
                        compression=Compression.none,
                        hierarchical: bool = False,
                        outer_axis: str = "dcn") -> List[torch.Tensor]:
    """Compress, reduce as one fused group per dtype over ``axis`` (every
    rank when None), decompress.  ``hierarchical=True`` needs ``axis`` to
    name exactly the inner axis and ``outer_axis``."""
    comp = [compression.compress(g) for g in grads]
    reduced = C.grouped_allreduce([c for c, _ in comp], op=op, axis=axis,
                                  hierarchical=hierarchical,
                                  outer_axis=outer_axis)
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, comp)]


class DistributedOptimizer:
    """Wrap ``inner`` so that its updates see globally reduced gradients.

    ``nonfinite_policy`` (default: ``HVD_NONFINITE_POLICY``, then ``off``)
    arms the non-finite gradient guard: a one-element MAX allreduce agrees
    a per-step any-NaN/Inf flag over ``axis`` (with ``hierarchical=True``
    it names the inner axis and ``outer_axis``, so the agreement spans the
    whole reduction set and no slice applies a step another skips), so
    that every rank
    skips (``skip``), sanitizes (``zero``) or raises on (``raise``) the
    same step.  ``off`` adds no collective.  Pass ``nonfinite_guard`` (a
    :class:`~horovod_tpu_torch.integrity.nonfinite.NonFiniteGuard`) to keep
    a handle on its counters; ``self.guard`` is the guard in use, or None.
    The guard composes with ``backward_passes_per_step == 1`` only."""

    def __init__(self, inner: torch.optim.Optimizer, *,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 axis: Optional[Axis] = None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 hierarchical: bool = False,
                 outer_axis: str = "dcn",
                 nonfinite_policy: Optional[str] = None,
                 nonfinite_guard: Optional[_nf.NonFiniteGuard] = None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        guard = nonfinite_guard
        policy = guard.policy if guard is not None \
            else _nf.resolve_policy(nonfinite_policy)
        if policy != "off":
            if backward_passes_per_step != 1:
                raise ValueError(
                    "the non-finite gradient guard composes with "
                    "backward_passes_per_step == 1 only; accumulate at the "
                    "data-loader level to combine them")
            if guard is None:
                guard = _nf.NonFiniteGuard(policy)
        self.guard = guard
        self.inner = inner
        self.op = op
        self.axis = axis
        self.hierarchical = hierarchical
        self.outer_axis = outer_axis
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._acc: List[torch.Tensor] = []

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        """The inner optimizer's state (for a checkpoint)."""
        return self.inner.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.inner.load_state_dict(state_dict)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def step(self):
        """Reduce the gradients and run the inner step (every
        ``backward_passes_per_step``-th call).  Returns the inner step's
        result, or None on a call that only accumulated or that the guard
        skipped (then no gradient is reduced and nothing is updated).

        A parameter without a gradient (``.grad`` None: unused in this
        backward) counts as a zero gradient, as a leaf of the JAX package's
        gradient pytree always has one: every rank then fuses buffers of
        one size, and the inner optimizer updates (and, with AdamW, decays)
        every parameter, as optax does."""
        params = self._params()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        n = self.backward_passes_per_step
        if n > 1:
            if not self._acc:
                self._acc = [g.clone() for g in grads]
            else:
                self._acc = [a + g for a, g in zip(self._acc, grads)]
            self._passes += 1
            if self._passes < n:
                return None
            grads = [a / n for a in self._acc]
            self._passes, self._acc = 0, []
        if self.guard is not None:
            grads, skip = self.guard.intercept(grads, self.axis)
            if skip:
                return None
        reduced = allreduce_gradients(
            grads, op=self.op, axis=self.axis, compression=self.compression,
            hierarchical=self.hierarchical, outer_axis=self.outer_axis)
        for p, g in zip(params, reduced):
            p.grad = g
        return self.inner.step()


def _reduce_tree(grads, **kw):
    leaves, spec = _pytree.tree_flatten(grads)
    return _pytree.tree_unflatten(allreduce_gradients(leaves, **kw), spec)


def distributed_grad(fun, *, op: ReduceOp = ReduceOp.AVERAGE,
                     axis: Optional[Axis] = None,
                     compression=Compression.none,
                     argnums=0, has_aux: bool = False):
    """DistributedGradientTape analog: ``torch.func.grad(fun)`` with the
    gradients allreduced across ``axis`` (every rank when None) through
    :func:`allreduce_gradients`.  Returns ``grads``, or ``(grads, aux)``
    with ``has_aux``, as JAX's ``grad`` does."""
    gfun = torch.func.grad(fun, argnums=argnums, has_aux=has_aux)
    kw = dict(op=op, axis=axis, compression=compression)

    def wrapped(*args, **kwargs):
        if has_aux:
            grads, aux = gfun(*args, **kwargs)
            return _reduce_tree(grads, **kw), aux
        return _reduce_tree(gfun(*args, **kwargs), **kw)

    return wrapped


def distributed_value_and_grad(fun, *, op: ReduceOp = ReduceOp.AVERAGE,
                               axis: Optional[Axis] = None,
                               compression=Compression.none,
                               argnums=0, has_aux: bool = False):
    """As :func:`distributed_grad`, returning ``(value, grads)`` (with
    ``has_aux``: ``((value, aux), grads)``), JAX's ``value_and_grad``
    order.  The value is this rank's, not reduced."""
    vgfun = torch.func.grad_and_value(fun, argnums=argnums, has_aux=has_aux)
    kw = dict(op=op, axis=axis, compression=compression)

    def wrapped(*args, **kwargs):
        grads, val = vgfun(*args, **kwargs)
        return val, _reduce_tree(grads, **kw)

    return wrapped
