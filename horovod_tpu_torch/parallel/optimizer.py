"""Distributed optimizer: the port of ``horovod_tpu/parallel/optimizer.py``.

``DistributedOptimizer(inner)`` wraps a ``torch.optim.Optimizer``: on
``step()`` it reduces every parameter's gradient across the ranks with one
:func:`grouped_allreduce` (one collective per dtype), then runs the inner
optimizer.  With ``backward_passes_per_step=n`` it adds the gradients of n
calls locally and reduces and applies their mean on every n-th call only,
leaving parameters and inner state untouched on the others (the JAX
package reduces every step and masks the update; the updates and state are
the same).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.compression import Compression


def allreduce_gradients(grads: Sequence[torch.Tensor], *,
                        op: ReduceOp = ReduceOp.AVERAGE,
                        compression=Compression.none) -> List[torch.Tensor]:
    """Compress, reduce as one fused group per dtype, decompress."""
    comp = [compression.compress(g) for g in grads]
    reduced = C.grouped_allreduce([c for c, _ in comp], op=op)
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, comp)]


class DistributedOptimizer:
    """Wrap ``inner`` so that its updates see globally reduced gradients.

    The non-finite gradient guard of the JAX package is not ported yet:
    asking for it raises."""

    def __init__(self, inner: torch.optim.Optimizer, *,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 nonfinite_policy: Optional[str] = None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if nonfinite_policy not in (None, "off"):
            raise NotImplementedError(
                "the non-finite gradient guard is not ported yet; see "
                "ROADMAP.md, Queue 1")
        self.inner = inner
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._acc: List[Optional[torch.Tensor]] = []

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def step(self):
        """Reduce the gradients and run the inner step (every
        ``backward_passes_per_step``-th call).  Returns the inner step's
        result, or None on a call that only accumulated."""
        params = self._params()
        grads = [p.grad for p in params]
        n = self.backward_passes_per_step
        if n > 1:
            if not self._acc:
                self._acc = [None] * len(params)
            for i, g in enumerate(grads):
                if g is not None:
                    self._acc[i] = g.clone() if self._acc[i] is None \
                        else self._acc[i] + g
            self._passes += 1
            if self._passes < n:
                return None
            grads = [None if a is None else a / n for a in self._acc]
            self._passes, self._acc = 0, []
        live = [i for i, g in enumerate(grads) if g is not None]
        reduced = allreduce_gradients([grads[i] for i in live], op=self.op,
                                      compression=self.compression)
        for i, g in zip(live, reduced):
            params[i].grad = g
        return self.inner.step()
