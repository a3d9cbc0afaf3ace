"""Adasum: scale-invariant gradient combination, the port of
``horovod_tpu/ops/adasum.py``.

The pairwise combination of gradients a, b is

    a' = (1 - dot(a,b) / (2·‖a‖²)) · a  +  (1 - dot(a,b) / (2·‖b‖²)) · b

applied recursively over pairs of ranks (vector-halving distance-doubling
in the reference Horovod, ``adasum.h``).  It behaves like an average for
orthogonal gradients and like a sum for identical ones.

:func:`adasum_allreduce` runs log2(n) rounds over an axis of n ranks: in
round k each rank exchanges its whole vector with the rank at index
``i ^ k`` (:func:`~horovod_tpu_torch.ops.collective.ppermute`), takes the dot
product and both norms in fp32, combines, and casts back to the input's
dtype.  The combine is symmetric in (a, b), so both partners compute the
same value and no second exchange is needed.  The schedule
(:func:`_adasum_rounds`) takes its exchange as an argument, as
``ring_attention._ring`` takes its hop: :func:`adasum_loopback` runs the
ranks of a gang as virtual ranks in one process.

The float64 numpy oracle (:func:`adasum_pair_numpy`,
:func:`adasum_reduce_numpy`) is the port's own copy of the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel.mesh import Axis, world_axis


def adasum_pair(a, b, dot, anorm_sq, bnorm_sq):
    """Combine two gradients given precomputed <a,b>, ‖a‖², ‖b‖² (tensors,
    broadcast against ``a`` and ``b``).  Where a norm is zero its
    coefficient is 1: the combination degenerates to a plain sum
    (``adasum.h``'s scalar guard)."""
    one = torch.ones_like(dot)
    acoef = torch.where(anorm_sq > 0, 1.0 - dot / (2.0 * anorm_sq), one)
    bcoef = torch.where(bnorm_sq > 0, 1.0 - dot / (2.0 * bnorm_sq), one)
    return acoef.to(a.dtype) * a + bcoef.to(b.dtype) * b


def adasum_pair_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Eager pairwise combine in float64."""
    dot = float(np.dot(a.ravel(), b.ravel()))
    an = float(np.dot(a.ravel(), a.ravel()))
    bn = float(np.dot(b.ravel(), b.ravel()))
    acoef = 1.0 - dot / (2.0 * an) if an > 0 else 1.0
    bcoef = 1.0 - dot / (2.0 * bn) if bn > 0 else 1.0
    return acoef * a + bcoef * b


def adasum_reduce_numpy(grads: Sequence[np.ndarray]) -> np.ndarray:
    """The oracle over a list of per-rank gradients (a power-of-two count),
    in float64, recursing over rank pairs in distance-doubling order: the
    first half's result combined with the second half's."""
    grads = [np.asarray(g, np.float64) for g in grads]
    n = len(grads)
    if n & (n - 1) or n == 0:
        raise ValueError(f"the Adasum oracle needs a power-of-two number of "
                         f"ranks, got {n}")
    if n == 1:
        return grads[0]
    half = n // 2
    return adasum_pair_numpy(adasum_reduce_numpy(grads[:half]),
                             adasum_reduce_numpy(grads[half:]))


# exchange(acc, k) -> partners: acc is [R, ...], the vectors of the R ranks
# this process holds; returns the vector of each one's partner at index
# (i ^ k), in the same order.
Exchange = Callable[[torch.Tensor, int], torch.Tensor]


def _adasum_rounds(x: torch.Tensor, n: int, exchange: Exchange
                   ) -> torch.Tensor:
    """The recursion for ``R`` ranks of ``n`` at once: ``x`` is ``[R,
    ...]`` (R is 1 in a gang).  Each round's statistics are fp32 sums over
    each rank's whole vector; the result is cast to x's dtype after every
    round."""
    if n & (n - 1):
        raise ValueError(f"Adasum needs a power-of-two axis size, got {n}")
    acc = x
    k = 1
    while k < n:
        a32 = acc.float().flatten(1)
        b32 = exchange(acc, k).float().flatten(1)
        dot = torch.linalg.vecdot(a32, b32)[:, None]
        an = torch.linalg.vecdot(a32, a32)[:, None]
        bn = torch.linalg.vecdot(b32, b32)[:, None]
        acc = adasum_pair(a32, b32, dot, an, bn).view(x.shape).to(x.dtype)
        k *= 2
    return acc


def adasum_allreduce(x: torch.Tensor, axis: Optional[Axis] = None
                     ) -> torch.Tensor:
    """Adasum over the ranks of ``axis`` (every rank when None), its index
    linearised row-major over its names.  Round k pairs indices that
    differ in bit k, so the low bits (the last name) combine first: for
    power-of-two axis sizes, the JAX package's order of running its last
    axis first (``for ax in reversed(axes)``).  A size that is not a power
    of two raises ``ValueError``."""
    ax = world_axis() if axis is None else axis
    n = ax.size
    if n == 1:
        return x.clone()

    def exchange(acc, k):
        return C.ppermute(acc[0], ax, [(i, i ^ k) for i in range(n)])[None]

    return _adasum_rounds(x[None], n, exchange)[0]


def adasum_loopback(xs: torch.Tensor) -> torch.Tensor:
    """Run the schedule of ``n = xs.shape[0]`` ranks in this one process:
    ``xs[i]`` is the vector of the rank at index ``i``; returns every
    rank's result, ``[n, ...]`` (equal rows).  The exchange of each round
    is an index of the stacked vectors, so the arithmetic is a gang's."""
    n = xs.shape[0]
    partner = torch.arange(n, device=xs.device)
    return _adasum_rounds(xs, n, lambda acc, k: acc[partner ^ k])
