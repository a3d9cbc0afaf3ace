"""Collectives over the process group: the port of the in-graph ops of
``horovod_tpu/ops/collective.py``.

Where the JAX package reduced over named mesh axes inside a trace, these
run eagerly over ``torch.distributed``: NCCL for tensors on the card, gloo
for CPU tensors.  Every function takes ``axis``: an
:class:`~horovod_tpu_torch.parallel.mesh.Axis` from ``mesh.axis(...)``, or
``None`` for every rank (the default group).  Every function returns a new
tensor and leaves its input as it was.

``alltoall``, ``ppermute``, ``ppermute_ring`` and ``allgather_dim`` are
differentiable (the backward of an equal-split all-to-all is the same
exchange of the gradient; that of a permutation is the inverse permutation,
and of a shift around the ring the opposite shift; that of an all-gather is
a reduce-scatter), as their JAX counterparts are under autodiff; the
reductions are not.  ``allreduce(op=ReduceOp.ADASUM)`` runs
:func:`horovod_tpu_torch.ops.adasum.adasum_allreduce`.  ``copy_to_axis`` and
``reduce_from_axis`` are the two halves of a tensor-parallel region (the
collectives GSPMD inserts around the JAX package's sharded products).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.parallel.mesh import Axis, world_axis

_DIST_OP = {
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}
# Wire types the backends cannot reduce: they are gathered as bytes and
# reduced locally in fp32.
_GATHER_REDUCED = (torch.float8_e4m3fn, torch.float8_e5m2)


def _ax(axis: Optional[Axis]) -> Axis:
    return world_axis() if axis is None else axis


def _in_rank_order(ax: Axis) -> Axis:
    """A collective that places data by position runs in the group's rank
    order, which is ascending global rank: the axis index must be too."""
    if list(ax.ranks) != sorted(ax.ranks):
        raise ValueError(f"axes {ax.names} are not in the mesh's order; "
                         "name them as the mesh does")
    return ax


def axis_size(axis: Optional[Axis] = None) -> int:
    return _ax(axis).size


def axis_index(axis: Optional[Axis] = None) -> int:
    """This rank's index along ``axis`` (row-major over its names)."""
    return _ax(axis).index


def _gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` along ``ax``, stacked in index
    order."""
    _in_rank_order(ax)
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype in _GATHER_REDUCED else x
    parts = [torch.empty_like(wire) for _ in range(ax.size)]
    dist.all_gather(parts, wire, group=ax.group)
    return torch.stack([p.view(x.dtype) for p in parts])


def _gather_reduce(x: torch.Tensor, op: ReduceOp, ax: Axis) -> torch.Tensor:
    g = _gather(x, ax)
    if x.dtype in _GATHER_REDUCED:
        g = g.float()
    if op == ReduceOp.PRODUCT:
        y = torch.prod(g, dim=0)
    elif op == ReduceOp.SUM:
        y = torch.sum(g, dim=0)
    elif op == ReduceOp.AVERAGE:
        y = torch.sum(g, dim=0) / ax.size
    elif op == ReduceOp.MIN:
        y = torch.amin(g, dim=0)
    else:
        y = torch.amax(g, dim=0)
    return y.to(x.dtype) if x.dtype in _GATHER_REDUCED else y


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              axis: Optional[Axis] = None) -> torch.Tensor:
    """Allreduce across the ranks of ``axis``.

    ``AVERAGE`` divides by the axis size; ``PRODUCT`` is an all-gather
    followed by a local product, as in the JAX package.  Pre- and postscale
    multiply before and after the reduction.  ``ADASUM`` is
    :func:`~horovod_tpu_torch.ops.adasum.adasum_allreduce` over ``axis``,
    and ignores pre- and postscale, as the JAX package does."""
    ax = _ax(axis)  # raises before init
    if op == ReduceOp.ADASUM:
        from horovod_tpu_torch.ops import adasum

        return adasum.adasum_allreduce(x, axis=ax)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    if op == ReduceOp.PRODUCT or x.dtype in _GATHER_REDUCED:
        y = _gather_reduce(x, op, ax)
    elif op in _DIST_OP:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=_DIST_OP[op], group=ax.group)
        if op == ReduceOp.AVERAGE:
            y = y / ax.size
    else:
        raise ValueError(f"unsupported reduce op {op}")
    if postscale_factor != 1.0:
        y = y * postscale_factor
    return y


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      axis: Optional[Axis] = None,
                      hierarchical: bool = False,
                      outer_axis: str = "dcn") -> List[torch.Tensor]:
    """Fused allreduce of a list of tensors: one flat buffer per dtype, one
    collective per buffer, split back to the input shapes.  Under
    ``ADASUM`` each fused buffer is combined as one vector, as in the JAX
    package.

    ``hierarchical=True`` reduces each buffer with
    :func:`hierarchical_allreduce`; ``axis`` must then name exactly the
    inner axis and ``outer_axis`` (``mesh.axis("dcn", "dp")``), so the ranks
    reduced over are those of the flat path."""
    if hierarchical:
        names = () if axis is None else axis.names
        if len(names) != 2 or outer_axis not in names:
            raise ValueError(
                "hierarchical grouped_allreduce needs axis to name "
                f"exactly the inner and outer axes (got {names}, "
                f"outer_axis={outer_axis!r})")
        inner = axis.mesh.axis(names[0] if names[1] == outer_axis
                               else names[1])
        outer = axis.mesh.axis(outer_axis)
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore[list-item]
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        if hierarchical:
            red = hierarchical_allreduce(flat, op, inner_axis=inner,
                                         outer_axis=outer)
        else:
            red = allreduce(flat, op=op, axis=axis)
        offset = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = red[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def allgather(x: torch.Tensor, axis: Optional[Axis] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0, in index order.  Every
    rank must pass the same shape."""
    g = _gather(x, _ax(axis))
    return g.reshape((-1,) + tuple(x.shape[1:])) if x.dim() else g


def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis: Optional[Axis] = None) -> torch.Tensor:
    """Every rank of ``axis`` receives the tensor of the rank at index
    ``root_rank`` along it."""
    ax = _ax(axis)
    if not 0 <= root_rank < ax.size:
        raise ValueError(f"root_rank {root_rank} out of range for size "
                         f"{ax.size}")
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=ax.ranks[root_rank], group=ax.group)
    return y


def barrier(axis: Optional[Axis] = None) -> None:
    """Block until every rank of ``axis`` reaches the barrier."""
    ax = _ax(axis)
    dev = basics.device()
    if dev.type == "cuda":
        dist.barrier(group=ax.group, device_ids=[dev.index])
    else:
        dist.barrier(group=ax.group)


def reduce_scatter(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                   axis: Optional[Axis] = None) -> torch.Tensor:
    """Reduce across ``axis`` and give the rank at index ``i`` the ``i``-th
    of ``n`` equal slices of dim 0 (which ``n`` must divide)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reduce_scatter supports SUM/AVERAGE")
    ax = _in_rank_order(_ax(axis))
    n = ax.size
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} is not divisible by "
                         f"the axis size {n}")
    y = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    # reduce_scatter_tensor's new name in later torch releases.
    rs = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    rs(y, x.contiguous(), op=dist.ReduceOp.SUM, group=ax.group)
    return y / n if op == ReduceOp.AVERAGE else y


def hierarchical_allreduce(x: torch.Tensor,
                           op: ReduceOp = ReduceOp.AVERAGE, *,
                           inner_axis: Axis, outer_axis: Axis
                           ) -> torch.Tensor:
    """Reduce-scatter over the inner axis, allreduce over the outer, then
    all-gather over the inner: only 1/inner-size of the bytes crosses the
    outer (slower) links.  Dim 0 is zero-padded to a multiple of the inner
    size and unpadded after."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("hierarchical_allreduce supports SUM/AVERAGE")
    n_in = inner_axis.size
    orig = x.shape[0]
    pad = (-orig) % n_in
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    piece = reduce_scatter(x, ReduceOp.SUM, axis=inner_axis)
    piece = allreduce(piece, ReduceOp.SUM, axis=outer_axis)
    full = allgather(piece, axis=inner_axis)[:orig]
    if op == ReduceOp.AVERAGE:
        full = full / (n_in * outer_axis.size)
    return full


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_to_all(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.ax), None


def _all_to_all(x, ax):
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(y, x.contiguous(), group=ax.group)
    return y


def alltoall(x: torch.Tensor, splits=None,
             axis: Optional[Axis] = None) -> torch.Tensor:
    """Split dim 0 into ``n`` equal chunks, send chunk ``j`` to the rank at
    index ``j`` and concatenate what arrives in index order.  Ragged
    ``splits`` raise, as they do in the JAX package's in-graph op."""
    if splits is not None:
        raise NotImplementedError(
            "ragged alltoall (splits=...) is not supported; use equal "
            "splits")
    ax = _in_rank_order(_ax(axis))
    if x.dim() == 0 or x.shape[0] % ax.size:
        raise ValueError(f"dim 0 of {tuple(x.shape)} is not divisible by "
                         f"the axis size {ax.size}")
    return _AllToAll.apply(x, ax)


class _PPermuteRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return _shift(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.ax, -ctx.shift), None, None


def _shift(x, ax, shift):
    """Send ``x`` ``shift`` steps up the ring and receive from ``shift``
    steps down, both posted at once so that no rank blocks on its send."""
    n = ax.size
    if shift % n == 0:
        return x.clone(memory_format=torch.contiguous_format)
    x = x.contiguous()
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ax.ranks[(ax.index + shift) % n],
                      group=ax.group),
           dist.P2POp(dist.irecv, y, ax.ranks[(ax.index - shift) % n],
                      group=ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return y


def ppermute_ring(x: torch.Tensor, axis: Axis, shift: int = 1
                  ) -> torch.Tensor:
    """Send to the rank ``shift`` steps around the ``axis`` ring (index
    ``(i + shift) % n``) and return what the rank ``shift`` steps behind
    sent: the primitive under ring attention.  Differentiable: the backward
    sends the gradient ``-shift`` steps, the transpose of the shift."""
    return _PPermuteRing.apply(x, axis, int(shift))


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _permute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.ax, tuple((d, s) for s, d in ctx.perm)), \
            None, None


def _permute(x, ax, perm):
    """Post this rank's send and receive of ``perm`` at once (no rank
    blocks on its send); zeros where no index sends to this one."""
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    if src == [me]:
        y = x.clone()
    else:
        y = torch.zeros_like(x)
    ops = []
    if dst and dst != [me]:
        ops.append(dist.P2POp(dist.isend, x, ax.ranks[dst[0]],
                              group=ax.group))
    if src and src != [me]:
        ops.append(dist.P2POp(dist.irecv, y, ax.ranks[src[0]],
                              group=ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return y


def ppermute(x: torch.Tensor, axis: Axis, perm) -> torch.Tensor:
    """``lax.ppermute`` over ``axis``: ``perm`` is a list of ``(source,
    destination)`` index pairs, each index at most once as a source and
    once as a destination; the rank at index ``d`` gets the ``x`` of the
    rank at index ``s``, and zeros where no pair names it as a
    destination.  Every rank of the axis calls it with the same ``perm``.
    Differentiable: the backward applies the inverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    for i in (0, 1):
        seen = [p[i] for p in perm]
        if len(set(seen)) != len(seen) or \
                not all(0 <= j < axis.size for j in seen):
            raise ValueError(f"perm {perm} is not a partial permutation of "
                             f"the {axis.size} indices of the axis")
    return _PPermute.apply(x, axis, perm)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(list(_gather(x, ax).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        piece = reduce_scatter(g.movedim(ctx.dim, 0), ReduceOp.SUM,
                               axis=ctx.ax)
        return piece.movedim(0, ctx.dim), None, None


def allgather_dim(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in index order (every
    rank the same shape).  Differentiable: the backward reduce-scatters the
    gradient (SUM), so each rank gets the sum over the ranks of its block's
    gradient."""
    if axis.size == 1:
        return x
    return _AllGatherDim.apply(x, _in_rank_order(axis), dim)


def _sum(x, ax):
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ax.group)
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Enter a region whose ranks along ``axis`` each compute a part: the
    identity forward, a SUM allreduce of the gradient backward (each rank's
    part gives a partial gradient of ``x``).  Megatron's ``f``; ``x`` is
    replicated over ``axis``.  None or a size-1 axis: ``x`` itself."""
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Leave such a region: a SUM allreduce of the ranks' partial results
    forward, the identity backward (the result is replicated, and so is its
    gradient).  Megatron's ``g``.  None or a size-1 axis: ``x`` itself."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)
