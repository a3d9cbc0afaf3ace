"""Collectives over the process group: the port of the in-graph ops of
``horovod_tpu/ops/collective.py`` (``allreduce``, ``grouped_allreduce``,
``allgather``, ``broadcast``, ``barrier``).

Where the JAX package reduced over named mesh axes inside a trace, these
run eagerly over ``torch.distributed``'s default group: NCCL for tensors on
the card, gloo for CPU tensors.  Every function returns a new tensor and
leaves its input as it was.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.common.types import ReduceOp

_DIST_OP = {
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}
# Wire types the backends cannot reduce: they are gathered as bytes and
# reduced locally in fp32.
_GATHER_REDUCED = (torch.float8_e4m3fn, torch.float8_e5m2)


def _gather(x: torch.Tensor) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x``, stacked in rank order."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype in _GATHER_REDUCED else x
    parts = [torch.empty_like(wire) for _ in range(basics.size())]
    dist.all_gather(parts, wire)
    return torch.stack([p.view(x.dtype) for p in parts])


def _gather_reduce(x: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    g = _gather(x)
    if x.dtype in _GATHER_REDUCED:
        g = g.float()
    if op == ReduceOp.PRODUCT:
        y = torch.prod(g, dim=0)
    elif op == ReduceOp.SUM:
        y = torch.sum(g, dim=0)
    elif op == ReduceOp.AVERAGE:
        y = torch.sum(g, dim=0) / basics.size()
    elif op == ReduceOp.MIN:
        y = torch.amin(g, dim=0)
    else:
        y = torch.amax(g, dim=0)
    return y.to(x.dtype) if x.dtype in _GATHER_REDUCED else y


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Allreduce across every rank.

    ``AVERAGE`` divides by the group size; ``PRODUCT`` is an all-gather
    followed by a local product, as in the JAX package.  Pre- and postscale
    multiply before and after the reduction."""
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet; see ROADMAP.md, Queue 1 "
            "(rest of the compiled regime)")
    basics.size()  # raises before init
    if prescale_factor != 1.0:
        x = x * prescale_factor
    if op == ReduceOp.PRODUCT or x.dtype in _GATHER_REDUCED:
        y = _gather_reduce(x, op)
    elif op in _DIST_OP:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=_DIST_OP[op])
        if op == ReduceOp.AVERAGE:
            y = y / basics.size()
    else:
        raise ValueError(f"unsupported reduce op {op}")
    if postscale_factor != 1.0:
        y = y * postscale_factor
    return y


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE) -> List[torch.Tensor]:
    """Fused allreduce of a list of tensors: one flat buffer per dtype, one
    collective per buffer, split back to the input shapes."""
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore[list-item]
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        red = allreduce(flat, op=op)
        offset = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = red[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0, in rank order.  Every
    rank must pass the same shape."""
    g = _gather(x)
    return g.reshape((-1,) + tuple(x.shape[1:])) if x.dim() else g


def broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Every rank receives ``root_rank``'s tensor."""
    if not 0 <= root_rank < basics.size():
        raise ValueError(f"root_rank {root_rank} out of range for size "
                         f"{basics.size()}")
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=root_rank)
    return y


def barrier() -> None:
    """Block until every rank reaches the barrier."""
    dev = basics.device()
    if dev.type == "cuda":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
