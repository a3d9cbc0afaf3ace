"""Engine collectives as custom ops under ``torch.compile``: the port of
``horovod_tpu/ops/bridge.py``.

A collective called inside a compiled torch program rides the shared
eager engine, with its naming, negotiation, fusion, response cache,
timeline and join, as an eager op does: a bridge tensor and an eager
tensor of the same name are the same request on the wire, and the
results are the same bits.

Mechanism: each collective is a ``torch.library.custom_op`` in the
``horovod_tpu_torch`` namespace.  Its fake (meta) implementation gives
the output's shape, so ``torch.compile(fullgraph=True)`` traces it with
no graph break; at run time the op enqueues its operand into the engine
(a CUDA tensor by a host copy on the current stream, ``ops/eager.py``),
blocks on ``synchronize`` and returns the result on the operand's device.
The JAX bridge's ordered host callback becomes the compiled graph's own
order: every rank compiles the same program, so the blocking calls come
in the same order on every rank, and the coordinator still negotiates by
name underneath.

For gradient reductions use :func:`grouped_allreduce`: one op enqueues
every tensor and then synchronizes them all, so that the engine sees the
whole group outstanding at once and fuses it.

Differentiation (``register_autograd``, the JAX bridge's ``custom_vjp``
rules): the gradient of an allreduce is the same allreduce of the
gradient, named ``<name>.grad`` (grouped: ``<base>.grad``); an
allgather's is this rank's rows of the gradient's Sum allreduce; a
broadcast's is the gradient's Sum allreduce on the root and zero
elsewhere.  ``reducescatter``, ``alltoall`` and ``barrier`` have no
gradient.

Names are fixed when the program is traced (``_auto_name`` runs once per
trace, outside the graph), from one counter per kind shared with the
eager layer: every rank must trace the same calls in the same order, or
pass ``name=``.  Shapes are static: allgather takes equal shapes, and
alltoall the equal split; reducescatter's output is this rank's
near-equal row chunk, known at trace time.

The JAX package refuses a call inside ``shard_map``/``pmap`` bodies by
probing JAX's axis environment (``_check_single_device_trace``).  torch
has no named mesh axes in a traced program; its batching transform is
``torch.func.vmap``, under which each op raises a ``TypeError`` naming
the mesh-axis collectives of ``horovod_tpu_torch.ops.collective`` (a
batch of ranks inside one process would enqueue one tensor name many
times).

On the native engine, the grouped allreduce of CPU tensors without
compression runs the C++ core's dispatcher op ``hvd::grouped_allreduce``
(``csrc/torch_ops.cc``; :func:`_native_eligible`), the body of the JAX
bridge's XLA FFI handler: it copies each operand to its output, enqueues
them all as ``<base>.<i>`` and waits on them all, with no Python between
the enqueues.  It runs inside the custom op, so the compiled graph is the
same on either path.  ``HVD_TORCH_NATIVE_OPS=0`` keeps the eager path.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import eager
from horovod_tpu_torch import process_sets
from horovod_tpu_torch.process_sets import ProcessSet

_NS = "horovod_tpu_torch"

_MISUSE_MSG = (
    "engine-bridge collectives cannot run under torch.func.vmap (each "
    "batch entry would enqueue separately under one tensor name); use "
    "the mesh-axis collectives in horovod_tpu_torch.ops.collective "
    "instead")


@torch.compiler.assume_constant_result
def _next_name(kind: str) -> str:
    return eager._auto_name(f"bridge.{kind}", None)


def _auto_name(kind: str, name: Optional[str]) -> str:
    """The op's name: ``name``, or the next of the kind's counter, drawn
    once when the program is traced."""
    return name if name is not None else _next_name(kind)


def _ps_id(process_set) -> int:
    """The op's process set as its id (0 is the world), the engine's own
    key: a set is registered on every rank that constructs it."""
    return 0 if process_set is None else int(process_set.process_set_id)


def _members(ps_id: int) -> List[int]:
    if not ps_id:
        return list(range(basics.size()))
    ranks = process_sets.ranks_of(ps_id)
    if ranks is None:
        raise ValueError(f"process set {ps_id} is not registered here: "
                         "construct it on every rank")
    return ranks


def _set(ps_id: int):
    return ProcessSet(_members(ps_id)) if ps_id else None


def _group_size(ps_id: int) -> int:
    return len(_members(ps_id))


def _group_index(ps_id: int) -> int:
    return _members(ps_id).index(basics.rank())


def _wire(compression) -> Optional[torch.dtype]:
    return None if compression is None else \
        getattr(compression, "wire_dtype", None)


class _Wire:
    """The eager layer's compressor interface for a wire dtype."""

    def __init__(self, wire_dtype):
        self.wire_dtype = wire_dtype


def _compressor(wire: Optional[torch.dtype]):
    return None if wire is None else _Wire(wire)


def _refuse_vmap(info, in_dims, *args):
    raise TypeError(_MISUSE_MSG)


# ---------------------------------------------------------------------------
# allreduce


@torch.library.custom_op(f"{_NS}::allreduce", mutates_args=())
def _allreduce_op(x: torch.Tensor, name: str, op: int, prescale: float,
                  postscale: float, wire: Optional[torch.dtype],
                  ps_id: int) -> torch.Tensor:
    return eager.allreduce(x, name=name, op=ReduceOp(op),
                           prescale_factor=prescale,
                           postscale_factor=postscale,
                           compression=_compressor(wire),
                           process_set=_set(ps_id))


@_allreduce_op.register_fake
def _(x, name, op, prescale, postscale, wire, ps_id):
    return torch.empty_like(x)


def _allreduce_setup(ctx, inputs, output):
    _, name, op, prescale, postscale, wire, ps_id = inputs
    ctx.args = (name + ".grad", op, prescale, postscale, wire, ps_id)


def _allreduce_backward(ctx, grad):
    # The gradient of an allreduce is an allreduce of the gradient with
    # the same op and scale factors.
    return (_allreduce_op(grad.contiguous(), *ctx.args),
            None, None, None, None, None, None)


_allreduce_op.register_autograd(_allreduce_backward,
                                setup_context=_allreduce_setup)


def allreduce(x: torch.Tensor, name: Optional[str] = None,
              op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              compression=None, process_set=None) -> torch.Tensor:
    """Named, negotiated allreduce usable inside ``torch.compile``;
    differentiable, the gradient's allreduce named ``<name>.grad``."""
    return _allreduce_op(x, _auto_name("allreduce", name), int(op),
                         float(prescale_factor), float(postscale_factor),
                         _wire(compression), _ps_id(process_set))


# ---------------------------------------------------------------------------
# grouped allreduce (fusion on the compiled path)


def _native_eligible(xs: List[torch.Tensor],
                     wire: Optional[torch.dtype]) -> bool:
    """True when ``hvd::grouped_allreduce`` can take the group: no
    compression (the eager layer casts on the host), CPU tensors of the
    dtypes it takes, the native engine running."""
    from horovod_tpu_torch.torch import _native_ops

    return wire is None and all(
        x.device.type == "cpu" and str(x.dtype) in
        _native_ops.SUPPORTED_DTYPES for x in xs) and \
        _native_ops.available()


@torch.library.custom_op(f"{_NS}::grouped_allreduce", mutates_args=())
def _grouped_op(xs: List[torch.Tensor], base: str, op: int,
                wire: Optional[torch.dtype],
                ps_id: int) -> List[torch.Tensor]:
    """Every tensor enqueued, then every one synchronized: the engine's
    controller sees the whole group outstanding and fuses it."""
    if _native_eligible(xs, wire):
        from horovod_tpu_torch.torch import _native_ops

        ps_size = _set(ps_id).validate(basics.rank(), basics.size())[1] \
            if ps_id else 0
        _native_ops.dispatched["grouped_allreduce"] += 1
        # single=0: the entries are named <base>.<i> as on the eager path.
        return list(torch.ops.hvd.grouped_allreduce(
            xs, base, op, 1.0, 1.0, ps_id, ps_size, 0))
    comp, ps = _compressor(wire), _set(ps_id)
    handles = [eager.allreduce_async(x, name=f"{base}.{i}", op=ReduceOp(op),
                                     compression=comp, process_set=ps)
               for i, x in enumerate(xs)]
    return [eager.synchronize(h) for h in handles]


@_grouped_op.register_fake
def _(xs, base, op, wire, ps_id):
    return [torch.empty_like(x) for x in xs]


def _grouped_setup(ctx, inputs, output):
    xs, base, op, wire, ps_id = inputs
    ctx.args = (base + ".grad", op, wire, ps_id)
    ctx.like = [(x.shape, x.dtype, x.device) for x in xs]


def _grouped_backward(ctx, grads):
    grads = [torch.zeros(s, dtype=d, device=v) if g is None
             else g.contiguous()
             for g, (s, d, v) in zip(grads, ctx.like)]
    return _grouped_op(grads, *ctx.args), None, None, None, None


_grouped_op.register_autograd(_grouped_backward,
                              setup_context=_grouped_setup)


def grouped_allreduce(tensors, name: Optional[str] = None,
                      op: ReduceOp = ReduceOp.AVERAGE,
                      compression=None, process_set=None):
    """Allreduce a list (or tuple) of tensors through the engine with the
    controller's fusion, inside ``torch.compile``: the gradient reduction
    of a compiled step.  Entries are named ``<base>.<i>`` in order."""
    if not tensors:
        return tensors
    outs = _grouped_op(list(tensors), _auto_name("grouped_allreduce", name),
                       int(op), _wire(compression), _ps_id(process_set))
    return tuple(outs) if isinstance(tensors, tuple) else outs


# ---------------------------------------------------------------------------
# allgather


@torch.library.custom_op(f"{_NS}::allgather", mutates_args=())
def _allgather_op(x: torch.Tensor, name: str,
                  ps_id: int) -> torch.Tensor:
    return eager.allgather(x, name=name, process_set=_set(ps_id))


@_allgather_op.register_fake
def _(x, name, ps_id):
    n = _group_size(ps_id)
    if x.dim() == 0:
        return x.new_empty((n,))
    return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))


def _allgather_setup(ctx, inputs, output):
    x, name, ps_id = inputs
    ctx.args = (name, ps_id)
    ctx.shape = tuple(x.shape)


def _allgather_backward(ctx, grad):
    # Sum-allreduce the gradient and take this rank's rows.
    name, ps_id = ctx.args
    summed = _allreduce_op(grad.contiguous(), name + ".grad",
                           int(ReduceOp.SUM), 1.0, 1.0, None, ps_id)
    d0 = ctx.shape[0] if ctx.shape else 1
    seg = summed.narrow(0, _group_index(ps_id) * d0, d0)
    return seg.reshape(ctx.shape), None, None


_allgather_op.register_autograd(_allgather_backward,
                                setup_context=_allgather_setup)


def allgather(x: torch.Tensor, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """First-dim allgather through the engine, inside ``torch.compile``.
    Static shapes: every rank contributes the same shape (the ragged
    first dim negotiates only on the eager path)."""
    return _allgather_op(x, _auto_name("allgather", name),
                         _ps_id(process_set))


# ---------------------------------------------------------------------------
# broadcast


@torch.library.custom_op(f"{_NS}::broadcast", mutates_args=())
def _broadcast_op(x: torch.Tensor, name: str, root_rank: int,
                  ps_id: int) -> torch.Tensor:
    return eager.broadcast(x, root_rank, name=name,
                           process_set=_set(ps_id))


@_broadcast_op.register_fake
def _(x, name, root_rank, ps_id):
    return torch.empty_like(x)


def _broadcast_setup(ctx, inputs, output):
    _, name, root_rank, ps_id = inputs
    ctx.args = (name, root_rank, ps_id)


def _broadcast_backward(ctx, grad):
    name, root_rank, ps_id = ctx.args
    g = _allreduce_op(grad.contiguous(), name + ".grad", int(ReduceOp.SUM),
                      1.0, 1.0, None, ps_id)
    if basics.rank() != root_rank:
        g = torch.zeros_like(g)
    return g, None, None, None


_broadcast_op.register_autograd(_broadcast_backward,
                                setup_context=_broadcast_setup)


def broadcast(x: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """Negotiated broadcast inside ``torch.compile``.  Gradient: the Sum
    allreduce on the root, zero elsewhere."""
    return _broadcast_op(x, _auto_name("broadcast", name), int(root_rank),
                         _ps_id(process_set))


# ---------------------------------------------------------------------------
# reducescatter / alltoall / barrier (no gradient)


@torch.library.custom_op(f"{_NS}::reducescatter", mutates_args=())
def _reducescatter_op(x: torch.Tensor, name: str, op: int,
                      ps_id: int) -> torch.Tensor:
    return eager.reducescatter(x, name=name, op=ReduceOp(op),
                               process_set=_set(ps_id))


@_reducescatter_op.register_fake
def _(x, name, op, ps_id):
    # The engine's near-equal split (``cpu_backend._chunk_bounds``: the
    # first ``n % parts`` chunks one row longer) as one expression, which
    # a symbolic row count also takes.
    parts, me = _group_size(ps_id), _group_index(ps_id)
    rows = (x.shape[0] - me + parts - 1) // parts
    return x.new_empty((rows,) + tuple(x.shape[1:]))


def reducescatter(x: torch.Tensor, name: Optional[str] = None,
                  op: ReduceOp = ReduceOp.AVERAGE,
                  process_set=None) -> torch.Tensor:
    """Reduce and scatter over dim 0 inside ``torch.compile``: this rank's
    near-equal row chunk, whose shape is known at trace time."""
    if op not in (ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.MIN,
                  ReduceOp.MAX, ReduceOp.PRODUCT):
        raise ValueError(f"reducescatter does not support op {op}")
    if x.dim() == 0:
        raise ValueError(
            "reducescatter needs at least one dimension to scatter over "
            "(got a scalar)")
    return _reducescatter_op(x, _auto_name("reducescatter", name), int(op),
                             _ps_id(process_set))


@torch.library.custom_op(f"{_NS}::alltoall", mutates_args=())
def _alltoall_op(x: torch.Tensor, name: str,
                 ps_id: int) -> torch.Tensor:
    out = eager.alltoall(x, name=name, process_set=_set(ps_id))
    return out[0] if isinstance(out, tuple) else out


@_alltoall_op.register_fake
def _(x, name, ps_id):
    return torch.empty_like(x)


def alltoall(x: torch.Tensor, name: Optional[str] = None,
             process_set=None) -> torch.Tensor:
    """Equal-split alltoall inside ``torch.compile`` (dim 0 divisible by
    the group's size; ragged splits are eager-only)."""
    n = _group_size(_ps_id(process_set))
    if x.shape[0] % n:
        raise ValueError(
            f"bridge alltoall needs dim 0 ({x.shape[0]}) divisible by "
            f"group size ({n}); ragged splits are eager-only")
    return _alltoall_op(x, _auto_name("alltoall", name),
                        _ps_id(process_set))


@torch.library.custom_op(f"{_NS}::barrier", mutates_args=())
def _barrier_op(ps_id: int) -> torch.Tensor:
    eager.barrier(process_set=_set(ps_id))
    return torch.zeros((), dtype=torch.int32)


@_barrier_op.register_fake
def _(ps_id):
    return torch.empty((), dtype=torch.int32)


def barrier(process_set=None) -> torch.Tensor:
    """Engine barrier inside ``torch.compile``; returns an int32 token
    (use it, so that the compiler cannot drop the call)."""
    return _barrier_op(_ps_id(process_set))


for _op in (_allreduce_op, _grouped_op, _allgather_op, _broadcast_op,
            _reducescatter_op, _alltoall_op):
    torch.library.register_vmap(_op, _refuse_vmap)
del _op
