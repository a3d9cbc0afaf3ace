"""Collective ops of the classic torch front-end, over the port's eager
engine: the port of ``horovod_tpu/torch/mpi_ops.py``.

Sync, async and in-place forms of allreduce, grouped allreduce,
allgather, reducescatter, broadcast and alltoall (with splits);
``poll`` / ``synchronize`` on integer handles, ``join`` and ``barrier``;
and the autograd Functions with the reference's gradients: the gradient
of an allreduce is the same allreduce of the gradient, an allgather's is
this rank's rows of the summed gradient, a broadcast's is the gradient
summed to the root and zero elsewhere.  The names are the JAX front-end's
(``torch.allreduce.noname.<n>`` and so on, one counter per kind shared
with the eager layer), so that a port rank and a JAX rank pair the same
tensors.  Handles are the eager layer's (``ops/eager.py``): a handle from
either surface can be synchronized by the other.

Devices: a CUDA tensor goes to the engine as a host copy made at enqueue
by ``Tensor.to("cpu")`` on the current stream.  That copy waits for the
work queued on the stream before it, so it reads the tensor only after
its producer has written it; in a gradient hook (``torch/__init__.py``)
the current stream is the one autograd ran the gradient's accumulation
on.  The result comes back on the tensor's device in its dtype; an
in-place form then copies it into the caller's storage, so the result is
the caller's tensor, on its device, with no host copy left as the result.
Unlike the JAX front-end, bfloat16 and fp8 tensors are taken too.

On the native engine, the sync allreduce (its autograd form and
``allreduce_``), allgather and broadcast of a CPU tensor run the C++
core's dispatcher ops (``torch.ops.hvd.*``, ``torch/_native_ops.py``)
where the JAX front-end does (:func:`_native_dispatch`): the kernel
enqueues the tensor's own storage, with no numpy round trip.  CUDA
tensors keep the host copy above, as in the JAX package;
``HVD_TORCH_NATIVE_OPS=0`` turns the dispatcher ops off.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import eager
from horovod_tpu_torch.ops.eager import (  # noqa: F401  (re-exported)
    _auto_name,
    _resolve_op,
    poll,
    synchronize,
)
from horovod_tpu_torch.torch import _native_ops

# Reference-named ReduceOp constants (mpi_ops.py re-exports these).
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def _native_dispatch(tensor: torch.Tensor, process_set):
    """(True, ps_id, ps_size) when the C++ core's dispatcher ops can serve
    ``tensor``: a CPU tensor of a dtype they take, on the native engine;
    else (False, 0, 0)."""
    if tensor.device.type != "cpu" or \
            str(tensor.dtype) not in _native_ops.SUPPORTED_DTYPES:
        return False, 0, 0
    if not _native_ops.available():
        return False, 0, 0
    ps_id, ps_size = 0, 0
    if process_set is not None:
        ps_id, ps_size = process_set.validate(basics.rank(),
                                              basics.size())
    return True, ps_id, ps_size


def _then(handle: int, fn) -> int:
    """Apply ``fn`` to ``handle``'s result at ``synchronize``, after the
    eager layer's own postprocess."""
    with eager._post_lock:
        post = eager._post.get(handle)
        eager._post[handle] = lambda raw: fn(post(raw) if post else raw)
    return handle


def _shaped(handle: int, shape) -> int:
    """The result in the input's shape (a 0-d tensor's comes back 1-d)."""
    return _then(handle, lambda out: out.reshape(shape))


def _into(handle: int, tensor: torch.Tensor) -> int:
    """Make ``handle``'s result land in ``tensor`` (an in-place form)."""
    def copy(out):
        with torch.no_grad():
            tensor.copy_(out.reshape(tensor.shape))
        return tensor

    return _then(handle, copy)


def join() -> int:
    """Signals that this rank is out of data; blocks until every rank
    joins.  Returns the last joined rank."""
    return eager.join()


def barrier(process_set=None) -> None:
    eager.barrier(process_set=process_set)


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> int:
    return _shaped(eager.allreduce_async(
        tensor, average, _auto_name("torch.allreduce", name), op,
        prescale_factor, postscale_factor, process_set=process_set),
        tensor.shape)


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> int:
    """In-place: the reduced values are written back into ``tensor``."""
    return _into(allreduce_async(tensor, average, name, op,
                                 prescale_factor, postscale_factor,
                                 process_set), tensor)


class _HorovodAllreduce(torch.autograd.Function):
    """The gradient of an allreduce is the same allreduce of the upstream
    gradient, over the same process set."""

    @staticmethod
    def forward(ctx, tensor, average, name, op, prescale, postscale,
                process_set=None):
        ctx.average = average
        ctx.op = op
        ctx.prescale = prescale
        ctx.postscale = postscale
        ctx.process_set = process_set
        native, ps_id, ps_size = _native_dispatch(tensor, process_set)
        if native:
            # The backward comes back with name=None: draw from the
            # counter the numpy path would.
            nm = name if name is not None \
                else _auto_name("torch.allreduce", None)
            _native_ops.dispatched["allreduce"] += 1
            return torch.ops.hvd.allreduce(
                tensor, nm, int(_resolve_op(op, average)),
                float(prescale), float(postscale), ps_id, ps_size)
        return synchronize(allreduce_async(tensor, average, name, op,
                                           prescale, postscale,
                                           process_set))

    @staticmethod
    def backward(ctx, grad_output):
        reduced = _HorovodAllreduce.apply(
            grad_output, ctx.average, None, ctx.op, ctx.prescale,
            ctx.postscale, ctx.process_set)
        return reduced, None, None, None, None, None, None


def allreduce(tensor, average=None, name=None, compression=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              process_set=None) -> torch.Tensor:
    """Differentiable allreduce returning a new tensor."""
    from horovod_tpu_torch.torch.compression import Compression

    compression = compression or Compression.none
    compressed, ctx = compression.compress(tensor)
    reduced = _HorovodAllreduce.apply(
        compressed, average, _auto_name("torch.allreduce", name), op,
        prescale_factor, postscale_factor, process_set)
    return compression.decompress(reduced, ctx)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               process_set=None) -> torch.Tensor:
    native, ps_id, ps_size = _native_dispatch(tensor, process_set)
    if native and tensor.is_contiguous():
        # The in-place dispatcher op reduces in the caller's storage.
        nm = name if name is not None \
            else _auto_name("torch.allreduce", None)
        _native_ops.dispatched["allreduce_"] += 1
        return torch.ops.hvd.allreduce_(
            tensor, nm, int(_resolve_op(op, average)),
            float(prescale_factor), float(postscale_factor), ps_id,
            ps_size)
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        prescale_factor, postscale_factor,
                                        process_set))


def grouped_allreduce_async(tensors, average=None, name=None,
                            op=None, process_set=None) -> list:
    base = _auto_name("torch.grouped", name)
    return [allreduce_async(t, average, f"{base}.{i}", op,
                            process_set=process_set)
            for i, t in enumerate(tensors)]


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      process_set=None) -> list:
    return [synchronize(h)
            for h in grouped_allreduce_async(tensors, average, name, op,
                                             process_set)]


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------


def allgather_async(tensor, name=None, process_set=None) -> int:
    return eager.allgather_async(
        tensor, _auto_name("torch.allgather", name), process_set)


class _HorovodAllgather(torch.autograd.Function):
    """Backward allreduces the gradient (Sum, over the same process set)
    and narrows it to this rank's rows.  First dims may differ per rank,
    so the offset comes from gathering the per-rank sizes."""

    @staticmethod
    def forward(ctx, tensor, name, process_set=None):
        ctx.dim0 = tensor.shape[0] if tensor.dim() > 0 else 1
        ctx.process_set = process_set
        native, ps_id, ps_size = _native_dispatch(tensor, process_set)
        if native:
            nm = name if name is not None \
                else _auto_name("torch.allgather", None)
            _native_ops.dispatched["allgather"] += 1
            return torch.ops.hvd.allgather(tensor, nm, ps_id, ps_size)
        return synchronize(allgather_async(tensor, name, process_set))

    @staticmethod
    def backward(ctx, grad_output):
        ps = ctx.process_set
        grad_reduced = _HorovodAllreduce.apply(
            grad_output, None, None, ReduceOp.SUM, 1.0, 1.0, ps)
        sizes = synchronize(allgather_async(
            torch.tensor([ctx.dim0], dtype=torch.int64), None, ps))
        my_pos = ps.rank() if ps is not None else basics.rank()
        offset = int(sizes[:my_pos].sum())
        return grad_reduced.narrow(0, offset, ctx.dim0), None, None


def allgather(tensor, name=None, process_set=None) -> torch.Tensor:
    """Differentiable allgather: concatenation along dim 0 across ranks
    (first dims may differ per rank)."""
    return _HorovodAllgather.apply(tensor,
                                   _auto_name("torch.allgather", name),
                                   process_set)


# ---------------------------------------------------------------------------
# reducescatter
# ---------------------------------------------------------------------------


def reducescatter_async(tensor, average=None, name=None, op=None,
                        process_set=None) -> int:
    """Reduce across ranks, scatter over dim 0: rank r receives the r-th
    near-equal row chunk."""
    if _resolve_op(op, average) == ReduceOp.ADASUM:
        raise ValueError("reducescatter does not support op Adasum")
    return eager.reducescatter_async(
        tensor, average, _auto_name("torch.reducescatter", name), op,
        process_set)


def reducescatter(tensor, average=None, name=None, op=None,
                  process_set=None) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, average, name, op,
                                           process_set))


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------


def broadcast_async(tensor, root_rank, name=None,
                    process_set=None) -> int:
    return _shaped(eager.broadcast_async(
        tensor, root_rank, _auto_name("torch.broadcast", name),
        process_set), tensor.shape)


def broadcast_async_(tensor, root_rank, name=None,
                     process_set=None) -> int:
    return _into(broadcast_async(tensor, root_rank, name, process_set),
                 tensor)


class _HorovodBroadcast(torch.autograd.Function):
    """Backward sums the gradients to the root (over the same process
    set); non-root ranks receive zero."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name, process_set=None):
        ctx.root_rank = root_rank
        ctx.process_set = process_set
        native, ps_id, ps_size = _native_dispatch(tensor, process_set)
        if native:
            nm = name if name is not None \
                else _auto_name("torch.broadcast", None)
            _native_ops.dispatched["broadcast"] += 1
            return torch.ops.hvd.broadcast(tensor, nm, int(root_rank),
                                           ps_id, ps_size)
        return synchronize(broadcast_async(tensor, root_rank, name,
                                           process_set))

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = _HorovodAllreduce.apply(
            grad_output, None, None, ReduceOp.SUM, 1.0, 1.0,
            ctx.process_set)
        if basics.rank() != ctx.root_rank:
            grad_reduced = grad_reduced * 0
        return grad_reduced, None, None, None


def broadcast(tensor, root_rank, name=None,
              process_set=None) -> torch.Tensor:
    return _HorovodBroadcast.apply(tensor, root_rank,
                                   _auto_name("torch.broadcast", name),
                                   process_set)


def broadcast_(tensor, root_rank, name=None,
               process_set=None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------


def alltoall_async(tensor, splits=None, name=None,
                   process_set=None) -> int:
    h = eager.alltoall_async(tensor, splits,
                             _auto_name("torch.alltoall", name),
                             process_set)
    want_splits = splits is not None
    send_splits = None if splits is None else [int(s) for s in splits]

    def finalize(out):
        if isinstance(out, tuple):
            data, recv_splits = out
        else:
            # A one-rank engine returns the bare tensor: you receive what
            # you sent, so the received splits are the sent ones.
            data, recv_splits = out, send_splits
        if not want_splits:
            return data
        return data, torch.tensor([int(s) for s in recv_splits],
                                  dtype=torch.int64)

    return _then(h, finalize)


def alltoall(tensor, splits=None, name=None, process_set=None):
    """Returns (gathered, received_splits) when splits are given, else
    just the gathered tensor."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))
