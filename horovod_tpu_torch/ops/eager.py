"""Eager (op-by-op) collectives over the engine: the port of
``horovod_tpu/ops/eager.py``.

The classic Horovod surface: sync and async variants, ``poll`` /
``synchronize`` handles, the same auto-generated names (identical call
order on every rank gives identical names, a JAX rank's included),
``broadcast_object`` and ``broadcast_parameters``.  Takes torch tensors,
numpy arrays (``ml_dtypes`` bfloat16 and fp8 arrays among them) and
Python scalars; results come back in the caller's type.

A torch tensor goes to the engine as a host copy, made at enqueue by a
copy on the current CUDA stream, after the work that produced the tensor
(``backward()`` writes gradients on that stream); the call returns once
the copy is done.  Its result comes back at ``synchronize``, on the
tensor's own device and in its dtype.  Compression (``ops/compression.py``)
casts a floating tensor to the compressor's wire type on the host, with
the rounding of the JAX package's numpy (``common/floats.py``).

The mesh-axis collectives of the compiled regime are in
``horovod_tpu_torch.ops.collective``, where the JAX package keeps theirs
(``horovod_tpu.ops.collective``).

Left out until their features are ported: the in-graph bridge (``jit``
dispatch; ROADMAP Queue 1, item 6, the torch analog is collectives as
custom ops under ``torch.compile``) and the per-collective telemetry
(item 5.5).
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.common import floats
from horovod_tpu_torch.common.types import (DataType, ReduceOp,
                                            dtype_from_numpy,
                                            dtype_from_torch,
                                            dtype_to_torch)

_counter_lock = threading.Lock()
_op_counters: Dict[str, int] = {}

# handle -> postprocess(raw_result) -> user-facing result
_post: Dict[int, Callable] = {}
_post_lock = threading.Lock()

# The torch and numpy types a narrow float's bits are viewed through on
# the host, by item size.
_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16)}


def _auto_name(kind: str, name: Optional[str]) -> str:
    """Deterministic fallback names: identical call order across ranks
    yields identical names."""
    if name is not None:
        return name
    with _counter_lock:
        c = _op_counters.get(kind, 0)
        _op_counters[kind] = c + 1
    return f"{kind}.noname.{c}"


def _restore_numpy(a: np.ndarray, dt: DataType, like: np.dtype):
    """A result of a narrow type's bits (its storage) as ``like`` (the
    input's ``ml_dtypes`` type); any other result as it is."""
    if floats.ml_dtype_of(like) is not None and \
            a.dtype == floats.storage_dtype(dt):
        return a.view(like)
    return a


def _restore_torch(a: np.ndarray, dt: DataType, like: torch.Tensor):
    """A result as a tensor on ``like``'s device in ``like``'s dtype."""
    a = np.ascontiguousarray(a)
    if dt in (DataType.BFLOAT16, DataType.FLOAT8_E4M3,
              DataType.FLOAT8_E5M2) and a.dtype == floats.storage_dtype(dt):
        t = torch.from_numpy(a.view(_BITS[a.itemsize][1])).view(
            dtype_to_torch(dt))
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _to_numpy(x) -> Tuple[np.ndarray, Optional[DataType],
                          Callable[[np.ndarray], Any]]:
    """The host array for ``x`` (a narrow float's bits in its numpy
    storage), its wire type where the array alone does not say it, and a
    function that turns a result back into ``x``'s kind."""
    if isinstance(x, torch.Tensor):
        dt = dtype_from_torch(x.dtype)
        host = x.detach()
        if host.device.type != "cpu":
            host = host.to("cpu")  # after the stream's pending work
        if dt in (DataType.BFLOAT16, DataType.FLOAT8_E4M3,
                  DataType.FLOAT8_E5M2):
            arr = host.view(_BITS[host.element_size()][0]).numpy().view(
                floats.storage_dtype(dt))
        else:
            arr = host.numpy()
        return arr, dt, lambda a: _restore_torch(a, dt, x)
    arr = np.asarray(x)
    ml = floats.ml_dtype_of(arr.dtype)
    if ml is not None:
        like = arr.dtype
        return (arr.view(floats.storage_dtype(ml)), ml,
                lambda a: _restore_numpy(a, ml, like))
    if arr.dtype == np.float64 and not isinstance(x, np.ndarray):
        # Python floats become fp32, as in the frameworks.
        arr = arr.astype(np.float32)
    return arr, None, lambda a: a


def _register(handle: int, fn: Callable) -> int:
    with _post_lock:
        _post[handle] = fn
    return handle


def poll(handle: int) -> bool:
    return basics._engine().poll(handle)


def synchronize(handle: int):
    """Wait for an async op; returns its result."""
    raw = basics._engine().synchronize(handle)
    with _post_lock:
        fn = _post.pop(handle, None)
    return fn(raw) if fn else raw


def _resolve_op(op: Optional[ReduceOp], average: Optional[bool]) -> ReduceOp:
    """Reconcile ``op=`` with the classic ``average=`` flag (mutually
    exclusive)."""
    if average is not None:
        if op is not None:
            raise ValueError(
                "The op parameter supersedes average; pass only one")
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    return ReduceOp.AVERAGE if op is None else op


def _wire_type(compression) -> Optional[DataType]:
    """The compressor's wire type, or None for no compression."""
    wire = getattr(compression, "wire_dtype", None)
    return None if wire is None else dtype_from_torch(wire)


def _np_compress(compression, arr: np.ndarray, dt: DataType):
    """Cast a floating host array (fp16, fp32, fp64) to the wire type;
    returns (array, its type, the type to restore or None)."""
    wire = _wire_type(compression)
    if wire is None or arr.dtype.kind != "f" or dt == wire:
        return arr, dt, None
    return floats.cast(arr, dt, wire), wire, dt


def _np_decompress(raw: np.ndarray, wire: DataType, ctx: DataType):
    if raw.dtype == floats.storage_dtype(wire):
        return floats.cast(raw, wire, ctx)
    return raw.astype(floats.storage_dtype(ctx))


def allreduce_async(tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None, process_set=None) -> int:
    """Positional order as in Horovod (tensor, average, name)."""
    op = _resolve_op(op, average)
    arr, dt, restore = _to_numpy(tensor)
    dt = dt if dt is not None else dtype_from_numpy(arr.dtype)
    comp_arr, wire, ctx = _np_compress(compression, arr, dt)
    h = basics._engine().allreduce_async(
        _auto_name("allreduce", name), comp_arr, op=op,
        prescale=prescale_factor, postscale=postscale_factor,
        process_set=process_set, dtype=wire)

    def post(raw):
        if ctx is not None:
            raw = _np_decompress(raw, wire, ctx)
        return restore(raw)

    return _register(h, post)


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None,
              op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              compression=None, process_set=None):
    return synchronize(allreduce_async(
        tensor, average, name, op, prescale_factor, postscale_factor,
        compression, process_set))


def grouped_allreduce(tensors: List, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      process_set=None) -> List:
    """Entries negotiate one by one and fuse in the controller as
    individually submitted tensors do."""
    op = _resolve_op(op, average)
    base = _auto_name("grouped_allreduce", name)
    handles = [allreduce_async(t, name=f"{base}.{i}", op=op,
                               process_set=process_set)
               for i, t in enumerate(tensors)]
    return [synchronize(h) for h in handles]


def allgather_async(tensor, name: Optional[str] = None,
                    process_set=None) -> int:
    arr, dt, restore = _to_numpy(tensor)
    h = basics._engine().allgather_async(
        _auto_name("allgather", name), arr, process_set=process_set,
        dtype=dt)
    return _register(h, restore)


def allgather(tensor, name: Optional[str] = None, process_set=None):
    return synchronize(allgather_async(tensor, name, process_set))


def sparse_allreduce(values, indices, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None):
    """Sparse (IndexedSlices-style) allreduce of embedding-row gradients:
    allgathers each rank's values and indices, duplicates accumulating
    when applied.  Returns ``(values, indices)``, the values divided by
    ``size()`` when the op is Average.  Apply with a scatter-add, e.g.
    ``param.index_add_(0, indices, -lr * values)``."""
    rop = _resolve_op(op, average)
    if rop not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(
            f"sparse_allreduce supports Average/Sum, got {rop}")
    base = _auto_name("sparse_allreduce", name)
    hv = allgather_async(values, name=f"{base}.values")
    hi = allgather_async(indices, name=f"{base}.indices")
    out_values = synchronize(hv)
    out_indices = synchronize(hi)
    if rop == ReduceOp.AVERAGE:
        out_values = out_values / basics.size()
    return out_values, out_indices


def reducescatter_async(tensor, average: Optional[bool] = None,
                        name: Optional[str] = None,
                        op: Optional[ReduceOp] = None,
                        process_set=None) -> int:
    """Reduce across ranks, scatter over dim 0 (rank r gets the r-th
    near-equal row chunk).  The mesh-axis twin is
    ``ops.collective.reduce_scatter``."""
    rop = _resolve_op(op, average)
    if rop not in (ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.MIN,
                   ReduceOp.MAX, ReduceOp.PRODUCT):
        raise ValueError(f"reducescatter does not support op {rop}")
    if np.ndim(tensor) == 0:
        raise ValueError(
            "reducescatter needs at least one dimension to scatter over "
            "(got a scalar)")
    arr, dt, restore = _to_numpy(tensor)
    h = basics._engine().reducescatter_async(
        _auto_name("reducescatter", name), arr, op=rop,
        process_set=process_set, dtype=dt)
    return _register(h, restore)


def reducescatter(tensor, average: Optional[bool] = None,
                  name: Optional[str] = None,
                  op: Optional[ReduceOp] = None, process_set=None):
    return synchronize(reducescatter_async(tensor, average, name, op,
                                           process_set))


def broadcast_async(tensor, root_rank: int = 0,
                    name: Optional[str] = None, process_set=None) -> int:
    arr, dt, restore = _to_numpy(tensor)
    h = basics._engine().broadcast_async(
        _auto_name("broadcast", name), arr, root_rank=root_rank,
        process_set=process_set, dtype=dt)
    return _register(h, restore)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              process_set=None):
    return synchronize(broadcast_async(tensor, root_rank, name,
                                       process_set))


def alltoall_async(tensor, splits=None, name: Optional[str] = None,
                   process_set=None) -> int:
    arr, dt, restore = _to_numpy(tensor)
    if splits is not None:
        splits = [int(s) for s in np.asarray(splits)]
    h = basics._engine().alltoall_async(
        _auto_name("alltoall", name), arr, splits=splits,
        process_set=process_set, dtype=dt)

    def post(raw):
        if isinstance(raw, tuple):
            data, recv_splits = raw
            return restore(data), recv_splits
        return restore(raw)

    return _register(h, post)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set=None):
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def barrier(process_set=None) -> None:
    basics._engine().barrier(process_set=process_set)


def join() -> int:
    """A rank out of data joins: until every rank has, it contributes
    zeros to the others' allreduces.  Returns the last rank that
    joined."""
    return basics._engine().join()


def broadcast_object(obj, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Broadcast any picklable object from ``root_rank``."""
    name = _auto_name("broadcast_object", name)
    if basics.rank() == root_rank:
        payload = np.frombuffer(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
            dtype=np.uint8).copy()
        n = np.array([payload.size], np.int64)
    else:
        payload = None
        n = np.zeros(1, np.int64)
    n = broadcast(n, root_rank, name=f"{name}.len")
    if payload is None:
        payload = np.zeros(int(n[0]), np.uint8)
    payload = broadcast(payload, root_rank, name=f"{name}.data")
    return pickle.loads(payload.tobytes())


def _flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """Leaves in ``jax.tree.flatten``'s order for a dict (keys sorted),
    list or tuple, recursively (None has no leaves), and the function that
    rebuilds the structure from new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        kind = type(tree)

        def build(leaves):
            out, i = [], 0
            for (sub, rebuild) in parts:
                out.append(rebuild(leaves[i:i + len(sub)]))
                i += len(sub)
            d = dict(zip(keys, out))
            return kind(d) if kind is not dict else d

        return [x for sub, _ in parts for x in sub], build
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]

        def build(leaves):
            out, i = [], 0
            for (sub, rebuild) in parts:
                out.append(rebuild(leaves[i:i + len(sub)]))
                i += len(sub)
            return type(tree)(out)

        return [x for sub, _ in parts for x in sub], build
    if tree is None:
        return [], lambda leaves: None
    return [tree], lambda leaves: leaves[0]


def broadcast_parameters(params, root_rank: int = 0,
                         prefix: str = "bcast_param") -> Any:
    """Broadcast every tensor of a ``state_dict`` (or a nested dict, list
    or tuple of tensors and arrays) from ``root_rank``; returns the same
    structure with the root's values.  Leaves are named
    ``<prefix>.<i>`` in sorted-key order, the order JAX flattens a dict
    in, so that port ranks and JAX ranks pair the same leaves."""
    leaves, build = _flatten(params)
    handles = [broadcast_async(leaf, root_rank, name=f"{prefix}.{i}")
               for i, leaf in enumerate(leaves)]
    return build([synchronize(h) for h in handles])
