"""TensorFlow 2 front-end: ``import horovod_tpu_torch.tensorflow as hvd``.
The port of ``horovod_tpu/tensorflow/__init__.py``.

Role parity: ``horovod/tensorflow/__init__.py`` + ``tensorflow/mpi_ops.py``
— allreduce/allgather/broadcast on tf tensors with gradient support,
``broadcast_variables``, ``DistributedGradientTape``, and a Keras-3
``DistributedOptimizer``.  Each op is a ``tf.py_function`` bridge into the
port's eager layer (``horovod_tpu_torch/ops/eager.py``): the op executes
eagerly at graph runtime, so the same engine serves eager code and
compiled ``tf.function`` graphs, under the JAX front-end's op names, so
that a JAX TF rank and a port TF rank make one gang.  On the native core
the C++ kernels of ``csrc/tf_ops.cc`` (``_native_ops.py``) serve the
allreduce, grouped allreduce, broadcast and allgather of their dtypes
instead, as in the JAX package.

``init`` and the other basics are ``horovod_tpu_torch.basics``'s: with no
card ``init()`` raises ``NoCudaDeviceError``, as every entry point of the
port does, so a TF rank passes ``device="cpu"`` (and ``backend="none"``
where it needs no torch process group).  Nothing is left out.
"""

from __future__ import annotations

import tensorflow as tf

from horovod_tpu_torch.basics import (  # noqa: F401
    cache_stats,
    cross_rank,
    cross_size,
    cuda_built,
    gloo_built,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
    xla_built,
)
from horovod_tpu_torch import basics
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops.eager import _auto_name, _resolve_op

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


class Compression:
    """fp16-on-the-wire gradient compression (parity:
    tensorflow/compression.py)."""

    class none:
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class fp16:
        @staticmethod
        def compress(t):
            if t.dtype.is_floating and t.dtype != tf.float16:
                return tf.cast(t, tf.float16), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return tf.cast(t, ctx) if ctx is not None else t


def _engine_call(fn, x, out_dtype):
    """Run an engine collective on a tf tensor; works in eager mode and
    inside tf.function (py_function escapes the graph at runtime, which
    is exactly where the reference's AsyncOpKernel enqueued)."""
    y = tf.py_function(lambda v: fn(v.numpy()), [x], out_dtype)
    return y


def _native_kernels(x, process_set):
    """(op_library, ps_id, ps_size) when the C++ custom kernels
    (csrc/tf_ops.cc — real graph ops into the native engine, the
    reference's mpi_ops.cc mechanism) can serve this tensor, else
    (None, 0, 0) and the py_function path runs."""
    from horovod_tpu_torch.tensorflow import _native_ops

    if x.dtype.name not in _native_ops.SUPPORTED_DTYPES:
        return None, 0, 0
    nlib = _native_ops.lib()
    if nlib is None:
        return None, 0, 0
    ps_id, ps_size = 0, 0
    if process_set is not None:
        ps_id, ps_size = process_set.validate(rank(), size())
    return nlib, ps_id, ps_size


def allreduce(tensor, average=None, device_dense="", device_sparse="",
              compression=Compression.none, op=None, name=None,
              process_set=None):
    """Differentiable allreduce of a tf.Tensor (or IndexedSlices, which
    gather values+indices like the reference, tensorflow/__init__.py:74)."""
    if isinstance(tensor, tf.IndexedSlices):
        # Sparse gradient path: allgather values and indices (over the
        # process set when given — a silently-global gather would
        # deadlock set members against non-members).  The indices gather
        # is control-chained behind the values gather: both kernels are
        # synchronous, so two ranks whose executors pick opposite orders
        # for these independent nodes would block each other forever
        # (see grouped_allreduce).
        values = allgather(tensor.values, name=f"{name}.values"
                           if name else None, process_set=process_set)
        with tf.control_dependencies([values]):
            indices = allgather(tensor.indices, name=f"{name}.indices"
                                if name else None,
                                process_set=process_set)
        rop = _resolve_op(op, average)
        if rop == ReduceOp.AVERAGE:
            values = values / (process_set.size()
                               if process_set is not None else size())
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)
    rop = _resolve_op(op, average)
    nm = _auto_name("tf.allreduce", name)
    compressed, ctx = compression.compress(tf.convert_to_tensor(tensor))

    @tf.custom_gradient
    def _fn(x):
        nlib, ps_id, ps_size = _native_kernels(x, process_set)
        if nlib is not None:
            y = nlib.hvd_allreduce(
                x, tensor_name=nm, reduce_op=int(rop),
                process_set_id=ps_id, process_set_size=ps_size)
        else:
            y = _engine_call(
                lambda v: _eager.allreduce(v, op=rop, name=nm,
                                           process_set=process_set),
                x, x.dtype)
            # The engine flattens 0-d scalars to shape (1,); restore.
            y = tf.reshape(y, tf.shape(x))
            y.set_shape(x.shape)

        def grad(dy):
            # Derived (trace-time) names keep every rank's runtime naming
            # identical even when TF executes py_functions concurrently.
            return allreduce(dy, op=rop, name=f"{nm}.grad",
                             process_set=process_set)

        return y, grad

    return compression.decompress(_fn(compressed), ctx)


def grouped_allreduce(tensors, average=None, name=None,
                      compression=Compression.none, op=None,
                      process_set=None):
    """Allreduce a list of dense tensors through ONE graph node that
    submits every tensor to the engine before waiting on any result.

    This is not just a fusion aid — it is the deadlock-safe way to
    reduce a set of gradients.  The per-tensor collective kernels are
    synchronous (py_function and csrc/tf_ops.cc both enqueue-and-wait),
    and TF executes independent graph nodes in arbitrary,
    scheduler-dependent order: under a small executor thread pool two
    ranks can each block inside a *different* tensor's collective and
    starve the submissions the peer is waiting for (observed as the
    stall inspector reporting e.g. ``do.2 ready on [1]`` / ``do.4 ready
    on [0]`` forever).  One grouped node makes each rank's submission
    set atomic, so scheduling order cannot split it.  (The reference
    grew ``hvd.grouped_allreduce`` one release after v0.19 for the
    fusion half of this story.)

    Differentiable: the gradient is the grouped allreduce of the
    upstream gradients under the same op (the grouped twin of
    ``allreduce``'s registered gradient).
    """
    if not tensors:
        return []
    rop = _resolve_op(op, average)
    base = _auto_name("tf.grouped_allreduce", name)
    xs = [tf.convert_to_tensor(t) for t in tensors]
    comp = [compression.compress(x) for x in xs]
    cxs = [c for c, _ in comp]

    @tf.custom_gradient
    def _fn(*cxs):
        from horovod_tpu_torch.tensorflow import _native_ops

        nlib, ps_id, ps_size = _native_kernels(cxs[0], process_set)
        if nlib is not None and hasattr(nlib, "hvd_grouped_allreduce") \
                and all(c.dtype.name in _native_ops.SUPPORTED_DTYPES
                        for c in cxs):
            # One variadic C++ kernel: enqueue-all-then-wait inside the
            # op (csrc/tf_ops.cc::HvdGroupedAllreduceOp) — same
            # atomic-submission guarantee, no py_function/numpy hop.
            ys = nlib.hvd_grouped_allreduce(
                list(cxs), tensor_name=base, reduce_op=int(rop),
                process_set_id=ps_id, process_set_size=ps_size)
        else:
            def _py(*arrs):
                outs = _eager.grouped_allreduce(
                    [a.numpy() for a in arrs], op=rop, name=base,
                    process_set=process_set)
                return list(outs)

            ys = tf.py_function(_py, list(cxs), [c.dtype for c in cxs])
        if len(cxs) == 1:
            ys = [ys] if tf.is_tensor(ys) else list(ys)
        fixed = []
        for y, cx in zip(ys, cxs):
            # The engine flattens 0-d scalars to shape (1,); restore.
            y = tf.reshape(y, tf.shape(cx))
            y.set_shape(cx.shape)
            fixed.append(y)

        def grad(*dys):
            # An unused output arrives as dy=None; it must still ride
            # the grouped collective (every rank submits the same set),
            # so substitute zeros.
            dys = [tf.zeros_like(cx) if d is None else d
                   for d, cx in zip(dys, cxs)]
            return grouped_allreduce(dys, op=rop, name=f"{base}.grad",
                                     process_set=process_set)

        return tuple(fixed), grad

    ys = _fn(*cxs)
    if tf.is_tensor(ys):
        ys = [ys]
    return [compression.decompress(y, ctx)
            for y, (_, ctx) in zip(ys, comp)]


def allgather(tensor, name=None, process_set=None):
    """Differentiable allgather: concat along dim 0 (ragged first dims
    allowed); backward reduces and extracts this rank's segment."""
    nm = _auto_name("tf.allgather", name)
    x = tf.convert_to_tensor(tensor)
    dim0 = tf.shape(x)[0]

    @tf.custom_gradient
    def _fn(x):
        nlib, ps_id, ps_size = _native_kernels(x, process_set)
        if nlib is not None:
            y = nlib.hvd_allgather(
                x, tensor_name=nm, process_set_id=ps_id,
                process_set_size=ps_size)
        else:
            y = _engine_call(
                lambda v: _eager.allgather(v, name=nm,
                                           process_set=process_set),
                x, x.dtype)
        y.set_shape(tf.TensorShape([None]).concatenate(x.shape[1:]))

        def grad(dy):
            reduced = allreduce(dy, op=ReduceOp.SUM, name=f"{nm}.grad",
                                process_set=process_set)
            sizes = _engine_call(
                lambda v: _eager.allgather(v, name=f"{nm}.grad.sizes",
                                           process_set=process_set),
                tf.reshape(dim0, [1]), tf.int32)
            my_pos = process_set.rank() if process_set is not None \
                else rank()
            offset = tf.reduce_sum(sizes[:my_pos])
            return reduced[offset:offset + dim0]

        return y, grad

    return _fn(x)


def reducescatter(tensor, average=None, name=None, op=None,
                  process_set=None):
    """Differentiable reducescatter: reduce across ranks, scatter over
    dim 0 (rank r receives the r-th near-equal row chunk; the reference
    project added ``hvd.reducescatter`` right after the v0.19 line).
    Backward is the allgather of the per-rank chunk gradients (scaled by
    1/size for Average), mirroring the reference's grad registration."""
    nm = _auto_name("tf.reducescatter", name)
    x = tf.convert_to_tensor(tensor)
    rop = _resolve_op(op, average)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        # The registered gradient (allgather) is the Sum/Average
        # adjoint; Min/Max/Product would need a subgradient and are not
        # in the reference's TF surface either.
        raise ValueError(
            f"tf reducescatter supports Sum/Average, got {rop}")

    @tf.custom_gradient
    def _fn(x):
        y = _engine_call(
            lambda v: _eager.reducescatter(v, name=nm, op=rop,
                                           process_set=process_set),
            x, x.dtype)
        y.set_shape(tf.TensorShape([None]).concatenate(x.shape[1:]))

        def grad(dy):
            g = _engine_call(
                lambda v: _eager.allgather(v, name=f"{nm}.grad",
                                           process_set=process_set),
                dy, dy.dtype)
            g.set_shape(x.shape)
            if rop == ReduceOp.AVERAGE:
                g = g / (process_set.size() if process_set is not None
                         else size())
            return g

        return y, grad

    return _fn(x)


def broadcast(tensor, root_rank=0, name=None, process_set=None):
    """Differentiable broadcast from root; backward sums to root."""
    nm = _auto_name("tf.broadcast", name)

    @tf.custom_gradient
    def _fn(x):
        nlib, ps_id, ps_size = _native_kernels(x, process_set)
        if nlib is not None:
            y = nlib.hvd_broadcast(
                x, tensor_name=nm, root_rank=root_rank,
                process_set_id=ps_id, process_set_size=ps_size)
        else:
            y = _engine_call(
                lambda v: _eager.broadcast(v, root_rank=root_rank,
                                           name=nm,
                                           process_set=process_set),
                x, x.dtype)
            # The engine flattens 0-d scalars to shape (1,); restore.
            y = tf.reshape(y, tf.shape(x))
            y.set_shape(x.shape)

        def grad(dy):
            reduced = allreduce(dy, op=ReduceOp.SUM, name=f"{nm}.grad",
                                process_set=process_set)
            if rank() == root_rank:
                return reduced
            return reduced * 0

        return y, grad

    return _fn(tf.convert_to_tensor(tensor))


def alltoall(tensor, splits=None, name=None, process_set=None):
    nm = _auto_name("tf.alltoall", name)
    x = tf.convert_to_tensor(tensor)
    if splits is None:
        return _engine_call(
            lambda v: _eager.alltoall(v, name=nm,
                                      process_set=process_set),
            x, x.dtype)
    sp = [int(s) for s in splits]
    data, recv = tf.py_function(
        lambda v: _eager.alltoall(v.numpy(), splits=sp, name=nm,
                                  process_set=process_set),
        [x], [x.dtype, tf.int64])
    return data, recv


def join():
    return basics._engine().join()


def barrier(process_set=None):
    basics._engine().barrier(process_set=process_set)


def broadcast_object(obj, root_rank=0, name=None):
    return _eager.broadcast_object(obj, root_rank, name)


def broadcast_variables(variables, root_rank=0, process_set=None):
    """Assigns every variable the root's value (parity:
    tensorflow/__init__.py:139 broadcast_variables)."""
    for i, v in enumerate(variables):
        v.assign(broadcast(v, root_rank, name=f"bv.{i}",
                           process_set=process_set))


def BroadcastGlobalVariablesHook(root_rank=0, device=""):
    """Parity surface for the reference's TF1 ``SessionRunHook``
    (tensorflow/__init__.py:194).  TF1 sessions are not part of the TF2
    front-end; the equivalents are :func:`broadcast_variables` after the
    first step, or ``horovod_tpu_torch.keras.callbacks
    .BroadcastGlobalVariablesCallback`` for Keras training loops."""
    raise NotImplementedError(
        "TF1 session hooks are not supported by the TF2 front-end; call "
        "broadcast_variables(model.variables, root_rank) after the first "
        "training step, or use horovod_tpu_torch.keras.callbacks."
        "BroadcastGlobalVariablesCallback with model.fit().")


def _reduce_gradients(grads, base, op, compression, process_set):
    """Shared gradient-reduction path for the optimizer and tape
    wrappers: dense gradients ride one grouped submission (deadlock-safe
    and coordinator-fusible, see ``grouped_allreduce``); sparse
    IndexedSlices follow, control-chained behind the dense results and
    each other so every blocking collective node has the same total
    order on every rank.  ``None`` gradients pass through."""
    reduced = list(grads)
    dense_ix = [i for i, g in enumerate(grads)
                if g is not None and not isinstance(g, tf.IndexedSlices)]
    if dense_ix:
        douts = grouped_allreduce(
            [grads[i] for i in dense_ix], op=op, compression=compression,
            name=base, process_set=process_set)
        for i, o in zip(dense_ix, douts):
            reduced[i] = o
    anchor = [reduced[dense_ix[-1]]] if dense_ix else []
    for i, g in enumerate(grads):
        if g is None or not isinstance(g, tf.IndexedSlices):
            continue
        with tf.control_dependencies(anchor):
            reduced[i] = allreduce(g, op=op, compression=compression,
                                   name=f"{base}.{i}",
                                   process_set=process_set)
        # Anchor on the LAST collective of this sparse gradient (the
        # indices gather, which is itself chained behind the values
        # gather) — anchoring on .values would leave indices(i) and
        # values(i+1) mutually unordered, the deadlock shape again.
        anchor = [reduced[i].indices]
    return reduced


class DistributedGradientTape:
    """Wraps a ``tf.GradientTape`` so ``gradient()`` allreduces the
    results (parity: tensorflow/__init__.py:474-531 — same wrap-an-
    existing-tape contract: ``tape = hvd.DistributedGradientTape(tape)``).
    Can also be used directly as a context manager, in which case it
    owns a fresh tape."""

    def __init__(self, gradtape=None, device_dense="", device_sparse="",
                 compression=Compression.none, op=ReduceOp.AVERAGE,
                 persistent=False, watch_accessed_variables=True,
                 process_set=None):
        self._tape = gradtape if gradtape is not None else tf.GradientTape(
            persistent=persistent,
            watch_accessed_variables=watch_accessed_variables)
        self._compression = compression
        self._op = op
        self._process_set = process_set

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, item):
        # watch, watched_variables, jacobian, ... delegate to the tape
        return getattr(self._tape, item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        single = not isinstance(grads, (list, tuple))
        if single:
            grads = [grads]
        reduced = _reduce_gradients(grads, "dgt", self._op,
                                    self._compression, self._process_set)
        return reduced[0] if single else reduced


def DistributedOptimizer(optimizer, name=None,
                         compression=Compression.none,
                         op=ReduceOp.AVERAGE,
                         backward_passes_per_step=1,
                         average_aggregated_gradients=False,
                         process_set=None,
                         device_dense="", device_sparse="",
                         sparse_as_dense=False, use_locking=False):
    """Wraps a Keras-3 optimizer: gradients are allreduced before being
    applied (parity: tensorflow/__init__.py:266-311 — there via
    compute_gradients; Keras 3 funnels through apply_gradients).

    ``op=Adasum`` selects the delta-model wrapper (parity:
    ``_DistributedAdasumOptimizer``, tensorflow/__init__.py:313-407):
    the local optimizer applies its update, the parameter *deltas* are
    combined with scale-invariant Adasum, and variables are reset to
    ``start + adasum(deltas)``.

    The instance is re-classed in place (same dynamic-subclass technique
    as the reference) so restored slot state and the iteration counter
    survive — important when wrapping an optimizer loaded from a
    checkpoint.

    ``device_dense``/``device_sparse``/``sparse_as_dense``/
    ``use_locking`` are accepted for reference signature compatibility
    and ignored — there are no CUDA streams or TF1 locking semantics to
    configure on this stack.

    ``backward_passes_per_step=N`` aggregates gradients locally over N
    ``apply_gradients`` calls and allreduces+applies only on the Nth
    (parity: ``LocalGradientAggregationHelper``, the reference's
    tensorflow/__init__.py:443 path); skipped calls leave the variables
    and slots untouched.  ``average_aggregated_gradients`` divides the
    local sum by N before the allreduce, as in the reference."""
    base_cls = optimizer.__class__
    _op = op
    _compression = compression
    _ps = process_set
    _bpps = int(backward_passes_per_step)
    _avg_agg = average_aggregated_gradients
    if _bpps < 1:
        raise ValueError(
            f"backward_passes_per_step must be >= 1, got {_bpps}")

    if op == ReduceOp.ADASUM:
        if process_set is not None:
            raise ValueError("Adasum does not support process sets")
        if _bpps != 1:
            raise ValueError(
                "backward_passes_per_step > 1 is incompatible with the "
                "Adasum delta-model wrapper (the delta must be computed "
                "per applied step)")
        class _WrappedAdasum(base_cls):
            def apply_gradients(self, grads_and_vars, *args, **kwargs):
                gv = list(grads_and_vars)
                tvars = [v for _, v in gv]
                starts = [tf.identity(v) for v in tvars]
                result = super().apply_gradients(gv, *args, **kwargs)
                # One grouped submission for all deltas — same deadlock
                # rationale as the Sum/Average path (grouped_allreduce).
                deltas = [tf.convert_to_tensor(v) - s
                          for v, s in zip(tvars, starts)]
                reduced = grouped_allreduce(
                    deltas, op=ReduceOp.ADASUM, name="adasum.delta",
                    compression=_compression)
                for v, s, d in zip(tvars, starts, reduced):
                    v.assign(s + d)
                return result

        _WrappedAdasum.__name__ = f"DistributedAdasum{base_cls.__name__}"
        optimizer.__class__ = _WrappedAdasum
        return optimizer

    class _Wrapped(base_cls):
        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            sup = super()
            grads_and_vars = list(grads_and_vars)
            grads = [g for g, _ in grads_and_vars]
            tvars = [v for _, v in grads_and_vars]

            def _reduce_apply(gs):
                reduced = _reduce_gradients(
                    gs, "do", _op, _compression, _ps)
                return sup.apply_gradients(
                    zip(reduced, tvars), *args, **kwargs)

            if _bpps == 1:
                return _reduce_apply(grads)

            # Graph-compatible local aggregation (reference:
            # LocalGradientAggregationHelper — tf.Variable state +
            # tf.cond, so a tf.function-compiled train step re-evaluates
            # the pass counter at run time instead of baking the
            # trace-time branch in).  Accumulators are created under
            # init_scope so the first call may itself be inside a trace;
            # object.__setattr__ sidesteps Keras's attribute tracking,
            # which wraps plain lists in copies.
            if getattr(self, "_hvd_agg_acc", None) is None:
                with tf.init_scope():
                    # One accumulator per variable regardless of the
                    # first call's None pattern: a head untouched by the
                    # first microbatch must still aggregate later ones
                    # (its untouched accumulator contributes zeros).
                    accs = [tf.Variable(tf.zeros_like(v), trainable=False)
                            for v in tvars]
                    counter = tf.Variable(0, dtype=tf.int64,
                                          trainable=False)
                object.__setattr__(self, "_hvd_agg_acc", accs)
                object.__setattr__(self, "_hvd_agg_counter", counter)
            accs = self._hvd_agg_acc
            counter = self._hvd_agg_counter
            # Slot variables cannot be created inside a tf.cond branch;
            # force the lazy build before entering it.
            if hasattr(self, "build") and not getattr(self, "built", True):
                self.build(tvars)
            for a, g in zip(accs, grads):
                if g is not None:
                    a.assign_add(tf.convert_to_tensor(g))
            counter.assign_add(1)

            # The call's None pattern is static per trace: a variable
            # with no gradient HERE forwards None (exactly like the
            # bpps=1 path — no zero-tensor updates that would move
            # momentum/weight-decay state on untouched variables).  Its
            # accumulator is left intact, applying at the next Nth pass
            # where it does receive a gradient.
            has_g = [g is not None for g in grads]

            def _apply_branch():
                gs = [tf.convert_to_tensor(a) if has else None
                      for a, has in zip(accs, has_g)]
                if _avg_agg:
                    gs = [g / _bpps if g is not None else None
                          for g in gs]
                _reduce_apply(gs)
                for a, has in zip(accs, has_g):
                    if has:
                        a.assign(tf.zeros_like(a))
                return tf.constant(True)

            def _skip_branch():
                # Aggregation-only pass: no collective, no update.
                return tf.constant(False)

            return tf.cond(tf.equal(counter % _bpps, 0),
                           _apply_branch, _skip_branch)

    _Wrapped.__name__ = f"Distributed{base_cls.__name__}"
    optimizer.__class__ = _Wrapped
    return optimizer
