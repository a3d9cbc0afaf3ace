"""Gang worker for the TensorFlow, Keras and elastic ``KerasState``
front-ends of both packages (``tests/test_torch_tensorflow.py``,
``tests/test_torch_keras.py``).

    python tests/torch_port_tf_worker.py <port|jax> <case,case,...> <out_dir>

``port`` binds ``horovod_tpu_torch.tensorflow`` / ``.keras`` (``hvd.init(
device="cpu", backend="none")``), ``jax`` the JAX package's
``horovod_tpu.tensorflow`` / ``.keras`` (``hvd.init()``), so that one gang
may mix the two.  The rank, size, rendezvous and engine
(``HVD_TPU_CORE``) come from the environment.  The cases
``single_thread_optimizer`` (which must run first: it sets TensorFlow's
thread pools), ``ops``, ``graph_mode``, ``tape``, ``keras_fit``,
``adasum_optimizer``, ``native_ops`` and ``backward_passes`` are
``tests/tf_worker.py``'s scenarios, body for body, on the bound package;
``adasum_optimizer`` holds the result to the bound package's numpy
oracle.  ``bits`` records every op of the TensorFlow surface over every
dtype of the engine (each op, dtype, compression, gradient and
``broadcast_object``) on inputs made from a seed, with the native kernels
on and then off (``HVD_TF_NATIVE_OPS=0``, read at every call), for the
test to compare across gangs.  The Keras cases (``callbacks``,
``load_model``, ``keras_state``) are described where they are defined.
Each case that ran prints ``SCENARIO_OK <case>``; the recorded results go
to ``<out_dir>/rank<r>.pkl``.
"""

import os
import pickle
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

import tensorflow as tf  # noqa: E402

PKG = sys.argv[1]
if PKG == "jax":
    import horovod_tpu.keras as hvd_keras  # noqa: E402
    import horovod_tpu.tensorflow as hvd  # noqa: E402
    from horovod_tpu import elastic  # noqa: E402
    from horovod_tpu.ops.adasum import adasum_reduce_numpy  # noqa: E402
    from horovod_tpu.process_sets import ProcessSet  # noqa: E402
    from horovod_tpu.tensorflow import _native_ops  # noqa: E402
else:
    import horovod_tpu_torch.keras as hvd_keras  # noqa: E402
    import horovod_tpu_torch.tensorflow as hvd  # noqa: E402
    from horovod_tpu_torch import elastic  # noqa: E402
    from horovod_tpu_torch.ops.adasum import (  # noqa: E402
        adasum_reduce_numpy)
    from horovod_tpu_torch.process_sets import ProcessSet  # noqa: E402
    from horovod_tpu_torch.tensorflow import _native_ops  # noqa: E402


# -- tests/tf_worker.py's scenarios, on the bound package -----------------


def scenario_ops():
    rank, size = hvd.rank(), hvd.size()
    # allreduce dtypes
    for dtype in (tf.float32, tf.float64, tf.int32, tf.int64):
        x = tf.cast(tf.range(17), dtype) * (rank + 1)
        out = hvd.allreduce(x, op=hvd.Sum, name=f"tf.ar.{dtype.name}")
        expect = tf.cast(tf.range(17), dtype) * sum(
            r + 1 for r in range(size))
        assert out.dtype == dtype
        np.testing.assert_allclose(out.numpy(), expect.numpy())
    # average + fp16 compression
    x = tf.fill([4, 3], float(rank))
    out = hvd.allreduce(x, op=hvd.Average, name="tf.avg",
                        compression=hvd.Compression.fp16)
    np.testing.assert_allclose(out.numpy(),
                               np.full((4, 3), (size - 1) / 2.0))
    # allgather ragged
    x = tf.fill([rank + 1, 2], float(rank))
    out = hvd.allgather(x, name="tf.ag")
    expect = np.concatenate(
        [np.full((r + 1, 2), float(r), np.float32) for r in range(size)])
    np.testing.assert_allclose(out.numpy(), expect)
    # broadcast
    for root in range(size):
        x = tf.fill([3], float(rank + 1))
        out = hvd.broadcast(x, root_rank=root, name=f"tf.bc.{root}")
        np.testing.assert_allclose(out.numpy(), np.full(3, root + 1.0))
    # broadcast_variables
    v = tf.Variable(tf.fill([2, 2], float(rank)))
    hvd.broadcast_variables([v], root_rank=0)
    np.testing.assert_allclose(v.numpy(), np.zeros((2, 2)))
    # broadcast_object
    obj = hvd.broadcast_object({"a": rank} if rank == 0 else None, 0)
    assert obj == {"a": 0}
    # process sets through the TF surface: per-rank singleton sets
    # (identity semantics) and a full-membership set with a gradient.
    # EVERY rank must construct EVERY set (non-members need the registry
    # to skip a set's responses — process_sets.py contract).
    singletons = [ProcessSet([r]) for r in range(size)]
    mine = singletons[rank]
    out = hvd.allreduce(tf.ones(3) * (rank + 1), op=hvd.Sum,
                        name="tf.ps.self", process_set=mine)
    np.testing.assert_allclose(out.numpy(), np.full(3, rank + 1.0))
    everyone = ProcessSet(range(size))
    v = tf.Variable(tf.ones([2]) * (rank + 1))
    with tf.GradientTape() as tape:
        y = hvd.allreduce(v, op=hvd.Sum, name="tf.ps.all",
                          process_set=everyone)
        loss = tf.reduce_sum(y)
    np.testing.assert_allclose(
        y.numpy(), np.full(2, sum(r + 1.0 for r in range(size))))
    g = tape.gradient(loss, v)
    np.testing.assert_allclose(g.numpy(), np.full(2, float(size)))

    # DistributedOptimizer scoped to a PROPER subgroup — each rank's own
    # singleton set, with per-rank gradient values and same optimizer op
    # names ("do.0") in different sets concurrently.  If process_set
    # were silently dropped, both ranks' "do.0" would collide in one
    # GLOBAL allreduce and average the differing gradients, failing the
    # exact per-rank oracle below.  Rank 0 goes through the Keras
    # surface to cover its forwarding.
    factory = (hvd_keras.DistributedOptimizer if rank == 0
               else hvd.DistributedOptimizer)
    opt = factory(tf.keras.optimizers.SGD(learning_rate=0.5),
                  process_set=mine)
    w = tf.Variable(tf.ones([2]) * (rank + 1))
    opt.apply_gradients([(tf.ones([2]) * (rank + 1), w)])
    np.testing.assert_allclose(
        w.numpy(), np.full(2, (rank + 1.0) - 0.5 * (rank + 1.0)),
        rtol=1e-6)
    # ...and a MULTI-member set through the optimizer, so the subgroup
    # ring itself (not just the routing) is on the tested path
    opt2 = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.5), process_set=everyone)
    w2 = tf.Variable(tf.zeros([2]))
    opt2.apply_gradients([(tf.ones([2]) * (rank + 1), w2)])
    avg_g = sum(r + 1.0 for r in range(size)) / size
    np.testing.assert_allclose(w2.numpy(), np.full(2, -0.5 * avg_g),
                               rtol=1e-6)

    # reducescatter: sum across ranks, rank r keeps row chunk r;
    # differentiable (backward = allgather of the chunk gradients)
    x = tf.Variable(tf.ones([size * 2, 3]) * float(rank + 1))
    with tf.GradientTape() as tape:
        out = hvd.reducescatter(x, op=hvd.Sum, name="tf.rs")
        loss = tf.reduce_sum(out * float(rank + 1))
    np.testing.assert_allclose(
        out.numpy(), np.full((2, 3), sum(r + 1.0 for r in range(size))))
    g = tape.gradient(loss, x)
    # d loss / d x = allgather of each rank's chunk weight (rank+1)
    expect_g = np.concatenate(
        [np.full((2, 3), r + 1.0, np.float32) for r in range(size)])
    np.testing.assert_allclose(g.numpy(), expect_g)


def scenario_graph_mode():
    # Collectives traced inside tf.function: py_function defers the
    # engine call to graph runtime.
    rank, size = hvd.rank(), hvd.size()

    @tf.function
    def step(x):
        y = hvd.allreduce(x, op=hvd.Sum, name="tfg.ar")
        return y * 2.0

    for i in range(3):  # multiple executions of one trace reuse the name
        out = step(tf.fill([8], float(rank + 1 + i)))
        expect = np.full(8, 2.0 * sum(r + 1 + i for r in range(size)))
        np.testing.assert_allclose(out.numpy(), expect)


def scenario_tape():
    rank, size = hvd.rank(), hvd.size()
    w = tf.Variable(tf.ones([4]))
    with hvd.DistributedGradientTape() as tape:
        loss = tf.reduce_sum(w * (rank + 1.0))
    (grad,) = tape.gradient(loss, [w])
    expect = np.full(4, np.mean([r + 1.0 for r in range(size)]))
    np.testing.assert_allclose(grad.numpy(), expect)
    # wrap-an-existing-tape contract
    with tf.GradientTape() as inner:
        loss = tf.reduce_sum(w * (rank + 1.0))
    tape = hvd.DistributedGradientTape(inner)
    (grad,) = tape.gradient(loss, [w])
    np.testing.assert_allclose(grad.numpy(), expect)
    # Reduced gradients stay differentiable (the grouped path carries a
    # custom gradient): d/dw sum(G·w) with G = AR_avg(2w·(rank+1))
    # = G + 2(rank+1)·AR_avg(w) = (2·mean(r+1) + 2(rank+1))·w.
    m = np.mean([r + 1.0 for r in range(size)])
    with tf.GradientTape() as outer:
        with hvd.DistributedGradientTape() as dtape:
            loss = tf.reduce_sum(w * w) * (rank + 1.0)
        (g,) = dtape.gradient(loss, [w])
        outer_loss = tf.reduce_sum(g * w)
    (gg,) = outer.gradient(outer_loss, [w])
    np.testing.assert_allclose(
        gg.numpy(), (2.0 * m + 2.0 * (rank + 1.0)) * w.numpy(),
        rtol=1e-5)


def scenario_single_thread_optimizer():
    """Deadlock regression (grouped gradient submission).

    With synchronous collective kernels, a single-threaded TF executor
    runs independent per-gradient allreduce nodes in arbitrary per-rank
    order; two ranks could block inside different tensors' collectives
    forever (stall inspector: "do.2 ready on [1]" / "do.4 ready on
    [0]").  The optimizer now submits all dense gradients through ONE
    grouped node, which this scenario exercises under the adversarial
    executor config (1 inter-op thread, rank-asymmetric graph so the
    schedules genuinely differ)."""
    tf.config.threading.set_inter_op_parallelism_threads(1)
    tf.config.threading.set_intra_op_parallelism_threads(1)
    rank, size = hvd.rank(), hvd.size()
    tvars = [tf.Variable(tf.ones([8]) * (i + 1.0)) for i in range(6)]
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.1), op=hvd.Sum)

    @tf.function
    def step():
        with tf.GradientTape() as tape:
            # Rank-asymmetric extra work so node schedules differ.
            parts = []
            for i, v in enumerate(tvars):
                t = tf.reduce_sum(v * (rank + 1.0))
                if (i + rank) % 2:
                    t = t + tf.reduce_sum(tf.sin(v)) * 0.0
                parts.append(t)
            loss = tf.add_n(parts)
        grads = tape.gradient(loss, tvars)
        opt.apply_gradients(zip(grads, tvars))
        return loss

    for _ in range(3):
        step()
    # Sum op over ranks: each step subtracts lr * sum(rank+1) from
    # every element.
    total = sum(r + 1.0 for r in range(size))
    expect = 1.0 - 3 * 0.1 * total
    np.testing.assert_allclose(tvars[0].numpy(), np.full(8, expect),
                               rtol=1e-5)

    # Mixed dense + TWO sparse (IndexedSlices) gradients on the same
    # single-thread executor: the sparse collectives must form one
    # total order across ranks (values(i) → indices(i) → values(i+1))
    # or indices(i)/values(i+1) deadlock ranks against each other.
    emb1 = tf.Variable(tf.ones([16, 4]))
    emb2 = tf.Variable(tf.ones([16, 4]))
    dense = tf.Variable(tf.ones([4]))
    sopt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.1), op=hvd.Sum)

    @tf.function
    def sparse_step():
        with tf.GradientTape() as tape:
            ids = tf.constant([rank % 16, (rank + 3) % 16])
            loss = (tf.reduce_sum(tf.gather(emb1, ids))
                    + tf.reduce_sum(tf.gather(emb2, ids)) * 2.0
                    + tf.reduce_sum(dense * (rank + 1.0)))
        grads = tape.gradient(loss, [emb1, emb2, dense])
        assert isinstance(grads[0], tf.IndexedSlices)
        sopt.apply_gradients(zip(grads, [emb1, emb2, dense]))

    for _ in range(2):
        sparse_step()
    np.testing.assert_allclose(
        dense.numpy(), np.full(4, 1.0 - 2 * 0.1 * total), rtol=1e-5)


def scenario_keras_fit():
    import keras

    rank, size = hvd.rank(), hvd.size()
    keras.utils.set_random_seed(100 + rank)  # divergent init on purpose

    model = keras.Sequential([
        keras.layers.Input((10,)),
        keras.layers.Dense(16, activation="relu"),
        keras.layers.Dense(1),
    ])
    opt = hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.05))
    model.compile(optimizer=opt, loss="mse", run_eagerly=True)

    rng = np.random.RandomState(5)
    X = rng.randn(128, 10).astype(np.float32)
    w = rng.randn(10, 1).astype(np.float32)
    y = X @ w
    shard = slice(rank * 128 // size, (rank + 1) * 128 // size)

    hist = model.fit(
        X[shard], y[shard], batch_size=16, epochs=3, verbose=0,
        callbacks=[
            hvd_keras.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd_keras.callbacks.MetricAverageCallback(),
        ])
    losses = hist.history["loss"]
    assert losses[-1] < losses[0], losses
    # weights in sync across ranks after training
    flat = np.concatenate([w.reshape(-1) for w in model.get_weights()])
    gathered = hvd.allgather(
        tf.convert_to_tensor(flat.reshape(1, -1)), name="kf.check")
    for r in range(size):
        np.testing.assert_allclose(gathered.numpy()[r], flat, atol=1e-5)


def scenario_adasum_optimizer():
    # Golden parity for the TF delta-model wrapper (ref
    # tensorflow/__init__.py:313-407): keras SGD(lr) local delta is
    # -lr*grad; after apply_gradients the variable must equal
    # start + adasum_reduce_numpy([-lr*g_r]).
    import keras

    rank, size = hvd.rank(), hvd.size()
    start = np.arange(12, dtype=np.float32).reshape(3, 4) / 10.0
    v = tf.Variable(start.copy())
    lr = 0.1
    opt = hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=lr), op=hvd.Adasum)
    grads = [np.random.RandomState(70 + r).randn(3, 4).astype(np.float32)
             for r in range(size)]
    opt.apply_gradients([(tf.constant(grads[rank]), v)])
    deltas = [(-lr * g).ravel() for g in grads]
    expect = start + adasum_reduce_numpy(deltas).reshape(start.shape)
    np.testing.assert_allclose(v.numpy(), expect, rtol=1e-4, atol=1e-5)


def scenario_native_ops():
    # C++ custom kernels (csrc/tf_ops.cc): engaged on the native
    # engine, REAL graph ops in tf.function graphs (not py_function
    # trampolines), results matching the engine oracle, differentiable.
    rank, size = hvd.rank(), hvd.size()
    assert _native_ops.lib() is not None, _native_ops.reason()
    tot = sum(r + 1.0 for r in range(size))

    x = tf.constant(np.arange(8, dtype=np.float32) * (rank + 1))
    out = hvd.allreduce(x, op=hvd.Sum, name="nat.ar")
    np.testing.assert_allclose(
        out.numpy(), np.arange(8, dtype=np.float32) * tot)

    @tf.function
    def g(t):
        return hvd.allreduce(t, op=hvd.Sum, name="nat.graph")

    np.testing.assert_allclose(
        g(x).numpy(), np.arange(8, dtype=np.float32) * tot)
    graph = g.get_concrete_function(
        tf.TensorSpec(x.shape, x.dtype)).graph
    op_types = {o.type for o in graph.get_operations()}
    assert "HvdAllreduce" in op_types, op_types

    # The optimizer's dense-gradient reduction rides ONE variadic native
    # kernel (atomic submission; no py_function hop).
    gvars = [tf.Variable(tf.ones([4]) * (i + 1.0)) for i in range(3)]
    gopt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.5),
                                    op=hvd.Sum)

    @tf.function
    def gstep():
        with tf.GradientTape() as tape:
            loss = tf.add_n([tf.reduce_sum(v) for v in gvars]) \
                * (rank + 1.0)
        gopt.apply_gradients(zip(tape.gradient(loss, gvars), gvars))

    gstep()
    gops = {o.type for o in gstep.get_concrete_function().graph
            .get_operations()}
    assert "HvdGroupedAllreduce" in gops, gops
    assert "EagerPyFunc" not in gops, gops
    np.testing.assert_allclose(
        gvars[0].numpy(), np.full(4, 1.0 - 0.5 * tot), rtol=1e-6)

    # differentiable through the kernel (custom_gradient wraps it)
    v = tf.Variable(np.ones(4, np.float32) * (rank + 1))
    with tf.GradientTape() as tape:
        y = tf.reduce_sum(hvd.allreduce(v, op=hvd.Sum, name="nat.vjp"))
    gr = tape.gradient(y, v)
    np.testing.assert_allclose(gr.numpy(), np.full(4, float(size)))

    # broadcast + negotiated-size allgather + scalar lift
    b = hvd.broadcast(x, root_rank=size - 1, name="nat.bc")
    np.testing.assert_allclose(
        b.numpy(), np.arange(8, dtype=np.float32) * size)
    ag = hvd.allgather(
        tf.constant(np.full((rank + 1, 2), float(rank), np.float32)),
        name="nat.ag")
    assert ag.shape == (sum(r + 1 for r in range(size)), 2), ag.shape
    s = hvd.allreduce(tf.constant(1.0 + rank), op=hvd.Sum, name="nat.s")
    np.testing.assert_allclose(float(s), tot)
    # zero-row contribution: gathered shape derives from dims[1:], not
    # the local row count (the IndexedSlices path hits this)
    rows0 = 0 if rank == 0 else 2
    ag0 = hvd.allgather(
        tf.constant(np.full((rows0, 3), float(rank), np.float32)),
        name="nat.ag0")
    expect_rows = sum(0 if r == 0 else 2 for r in range(size))
    assert ag0.shape == (expect_rows, 3), ag0.shape

    # process-set-scoped kernel op
    ps = ProcessSet([0, size - 1])
    if ps.included():
        out = hvd.allreduce(tf.ones(3) * (rank + 1), op=hvd.Sum,
                            name="nat.ps", process_set=ps)
        np.testing.assert_allclose(out.numpy(), np.full(3, 1.0 + size))


def scenario_backward_passes():
    # Local gradient aggregation (parity: reference
    # tensorflow/__init__.py:443 backward_passes_per_step via
    # LocalGradientAggregationHelper): N-1 calls accumulate without
    # touching variables; the Nth allreduces the sum and applies.
    import keras

    rank, size = hvd.rank(), hvd.size()
    start = np.linspace(0.0, 1.1, 12, dtype=np.float32).reshape(3, 4)
    lr = 0.1
    rs = [np.random.RandomState(100 + r) for r in range(size)]
    g_all = [[rs[r].randn(3, 4).astype(np.float32) for _ in range(4)]
             for r in range(size)]

    v = tf.Variable(start.copy())
    opt = hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=lr), backward_passes_per_step=2)
    opt.apply_gradients([(tf.constant(g_all[rank][0]), v)])
    np.testing.assert_allclose(v.numpy(), start, rtol=0, atol=0,
                               err_msg="variable moved on an "
                               "aggregation-only pass")
    opt.apply_gradients([(tf.constant(g_all[rank][1]), v)])
    mean_sum = np.mean(
        [g_all[r][0] + g_all[r][1] for r in range(size)], axis=0)
    np.testing.assert_allclose(v.numpy(), start - lr * mean_sum,
                               rtol=1e-5, atol=1e-6)

    # under tf.function: the pass counter must be graph state (tf.cond),
    # not a trace-time Python branch — both passes share ONE trace here
    v3 = tf.Variable(start.copy())
    opt3 = hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=lr), backward_passes_per_step=2)

    @tf.function
    def train(g):
        return opt3.apply_gradients([(g, v3)])

    applied1 = train(tf.constant(g_all[rank][0]))
    np.testing.assert_allclose(v3.numpy(), start, rtol=0, atol=0,
                               err_msg="compiled aggregation-only pass "
                               "moved the variable")
    applied2 = train(tf.constant(g_all[rank][1]))
    np.testing.assert_allclose(v3.numpy(), start - lr * mean_sum,
                               rtol=1e-5, atol=1e-6)
    assert not bool(applied1) and bool(applied2)

    # average_aggregated_gradients divides the local sum by N pre-wire
    v2 = tf.Variable(start.copy())
    opt2 = hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=lr), backward_passes_per_step=2,
        average_aggregated_gradients=True)
    opt2.apply_gradients([(tf.constant(g_all[rank][2]), v2)])
    opt2.apply_gradients([(tf.constant(g_all[rank][3]), v2)])
    mean_avg = np.mean(
        [(g_all[r][2] + g_all[r][3]) / 2.0 for r in range(size)], axis=0)
    np.testing.assert_allclose(v2.numpy(), start - lr * mean_avg,
                               rtol=1e-5, atol=1e-6)


# -- the Keras front-end and KerasState, recorded ---------------------------


def _shard(n):
    rank, size = hvd.rank(), hvd.size()
    return slice(rank * n // size, (rank + 1) * n // size)


def scenario_callbacks(out):
    """One ``fit`` of four epochs from unequal starts under
    ``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
    ``LearningRateWarmupCallback`` (a per-batch ramp over two epochs) and
    ``LearningRateScheduleCallback`` (×0.5 from epoch 3, staircase), over
    SGD with momentum (the warmup's momentum correction): the learning
    rates follow the warmup formula, the averaged losses and the weights
    agree across ranks.  Records the histories and the weights."""
    import keras

    rank, size = hvd.rank(), hvd.size()
    keras.utils.set_random_seed(200 + rank)
    model = keras.Sequential([keras.layers.Input((6,)),
                              keras.layers.Dense(4, activation="relu"),
                              keras.layers.Dense(1)])
    lr = 0.02
    model.compile(optimizer=hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=lr, momentum=0.9)),
        loss="mse", run_eagerly=True)
    rs = np.random.RandomState(7)
    X = rs.randn(64, 6).astype(np.float32)
    y = (X @ rs.randn(6, 1)).astype(np.float32)
    cb = hvd_keras.callbacks
    hist = model.fit(
        X[_shard(64)], y[_shard(64)], batch_size=8, epochs=4, verbose=0,
        shuffle=False, callbacks=[
            cb.BroadcastGlobalVariablesCallback(0),
            cb.MetricAverageCallback(),
            cb.LearningRateWarmupCallback(warmup_epochs=2,
                                          steps_per_epoch=4),
            cb.LearningRateScheduleCallback(multiplier=0.5, start_epoch=3,
                                            staircase=True)])
    lrs = hist.history["lr"]
    # The last batch of epoch 0 ran at epoch 0.75 of the ramp; epoch 1's
    # at 1.75; the ramp lands on the target at epoch 2; ×0.5 from 3.
    ramp = [lr * (e * (size - 1) / 2 + 1) / size for e in (0.75, 1.75)]
    np.testing.assert_allclose(lrs, ramp + [lr, lr * 0.5], rtol=1e-6)
    losses = np.asarray(hist.history["loss"], np.float64)
    every = hvd.allgather(tf.constant(losses.reshape(1, -1)),
                          name="cb.loss.check").numpy()
    assert (every == every[0]).all(), every
    flat = np.concatenate([w.reshape(-1) for w in model.get_weights()])
    every = hvd.allgather(tf.constant(flat.reshape(1, -1)),
                          name="cb.w.check").numpy()
    assert (every == every[0]).all(), every
    _rec(out, "lr", np.asarray(lrs, np.float64))
    _rec(out, "loss", losses)
    _rec(out, "weights", flat)


def _scaled_sgd():
    """A custom optimizer class, which ``load_model`` finds through
    ``custom_objects``."""
    import keras

    class ScaledSGD(keras.optimizers.SGD):
        pass

    return ScaledSGD


def scenario_load_model(out):
    """Rank 0 saves a compiled model whose optimizer is a custom SGD
    subclass; every rank loads it with ``load_model`` and
    ``custom_objects``: the optimizer comes back wrapped
    (``DistributedScaledSGD``), and one step with rank-dependent gradients
    moves the weights by the averaged gradient.  Records the weights."""
    import keras

    rank, size = hvd.rank(), hvd.size()
    cls = _scaled_sgd()
    path = os.path.join(os.getcwd(), "load_model.keras")
    if rank == 0:
        keras.utils.set_random_seed(5)
        model = keras.Sequential([keras.layers.Input((3,)),
                                  keras.layers.Dense(2)])
        model.compile(optimizer=cls(learning_rate=0.25), loss="mse")
        model.save(path)
    hvd.broadcast_object(None, 0, name="load_model.saved")
    model = hvd_keras.load_model(path, custom_objects={"ScaledSGD": cls})
    opt = model.optimizer
    assert type(opt).__name__ == "DistributedScaledSGD", type(opt)
    assert isinstance(opt, cls), type(opt).__mro__
    w0 = [np.asarray(v) for v in model.trainable_variables]
    grads = [np.full(w.shape, rank + 1.0, np.float32) for w in w0]
    opt.apply_gradients(zip([tf.constant(g) for g in grads],
                            model.trainable_variables))
    mean = np.mean([r + 1.0 for r in range(size)])
    for v, w in zip(model.trainable_variables, w0):
        np.testing.assert_allclose(np.asarray(v), w - 0.25 * mean,
                                   rtol=1e-6)
    _rec(out, "weights", np.concatenate(
        [np.asarray(v).reshape(-1) for v in model.trainable_variables]))


def scenario_keras_state(out):
    """``elastic.KerasState`` over a model of unequal starts, with an
    extra ``epoch``: ``restore`` brings back the last ``commit`` (the
    weights, and on the port the extra too), ``sync`` gives every rank
    rank 0's.  Records the synced weights."""
    import keras

    rank = hvd.rank()
    keras.utils.set_random_seed(300 + rank)
    model = keras.Sequential([keras.layers.Input((3,)),
                              keras.layers.Dense(2)])
    state = elastic.KerasState(model, epoch=0)
    w0 = model.get_weights()
    model.set_weights([w + 1.0 for w in w0])
    state.restore()
    for a, b in zip(model.get_weights(), w0):
        np.testing.assert_array_equal(a, b)
    model.set_weights([w * 2.0 for w in w0])
    state.epoch = 3
    state.commit()
    model.set_weights([w * 0 for w in w0])
    state.epoch = 4
    state.restore()
    for a, b in zip(model.get_weights(), w0):
        np.testing.assert_array_equal(a, b * 2.0)
    if PKG == "port":
        # The port's extra keywords are set through the state, so the
        # commit saved epoch 3 (the JAX package's sets an attribute beside
        # the snapshot, which restore leaves at 4).
        assert state.epoch == 3, state.epoch
    state.sync(0)
    flat = np.concatenate([w.reshape(-1) for w in model.get_weights()])
    every = hvd.allgather(tf.constant(flat.reshape(1, -1)),
                          name="ks.check").numpy()
    assert (every == every[0]).all(), every
    _rec(out, "weights", flat)


# -- the op matrix, recorded for the cross-gang comparison -----------------

BITS_DTYPES = (tf.float32, tf.float64, tf.float16, tf.bfloat16, tf.int32,
               tf.int64, tf.uint8, tf.int8)
REDUCE_OPS = ("Sum", "Average", "Min", "Max", "Product")


def _rec(out, key, t):
    a = np.asarray(t.numpy() if hasattr(t, "numpy") else t)
    out[key] = (str(a.dtype), a.shape, a.tobytes())


def _input(rank, dtype, shape, salt):
    rs = np.random.RandomState(1000 + 17 * salt + rank)
    x = rs.randn(*shape) * 3
    if dtype.is_integer:
        x = np.abs(x) if dtype.is_unsigned else x
        x = np.round(x)
    return tf.cast(tf.constant(x), dtype)


def _matrix(out, tag):
    rank, size = hvd.rank(), hvd.size()
    for d, dtype in enumerate(BITS_DTYPES):
        for o, opname in enumerate(REDUCE_OPS):
            if opname == "Average" and dtype.is_integer:
                continue  # an integer Average's type differs by engine
            x = _input(rank, dtype, (5, 3), 10 * d + o)
            y = hvd.allreduce(x, op=getattr(hvd, opname),
                              name=f"{tag}.ar.{dtype.name}.{opname}")
            _rec(out, f"{tag}.ar.{dtype.name}.{opname}", y)
        x = _input(rank, dtype, (rank + 1, 2), 100 + d)
        _rec(out, f"{tag}.ag.{dtype.name}",
             hvd.allgather(x, name=f"{tag}.ag.{dtype.name}"))
        x = _input(rank, dtype, (4,), 200 + d)
        _rec(out, f"{tag}.bc.{dtype.name}",
             hvd.broadcast(x, root_rank=size - 1,
                           name=f"{tag}.bc.{dtype.name}"))
        ys = hvd.grouped_allreduce(
            [_input(rank, dtype, (3,), 300 + d),
             _input(rank, dtype, (2, 2), 400 + d)], op=hvd.Sum,
            name=f"{tag}.gar.{dtype.name}")
        for i, y in enumerate(ys):
            _rec(out, f"{tag}.gar.{dtype.name}.{i}", y)
    for d, dtype in enumerate((tf.float32, tf.float64, tf.int32)):
        x = _input(rank, dtype, (2 * size + 1, 3), 500 + d)
        _rec(out, f"{tag}.rs.{dtype.name}",
             hvd.reducescatter(x, op=hvd.Sum,
                               name=f"{tag}.rs.{dtype.name}"))
        x = _input(rank, dtype, (2 * size, 2), 600 + d)
        _rec(out, f"{tag}.a2a.{dtype.name}",
             hvd.alltoall(x, name=f"{tag}.a2a.{dtype.name}"))
        splits = [(rank + j) % 3 + 1 for j in range(size)]
        x = _input(rank, dtype, (sum(splits), 2), 700 + d)
        data, recv = hvd.alltoall(x, splits=splits,
                                  name=f"{tag}.a2av.{dtype.name}")
        _rec(out, f"{tag}.a2av.{dtype.name}", data)
        _rec(out, f"{tag}.a2av.{dtype.name}.splits", recv)
    x = _input(rank, tf.float32, (4, 3), 800)
    _rec(out, f"{tag}.fp16", hvd.allreduce(
        x, op=hvd.Average, name=f"{tag}.fp16",
        compression=hvd.Compression.fp16))
    _rec(out, f"{tag}.scalar", hvd.allreduce(
        tf.constant(1.5 + rank), op=hvd.Sum, name=f"{tag}.scalar"))
    # gradients through each differentiable op
    v = tf.Variable(_input(rank, tf.float32, (size + 1, 2), 900))
    with tf.GradientTape(persistent=True) as tape:
        a = hvd.allreduce(v, op=hvd.Average, name=f"{tag}.g.ar")
        g = hvd.allgather(v, name=f"{tag}.g.ag")
        b = hvd.broadcast(v, root_rank=0, name=f"{tag}.g.bc")
        r = hvd.reducescatter(v, op=hvd.Sum, name=f"{tag}.g.rs")
        loss = (tf.reduce_sum(a * a) + tf.reduce_sum(g * g)
                + tf.reduce_sum(b * 3.0) + tf.reduce_sum(r * r))
    _rec(out, f"{tag}.g.v", tape.gradient(loss, v))
    obj = hvd.broadcast_object({"rank": rank, "x": [1.5, rank]}
                               if rank == 0 else None, 0,
                               name=f"{tag}.obj")
    out[f"{tag}.obj"] = ("object", (), pickle.dumps(obj))


def scenario_bits(out):
    """The op matrix with the native kernels on, then off; on the native
    core the two must give the same bits."""
    native = _native_ops.lib() is not None
    _matrix(out, "on")
    os.environ["HVD_TF_NATIVE_OPS"] = "0"
    try:
        assert _native_ops.lib() is None
        _matrix(out, "off")
    finally:
        del os.environ["HVD_TF_NATIVE_OPS"]
    out["native"] = ("bool", (), bytes([native]))


CASES = {k[len("scenario_"):]: v for k, v in list(globals().items())
         if k.startswith("scenario_")}
# The recording cases take the results dict.
RECORDING = {"bits", "callbacks", "load_model", "keras_state"}


def main():
    cases, out_dir = sys.argv[2].split(","), sys.argv[3]
    if PKG == "jax":
        hvd.init()
    else:
        hvd.init(device="cpu", backend="none")
    results, ok = {}, True
    try:
        for case in cases:
            try:
                out = {}
                if case in RECORDING:
                    CASES[case](out)
                else:
                    CASES[case]()
                results[case] = out
                print(f"SCENARIO_OK {case}", flush=True)
            except BaseException:
                traceback.print_exc()
                print(f"SCENARIO_FAIL {case}", flush=True)
                ok = False
                break
        with open(os.path.join(out_dir, f"rank{hvd.rank()}.pkl"),
                  "wb") as f:
            pickle.dump(results, f)
    finally:
        hvd.shutdown()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
