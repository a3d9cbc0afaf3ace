"""The port's Keras front-end (``import horovod_tpu_torch.keras as hvd``,
its callbacks and ``load_model``) and ``elastic.KerasState`` against the
JAX package's, in gangs (``tests/torch_port_tf_worker.py``'s Keras
cases), and its single-rank surface.

Three gangs of two run once for the module, at once, on the native core:
a port gang, a JAX gang and a mixed gang (rank 0 the JAX package's, rank
1 the port's), each through the cases

* ``callbacks``: a ``fit`` from unequal starts under the broadcast, metric
  average, warmup and schedule callbacks;
* ``load_model``: a saved model with a custom optimizer class, loaded
  through ``custom_objects`` and wrapped, then one averaged step;
* ``keras_state``: ``KerasState`` restore, commit and sync.

Held: each case passes its own checks in every gang, and the port gang's
and the mixed gang's records (learning rates, losses, weights) are the
JAX gang's, bit for bit.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from test_torch_tensorflow import ran, run_gangs  # noqa: E402

CASES = ["callbacks", "load_model", "keras_state"]
GANGS = {"port2": (["port", "port"], CASES),
         "jax2": (["jax", "jax"], CASES),
         "mixed2": (["jax", "port"], CASES)}
GANG_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return run_gangs(tmp_path_factory.mktemp("keras_gangs"), GANGS,
                     GANG_TIMEOUT)


@pytest.mark.timeout(400)
@pytest.mark.parametrize("name", ["port2", "mixed2"])
@pytest.mark.parametrize("case", CASES)
def test_keras_case_bits_equal_jax_gang(gangs, name, case):
    ran(gangs["jax2"], case)
    ran(gangs[name], case)
    for rank in range(2):
        got = gangs[name][1][rank][case]
        want = gangs["jax2"][1][rank][case]
        assert sorted(got) == sorted(want), (rank, case)
        for key in want:
            assert got[key] == want[key], (name, rank, case, key)


@pytest.fixture
def hvd1():
    import horovod_tpu_torch.keras as hvd_keras

    hvd_keras.init(rank=0, size=1, local_rank=0, local_size=1,
                   device="cpu")
    yield hvd_keras
    hvd_keras.shutdown()


def _tiny_model(lr=0.1):
    import keras

    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(learning_rate=lr),
                  loss="mse", run_eagerly=True)
    return model


def test_warmup_at_size_one_ends_where_it_began(hvd1):
    """``tests/test_tf_keras_binding.py``'s single-rank warmup case."""
    model = _tiny_model(lr=0.1)
    cb = hvd1.callbacks.LearningRateWarmupCallback(warmup_epochs=2,
                                                   steps_per_epoch=4)
    rs = np.random.RandomState(0)
    X = rs.rand(16, 4).astype(np.float32)
    y = rs.rand(16, 1).astype(np.float32)
    model.fit(X, y, batch_size=4, epochs=3, verbose=0, callbacks=[cb])
    np.testing.assert_allclose(
        float(np.asarray(model.optimizer.learning_rate)), 0.1, rtol=1e-5)


def test_schedule_staircase_multiplier(hvd1):
    """``tests/test_tf_keras_binding.py``'s staircase case."""
    model = _tiny_model(lr=0.1)
    cb = hvd1.callbacks.LearningRateScheduleCallback(
        multiplier=0.1, start_epoch=1, staircase=True)
    rs = np.random.RandomState(1)
    X = rs.rand(8, 4).astype(np.float32)
    y = rs.rand(8, 1).astype(np.float32)
    hist = model.fit(X, y, batch_size=4, epochs=2, verbose=0,
                     callbacks=[cb])
    np.testing.assert_allclose(hist.history["lr"][0], 0.1, rtol=1e-5)
    np.testing.assert_allclose(hist.history["lr"][1], 0.01, rtol=1e-5)


def test_compression_is_the_tf_surface_and_backend_gate(hvd1):
    """``Compression`` resolves to the TF front-end's, and the optimizer
    wrapper refuses no optimizer on the TF backend."""
    import keras

    import horovod_tpu_torch.tensorflow as hvd_tf

    assert hvd1.Compression is hvd_tf.Compression
    opt = hvd1.DistributedOptimizer(keras.optimizers.SGD(0.1))
    assert type(opt).__name__ == "DistributedSGD"
