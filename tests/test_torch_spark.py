"""The port's Spark layer (``horovod_tpu_torch.spark``: ``run``, the stores,
``materialize`` and the estimators) against the JAX package's
(``horovod_tpu.spark``).

* ``run()`` executes end to end under ``tests/pyspark_shim``
  (``tests/torch_port_spark_shim_driver.py``), and without pyspark raises
  the JAX module's ``ImportError``;
* the stores and ``materialize`` (local and ``memory://`` round trips,
  the scheme dispatch, the checkpoint cycle, the validation split and
  column, the digest that skips a rewrite, the split guards), the
  pickle-free Keras checkpoint codec (the same bytes as the JAX codec's,
  and a poisoned payload refused) and the optimizer-slot restore, each
  held to the JAX package's result on the same inputs;
* the estimators through the port's launcher (``LocalBackend(2,
  device="cpu")``), their fits started together in threads: a
  ``TorchEstimator`` fit with validation and a metric, whose fitted
  weights and histories equal the JAX ``TorchEstimator``'s on the same
  seed and data bit for bit (tolerance 0); the same fit in two calls, two
  epochs and then four under one ``run_id``, which resumes from the
  store to the same weights; a ``KerasEstimator`` fit with a custom layer
  over an fsspec store, resumed and loaded back (``KerasModel.load``),
  and ``TorchModel.load``; and a fit whose store holds a poisoned
  checkpoint, which fails without running it.
"""

import io
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest

import horovod_tpu.spark.estimator as jax_est
import horovod_tpu.spark.store as jax_store
import horovod_tpu_torch.spark.estimator as port_est
import horovod_tpu_torch.spark.store as port_store

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKGS = {"port": (port_est, port_store), "jax": (jax_est, jax_store)}


def _teacher_frame(n=256, d=6, seed=3):
    import pandas as pd

    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    w = rs.randn(d, 1).astype(np.float32)
    y = (X @ w).ravel()
    return pd.DataFrame({"features": list(X), "label": y}), X, y


# ---------------------------------------------------------------------------
# run(): the gate and the barrier shim
# ---------------------------------------------------------------------------


def test_run_gated_without_pyspark():
    import horovod_tpu_torch.spark as hvd_spark

    if hvd_spark._HAVE_PYSPARK:
        pytest.skip("pyspark installed; gating not applicable")
    with pytest.raises(ImportError,
                       match="horovod_tpu_torch.spark.run requires the "
                             "`pyspark` package"):
        hvd_spark.run(lambda: None, num_proc=2)


@pytest.mark.timeout(300)
def test_run_executes_under_barrier_shim():
    """The driver runs in a subprocess, so that the shim's ``pyspark``
    never enters this process's modules."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "pyspark_shim"), REPO]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env = {k: v for k, v in env.items() if not k.startswith("HVD_")}
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE,
                                      "torch_port_spark_shim_driver.py")],
        capture_output=True, text=True, timeout=280, env=env)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    assert "SPARK_RUN_E2E_OK" in proc.stdout, proc.stdout[-2000:]


# ---------------------------------------------------------------------------
# stores, materialize, codecs: each package on the same inputs
# ---------------------------------------------------------------------------


def _shards(est, store, run_id, n, val=False):
    return [est.read_shard(store, run_id, r, n, ["features"], ["label"],
                           val=val) for r in range(n)]


@pytest.mark.parametrize("where", ["local", "memory"])
def test_materialize_roundtrip_equals_jax(tmp_path, where):
    df, X, y = _teacher_frame(64, 4)
    got = {}
    for pkg, (est, st) in PKGS.items():
        url = (str(tmp_path / pkg) if where == "local"
               else f"memory://est-roundtrip-{pkg}")
        store = st.Store.create(url)
        try:
            assert est.materialize(df, store, "r1", num_shards=4) == 64
            paths = store.shard_paths("r1")
            assert len(paths) == 4
            if where == "memory":
                assert all(p.startswith("memory://") for p in paths)
            got[pkg] = _shards(est, store, "r1", 4)
        finally:
            if where == "memory":
                store.delete(store.prefix_path)
    Xs, ys = zip(*got["port"])
    np.testing.assert_array_equal(np.concatenate(Xs), X)
    np.testing.assert_array_equal(np.concatenate(ys).ravel(), y)
    for (a, b), (c, d) in zip(got["port"], got["jax"]):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


def test_store_create_dispatches_by_scheme(tmp_path):
    st = port_store
    assert isinstance(st.Store.create(str(tmp_path)), st.LocalStore)
    assert isinstance(st.Store.create(f"file://{tmp_path}"), st.LocalStore)
    assert isinstance(st.Store.create("memory://est"), st.FsspecStore)


@pytest.mark.parametrize("url", ["local", "memory://est-ckpt-port"])
def test_store_checkpoint_cycle(tmp_path, url):
    store = port_store.Store.create(str(tmp_path) if url == "local"
                                    else url)
    try:
        assert store.latest_checkpoint("r") is None
        store.save_checkpoint("r", 0, b"epoch0")
        store.save_checkpoint("r", 3, b"epoch3")
        store.save_checkpoint("r", 1, b"epoch1")
        assert store.latest_checkpoint("r") == (3, b"epoch3")
        # keep=2: the oldest went
        names = sorted(os.path.basename(p)
                       for p in store.listdir(store.run_path("r")))
        assert names == ["checkpoint-epoch00001.bin",
                         "checkpoint-epoch00003.bin"], names
    finally:
        if url != "local":
            store.delete(store.prefix_path)


def test_materialize_validation_split_and_column_equal_jax(tmp_path):
    df, X, y = _teacher_frame(100, 4)
    df2 = df.copy()
    df2["is_val"] = [1] * 10 + [0] * 90
    got = {}
    for pkg, (est, st) in PKGS.items():
        store = st.Store.create(str(tmp_path / pkg))
        assert est.materialize(df, store, "rv", 2, validation=0.2,
                               seed=7) == 80
        assert est.materialize(df2, store, "rc", 2,
                               validation="is_val") == 90
        with store.open(store.shard_paths("rc")[0], "rb") as f:
            import pyarrow.parquet as pq

            assert "is_val" not in pq.read_table(f).to_pandas().columns
        with pytest.raises(ValueError, match="validation"):
            est.materialize(df, store, "rx", 2, validation=1.5)
        with pytest.raises(ValueError, match="at least one validation row"):
            est.materialize(df.head(10), store, "ry", 4, validation=0.1)
        got[pkg] = [x for run in ("rv", "rc") for val in (False, True)
                    for pair in _shards(est, store, run, 2, val)
                    for x in pair]
    assert len(got["port"]) == len(got["jax"]) == 16
    for a, b in zip(got["port"], got["jax"]):
        assert a.tobytes() == b.tobytes()
    Xt = np.concatenate(got["port"][0:4:2])
    Xv = np.concatenate(got["port"][4:8:2])
    assert len(Xt) == 80 and len(Xv) == 20
    np.testing.assert_allclose(
        np.sort(np.vstack([Xt, Xv]).sum(axis=1)), np.sort(X.sum(axis=1)),
        rtol=1e-5)


def test_materialize_digest_skips_identical_data(tmp_path):
    import time

    df, X, y = _teacher_frame(64, 4)
    est, st = PKGS["port"]
    store = st.Store.create(str(tmp_path))
    n1 = est.materialize(df, store, "rc", 2)
    shard = store.shard_paths("rc")[0]
    mtime = os.path.getmtime(shard)
    time.sleep(0.05)
    assert est.materialize(df.copy(), store, "rc", 2) == n1 == 64
    assert os.path.getmtime(shard) == mtime, "identical data rewrote"
    df2 = df.copy()
    df2["label"] = df2["label"] * 2
    assert est.materialize(df2, store, "rc", 2) == 64
    assert os.path.getmtime(store.shard_paths("rc")[0]) != mtime
    est.materialize(df, store, "rc", 4)
    assert len(store.shard_paths("rc")) == 4
    # the digest is the JAX package's
    for nshards, val in ((2, None), (3, 0.25), (2, "label")):
        assert est._df_digest(df, nshards, val, 5) == \
            jax_est._df_digest(df, nshards, val, 5)


def test_materialize_train_split_smaller_than_ranks_fails_fast(tmp_path):
    df, _, _ = _teacher_frame(16, 4)
    store = port_store.Store.create(str(tmp_path))
    with pytest.raises(ValueError, match="at least one training row"):
        port_est.materialize(df.head(3), store, "rsmall", 4)
    assert port_est.materialize(df.head(4), store, "rok", 4) == 4


def test_keras_ckpt_codec_roundtrip_equals_jax_bytes():
    weights = [np.arange(6, dtype=np.float32).reshape(2, 3),
               np.ones(3, np.float64)]
    opt_vars = [np.zeros(4, np.float32), np.float32(7.0)]
    hist = {"loss": [1.5, 0.5], "val_loss": [2.0, 1.0]}
    blob = port_est._keras_ckpt_encode(weights, opt_vars, hist)
    assert blob == jax_est._keras_ckpt_encode(weights, opt_vars, hist)
    out = port_est._keras_ckpt_decode(blob)
    for a, b in zip(out["weights"], weights):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out["opt_vars"], opt_vars):
        np.testing.assert_array_equal(a, b)
    assert out["history"] == hist
    out2 = port_est._keras_ckpt_decode(
        port_est._keras_ckpt_encode(weights, None, {}))
    assert out2["opt_vars"] is None and out2["history"] == {}


def test_keras_ckpt_decode_rejects_pickle_payloads(tmp_path):
    sentinel = tmp_path / "owned"

    class Evil:
        def __reduce__(self):
            return (open, (str(sentinel), "w"))

    with pytest.raises(Exception):
        port_est._keras_ckpt_decode(pickle.dumps({"weights": Evil()}))
    buf = io.BytesIO()
    np.savez(buf, meta=np.array([{"evil": Evil()}], dtype=object))
    with pytest.raises(ValueError):
        port_est._keras_ckpt_decode(buf.getvalue())
    assert not sentinel.exists(), "a poisoned payload ran on load"


class _FakeVar:
    def __init__(self, shape, name="v"):
        self.shape = tuple(shape)
        self.name = name
        self.value = np.zeros(shape, np.float32)

    def assign(self, val):
        self.value = np.array(val, np.float32)


def test_restore_optimizer_slots_validates_count_and_shape():
    restore = port_est._restore_optimizer_slots
    good = [np.full((2, 3), 2.0, np.float32), np.full(3, 5.0, np.float32)]
    variables = [_FakeVar((2, 3), "m"), _FakeVar((3,), "s")]
    assert restore(variables, good) is True
    np.testing.assert_array_equal(variables[1].value, good[1])
    variables = [_FakeVar((2, 3))]
    with pytest.warns(UserWarning, match="slot variables"):
        assert restore(variables, good) is False
    variables = [_FakeVar((2, 3)), _FakeVar((4,))]
    with pytest.warns(UserWarning, match="shape"):
        assert restore(variables, good) is False
    np.testing.assert_array_equal(variables[0].value, np.zeros((2, 3)))


# ---------------------------------------------------------------------------
# the estimators through the launchers, fitted together
# ---------------------------------------------------------------------------


def _torch_estimator(pkg, root, epochs, run_id, store=None):
    """Made in the main thread: the model's initial weights come from the
    global torch seed, which threads would race on."""
    import torch

    est_mod, st = PKGS[pkg]

    def _mae(pred, target):  # local: the ranks get it by value
        return (pred - target).abs().mean()

    torch.manual_seed(0)
    model = torch.nn.Linear(6, 1)
    backend = (est_mod.LocalBackend(2, device="cpu")
               if pkg == "port" else est_mod.LocalBackend(2))
    return est_mod.TorchEstimator(
        model, optimizer=torch.optim.SGD(model.parameters(), lr=0.05),
        loss=torch.nn.MSELoss(), metrics=[_mae],
        feature_cols=["features"], label_cols=["label"], batch_size=32,
        epochs=epochs, num_proc=2,
        store=store or st.Store.create(str(root / f"{pkg}-{run_id}")),
        backend=backend, run_id=run_id, validation=0.25)


def _keras_estimators(root):
    """Two estimators over one fsspec store and run_id, of two epochs and
    of four, with a custom layer; and the store and the layer's class."""
    import keras

    @keras.saving.register_keras_serializable(package="hvdtest")
    class Scale2(keras.layers.Layer):
        def call(self, x):
            return x * 2.0

    store = port_store.FsspecStore(f"file://{root}/kest")
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.layers.Input((4,)), Scale2(),
                              keras.layers.Dense(1)])
    ests = [port_est.KerasEstimator(
        model, optimizer=keras.optimizers.SGD(learning_rate=0.05),
        loss="mse", feature_cols=["features"], label_cols=["label"],
        batch_size=32, epochs=epochs, num_proc=2, store=store,
        backend=port_est.LocalBackend(2, device="cpu"),
        run_id="kresume", custom_objects={"Scale2": Scale2},
        validation=0.25) for epochs in (2, 4)]
    return ests, store, Scale2


def _poisoned_estimator(root):
    """A fit whose store's newest epoch checkpoint runs code when
    unpickled; and the file that code would make."""
    import torch

    sentinel = root / "owned"

    class Evil:
        def __reduce__(self):
            return (open, (str(sentinel), "w"))

    store = port_store.Store.create(str(root / "poisoned"))
    store.save_checkpoint("poisoned", 0, pickle.dumps({"model": Evil()}))
    torch.manual_seed(1)
    model = torch.nn.Linear(6, 1)
    return port_est.TorchEstimator(
        model, optimizer=torch.optim.SGD(model.parameters(), lr=0.05),
        loss=torch.nn.MSELoss(), feature_cols=["features"],
        label_cols=["label"], batch_size=32, epochs=1, num_proc=2,
        store=store, backend=port_est.LocalBackend(2, device="cpu"),
        run_id="poisoned"), sentinel


def _refused(est, df):
    try:
        est.fit(df)
    except Exception as e:
        return e
    return None


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("estimators")
    df = _teacher_frame()[0]
    kdf = _teacher_frame(128, 4, seed=5)[0]
    again = port_store.Store.create(str(root / "again"))
    torch_ests = {
        "jax": _torch_estimator("jax", root, 4, "full"),
        "port": _torch_estimator("port", root, 4, "full"),
        "again2": _torch_estimator("port", root, 2, "again", again),
        "again4": _torch_estimator("port", root, 4, "again", again)}
    kests, kstore, scale2 = _keras_estimators(root)
    poisoned, sentinel = _poisoned_estimator(root)
    jobs = {
        "jax": lambda: torch_ests["jax"].fit(df),
        "port": lambda: torch_ests["port"].fit(df),
        "resumed": lambda: (torch_ests["again2"].fit(df),
                            torch_ests["again4"].fit(df)),
        "keras": lambda: (kests[0].fit(kdf), kests[1].fit(kdf), kstore,
                          scale2),
        "poisoned": lambda: (_refused(poisoned, _teacher_frame(64, 6)[0]),
                             sentinel),
    }
    out = {}

    def run(name, fn):
        try:
            out[name] = fn()
        except BaseException as e:  # reported by the test that reads it
            out[name] = e

    threads = [threading.Thread(target=run, args=item) for item in
               jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, root


def _got(fits, name):
    value = fits[0][name]
    if isinstance(value, BaseException):
        raise value
    return value


@pytest.mark.timeout(600)
def test_torch_estimator_weights_equal_jax_estimator(fits):
    """Same seed and data: the port's fitted weights and histories are
    the JAX estimator's, bit for bit (tolerance 0)."""
    port, jax_fit = _got(fits, "port"), _got(fits, "jax")
    for (k, a), (k2, b) in zip(
            port.getModel().state_dict().items(),
            jax_fit.getModel().state_dict().items()):
        assert k == k2
        assert a.numpy().tobytes() == b.numpy().tobytes(), k
    assert port.history == jax_fit.history
    assert port.val_history == jax_fit.val_history
    assert port.metrics_history == jax_fit.metrics_history
    assert port.val_metrics_history == jax_fit.val_metrics_history
    assert len(port.history) == 4 and port.history[-1] < \
        port.history[0] * 0.5
    assert list(port.metrics_history) == ["_mae"]
    _, X, y = _teacher_frame()
    mse = float(np.mean((port.predict(X).ravel() - y) ** 2))
    assert mse < 0.5 * float(np.var(y)), mse
    assert "label__output" in port.transform(_teacher_frame()[0]).columns


@pytest.mark.timeout(600)
def test_torch_estimator_resumes_to_the_uninterrupted_weights(fits):
    """Two epochs, then four under the same run_id: the second fit
    resumes from the store's epoch-1 checkpoint and ends on the weights
    and histories of the fit of four epochs in one call."""
    first, second = _got(fits, "resumed")
    full = _got(fits, "port")
    assert len(first.history) == 2
    assert second.history[:2] == first.history
    assert second.history == full.history
    for (k, a), (_, b) in zip(second.getModel().state_dict().items(),
                              full.getModel().state_dict().items()):
        assert a.numpy().tobytes() == b.numpy().tobytes(), k


@pytest.mark.timeout(600)
def test_torch_model_loads_from_store(fits):
    import torch

    full = _got(fits, "port")
    root = fits[1]
    store = port_store.Store.create(str(root / "port-full"))
    loaded = port_est.TorchModel.load(store, "full", torch.nn.Linear(6, 1))
    _, X, _ = _teacher_frame()
    np.testing.assert_array_equal(loaded.predict(X), full.predict(X))


@pytest.mark.timeout(600)
def test_keras_estimator_fits_resumes_and_loads(fits):
    first, second, store, scale2 = _got(fits, "keras")
    losses = second.history["loss"]
    assert len(first.history["loss"]) == 2 and len(losses) == 4
    np.testing.assert_allclose(losses[:2], first.history["loss"],
                               rtol=1e-6)
    assert losses[-1] < losses[0] * 0.5, losses
    assert len(second.history["val_loss"]) == 4
    assert store.latest_checkpoint("kresume")[0] == 3
    assert any(isinstance(layer, scale2)
               for layer in second.getModel().layers)
    loaded = port_est.KerasModel.load(store, "kresume",
                                      custom_objects={"Scale2": scale2})
    _, X, _ = _teacher_frame(128, 4, seed=5)
    np.testing.assert_allclose(loaded.predict(X), second.predict(X),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.timeout(600)
def test_torch_resume_refuses_poisoned_checkpoint(fits):
    err, sentinel = _got(fits, "poisoned")
    assert err is not None, "the poisoned fit succeeded"
    assert not sentinel.exists(), "the poisoned checkpoint ran on load"
