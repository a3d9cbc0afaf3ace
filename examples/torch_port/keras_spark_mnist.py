"""Keras estimator on a DataFrame, the Spark-estimator workflow, on the
port.

The twin of ``examples/keras_spark_mnist.py`` on
``horovod_tpu_torch.spark``: DataFrame → ``KerasEstimator`` →
distributed ``fit`` → prediction.  Synthetic data; Spark barrier mode
with a live pyspark session, the port's launcher function mode
otherwise::

    python examples/torch_port/keras_spark_mnist.py --num-proc 2 \
        --device cpu

``--device`` is where each training rank's runtime starts (default: its
card); Keras itself runs on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--num-proc", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    args = p.parse_args()

    import keras

    from horovod_tpu_torch.spark.estimator import KerasEstimator
    from horovod_tpu_torch.spark.store import Store

    rs = np.random.RandomState(42)
    X = rs.rand(4096, 28 * 28).astype(np.float32)
    teacher = np.random.RandomState(0).randn(28 * 28, 10)
    y = np.argmax(X @ teacher, axis=1).astype(np.float32)
    df = {"features": X, "label": y}

    model = keras.Sequential([
        keras.layers.Input((28 * 28,)),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dense(10, activation="softmax"),
    ])

    work_dir = args.work_dir or tempfile.mkdtemp(prefix="hvd_store_")
    est = KerasEstimator(
        model,
        optimizer=keras.optimizers.Adam(learning_rate=1e-3),
        loss="sparse_categorical_crossentropy",
        store=Store.create(work_dir),
        feature_cols=("features",),
        label_cols=("label",),
        num_proc=args.num_proc,
        batch_size=args.batch_size,
        epochs=args.epochs,
        device=args.device,
    )
    fitted = est.fit(df)

    pred = fitted.predict(X[:512])
    acc = float(np.mean(np.argmax(pred, axis=1) == y[:512]))
    print(f"train history: {fitted.history}")
    print(f"accuracy on 512 train rows: {acc:.3f}")
    assert acc > 0.5, "estimator fit did not learn the teacher"
    print("DONE")


if __name__ == "__main__":
    main()
