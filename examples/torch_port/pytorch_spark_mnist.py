"""Torch estimator on a DataFrame, the Spark-estimator workflow, on the
port.

The twin of ``examples/pytorch_spark_mnist.py`` on
``horovod_tpu_torch.spark``: build a DataFrame, hand a torch model to
``TorchEstimator``, ``fit`` runs distributed training on each rank's
device, the returned model predicts.  Synthetic data; Spark barrier mode
with a live pyspark session, the port's launcher function mode otherwise,
so the example runs anywhere::

    python examples/torch_port/pytorch_spark_mnist.py --num-proc 2
    python examples/torch_port/pytorch_spark_mnist.py --device cpu
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
    p.add_argument("--work-dir", default=None,
                   help="Store prefix: a local path or an fsspec URL "
                        "(gs://bucket/prefix on a pod) "
                        "(default: a temp dir)")
    p.add_argument("--validation", type=float, default=0.1,
                   help="held-out fraction scored every epoch (0 "
                        "disables)")
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    args = p.parse_args()

    import torch.nn as nn

    from horovod_tpu_torch.spark.estimator import TorchEstimator
    from horovod_tpu_torch.spark.store import Store

    # Synthetic MNIST-shaped task: 28x28 features, a linear teacher.
    rs = np.random.RandomState(42)
    X = rs.rand(4096, 28 * 28).astype(np.float32)
    teacher = np.random.RandomState(0).randn(28 * 28, 10)
    y = np.argmax(X @ teacher, axis=1).astype(np.int64)
    df = {"features": X, "label": y}

    model = nn.Sequential(
        nn.Linear(28 * 28, 128), nn.ReLU(), nn.Linear(128, 10))

    work_dir = args.work_dir or tempfile.mkdtemp(prefix="hvd_store_")
    est = TorchEstimator(
        model,
        loss=nn.CrossEntropyLoss(),
        store=Store.create(work_dir),
        feature_cols=("features",),
        label_cols=("label",),
        num_proc=args.num_proc,
        batch_size=args.batch_size,
        epochs=args.epochs,
        validation=args.validation or None,
        device=args.device,
    )
    fitted = est.fit(df)
    # A second fit with the same run_id would resume from the per-epoch
    # checkpoints the store now holds (see fitted.run_id).

    pred = fitted.predict(X[:512])
    acc = float(np.mean(np.argmax(pred, axis=1) == y[:512]))
    print(f"train history: {fitted.history}")
    if fitted.val_history:
        print(f"validation history: {fitted.val_history}")
    print(f"accuracy on 512 train rows: {acc:.3f}")
    assert acc > 0.5, "estimator fit did not learn the teacher"
    print("DONE")


if __name__ == "__main__":
    main()
