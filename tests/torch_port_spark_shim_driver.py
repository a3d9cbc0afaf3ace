"""Driver of the port's ``spark.run()`` under ``tests/pyspark_shim``
(``tests/test_torch_spark.py``): ``tests/spark_shim_driver.py``'s
scenarios on ``horovod_tpu_torch.spark``, every task on ``device="cpu"``.

Runs with ``tests/pyspark_shim`` on ``PYTHONPATH``: the port's
``spark.run`` executes for real (its driver-side ``RendezvousServer``,
the tasks' environment, worker processes calling ``hvd.init()`` and eager
collectives over the live engine gang) with only the Spark task
scheduler shimmed.

  1. run() with an explicit num_proc: rank-ordered results, the gang's
     arithmetic, the rank/local_rank/cross_size wiring;
  2. run() with num_proc=None: sc.defaultParallelism;
  3. TorchEstimator.fit through SparkBackend (the barrier path the
     estimators take when a Spark session is live).

Prints ``SPARK_RUN_E2E_OK`` at the end.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def train():
    import numpy as np

    import horovod_tpu_torch as hvd

    out = hvd.allreduce(np.ones(4) * (hvd.rank() + 1), op=hvd.Sum,
                        name="spark.t")
    bcast = hvd.broadcast(np.arange(3.0) if hvd.rank() == 0
                          else np.zeros(3), root_rank=0, name="spark.b")
    return (float(out[0]), list(map(float, bcast)), hvd.rank(),
            hvd.size(), hvd.local_rank(), hvd.cross_size(),
            str(hvd.device()))


def main() -> None:
    import pyspark  # the shim: fails loudly if PYTHONPATH is wrong

    assert hasattr(pyspark, "BarrierTaskContext")
    import horovod_tpu_torch.spark as hvd_spark

    assert hvd_spark._HAVE_PYSPARK, "shim not picked up"

    results = hvd_spark.run(train, num_proc=2, verbose=0, device="cpu")
    assert [r[2] for r in results] == [0, 1], results
    assert all(r[0] == 3.0 for r in results), results
    assert all(r[1] == [0.0, 1.0, 2.0] for r in results), results
    assert all(r[3] == 2 for r in results), results
    assert [r[4] for r in results] == [0, 1], results  # same host
    assert all(r[6] == "cpu" for r in results), results
    print("scenario 1 ok: spark.run 2-rank gang")

    os.environ["PYSPARK_SHIM_PARALLELISM"] = "3"
    results = hvd_spark.run(train, num_proc=None, verbose=0, device="cpu")
    assert len(results) == 3 and all(r[3] == 3 for r in results), results
    assert all(r[0] == 6.0 for r in results), results
    print("scenario 2 ok: num_proc from defaultParallelism")

    import numpy as np
    import pandas as pd
    import torch

    from horovod_tpu_torch.spark import SparkBackend, TorchEstimator
    from horovod_tpu_torch.spark.store import Store

    rs = np.random.RandomState(3)
    X = rs.randn(192, 5).astype(np.float32)
    w = rs.randn(5, 1).astype(np.float32)
    y = (X @ w).ravel()
    df = pd.DataFrame({"features": list(X), "label": y})
    with tempfile.TemporaryDirectory() as td:
        est = TorchEstimator(
            torch.nn.Linear(5, 1),
            optimizer=torch.optim.SGD(
                torch.nn.Linear(5, 1).parameters(), lr=0.05),
            loss=torch.nn.MSELoss(),
            feature_cols=["features"], label_cols=["label"],
            batch_size=32, epochs=3, num_proc=2,
            store=Store.create(td), backend=SparkBackend(2, device="cpu"))
        fitted = est.fit(df)
    assert fitted.history[-1] < fitted.history[0], fitted.history
    print("scenario 3 ok: TorchEstimator via SparkBackend barrier mode")

    print("SPARK_RUN_E2E_OK")


if __name__ == "__main__":
    main()
