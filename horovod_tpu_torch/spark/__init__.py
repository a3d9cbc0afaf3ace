"""Spark integration: ``horovod_tpu_torch.spark.run(fn, ...)``.  The port
of ``horovod_tpu/spark/__init__.py``.

Role parity: ``horovod/spark/__init__.py`` — run a training function in
``num_proc`` Spark tasks, with rank/local-rank assignment, a rendezvous
back to the driver, and per-rank results returned to the caller.  Spark
2.4+ barrier execution mode: the tasks rendezvous against the driver's
HTTP server (the port's ``runner/http_server.py``) exactly like the
port's launcher's workers do.  Each task initializes the port's runtime
as the launcher's function mode does (``runner/run_task.py``): on
``device`` (the card, ``cuda:<local_rank>``, when None) with the eager
engine and no process group.

``run()`` is gated on the ``pyspark`` package, and it is executed end to
end without it by
``tests/test_torch_spark.py`` against the pyspark-API shim of
``tests/pyspark_shim``, whose barrier tasks are real separate processes.
The Estimator API (``spark/estimator.py``) is not gated: it materializes
to parquet with pyarrow and runs through either the Spark barrier backend
or the port's launcher, so ``TorchEstimator``/``KerasEstimator`` run
without a Spark cluster.  Nothing is left out.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, List, Optional

try:
    import pyspark  # noqa: F401

    _HAVE_PYSPARK = True
except ImportError:
    _HAVE_PYSPARK = False


def _require_pyspark(what: str):
    if not _HAVE_PYSPARK:
        raise ImportError(
            f"horovod_tpu_torch.spark.{what} requires the `pyspark` package, "
            "which is not installed in this environment. For multi-"
            "process launching without Spark, use the `hvdrun-torch` "
            "launcher or the programmatic horovod_tpu_torch.runner.run."
            "run() API.")


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        start_timeout: float = 600.0, env=None,
        verbose: int = 1, device=None) -> List[Any]:
    """Runs ``fn(*args, **kwargs)`` on ``num_proc`` Spark tasks as one
    Horovod job; returns the per-rank results ordered by rank (parity:
    horovod/spark/__init__.py:104 run()).

    Requires the cluster to support barrier execution mode (Spark 2.4+),
    which guarantees gang scheduling — all ranks run concurrently, the
    property the reference builds its own task-service machinery for.
    Task stdout/stderr go to Spark's executor logs.  ``device`` is
    each task's (the card, ``cuda:<local_rank>``, when None).
    """
    _require_pyspark("run")
    kwargs = kwargs or {}
    extra_env = dict(env or {})
    extra_env.setdefault("HVD_START_TIMEOUT", str(start_timeout))

    from pyspark import BarrierTaskContext
    from pyspark.sql import SparkSession

    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_server import RendezvousServer
    from horovod_tpu_torch.runner.run import _routable_address

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = max(1, sc.defaultParallelism)

    # Prefer the address Spark already knows executors can reach the
    # driver at; fall back to default-route discovery (hostname
    # resolution often yields loopback on Debian-style /etc/hosts).
    addr = sc.getConf().get("spark.driver.host", None) or \
        _routable_address()
    job_secret = secret_mod.make_secret()
    server = RendezvousServer(addr, secret=job_secret)
    port = server.start()
    nproc = num_proc
    if verbose:
        print(f"horovod_tpu_torch.spark: launching {nproc} barrier tasks, "
              f"rendezvous at {addr}:{port}")

    def _task(_iterator):
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        # Slot assignment from the gang's host placement, mirroring the
        # launcher (runner/hosts.py): hosts ordered by first appearance;
        # the cross "axis" at local index L spans the hosts that have a
        # local rank L.
        hosts = [info.address.split(":")[0]
                 for info in ctx.getTaskInfos()]
        by_host = OrderedDict()
        for r, h in enumerate(hosts):
            by_host.setdefault(h, []).append(r)
        my_host = hosts[rank]
        local_rank = by_host[my_host].index(rank)
        cross_hosts = [h for h, rs in by_host.items()
                       if len(rs) > local_rank]

        task_env = {
            "HVD_RANK": str(rank),
            "HVD_SIZE": str(nproc),
            "HVD_LOCAL_RANK": str(local_rank),
            "HVD_LOCAL_SIZE": str(len(by_host[my_host])),
            "HVD_CROSS_RANK": str(cross_hosts.index(my_host)),
            "HVD_CROSS_SIZE": str(len(cross_hosts)),
            "HVD_RENDEZVOUS_ADDR": addr,
            "HVD_RENDEZVOUS_PORT": str(port),
            secret_mod.ENV_VAR: job_secret,
            # Stage retries must not rendezvous against a previous
            # attempt's stale addresses on the still-running server.
            "HVD_RDV_SCOPE": f"attempt{ctx.stageAttemptNumber()}",
        }
        task_env.update(extra_env)
        # Snapshot + restore: PySpark reuses worker processes, and stale
        # HVD_* would hijack a later unrelated hvd.init() in this app.
        saved = {k: os.environ.get(k) for k in task_env}
        os.environ.update(task_env)

        import horovod_tpu_torch as hvd

        try:
            hvd.init(device=device, backend="none")
            try:
                result = fn(*args, **kwargs)
            finally:
                hvd.shutdown()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        yield rank, result

    try:
        pairs = (sc.parallelize(range(nproc), nproc)
                 .barrier()
                 .mapPartitions(_task)
                 .collect())
    finally:
        server.stop()
    return [result for _, result in sorted(pairs)]


from horovod_tpu_torch.spark.estimator import (  # noqa: E402,F401
    HorovodEstimator,
    KerasEstimator,
    KerasModel,
    LocalBackend,
    SparkBackend,
    TorchEstimator,
    TorchModel,
)
from horovod_tpu_torch.spark.store import LocalStore, Store  # noqa: E402,F401
