"""Estimator API: fit a Keras or Torch model on a DataFrame.  The port of
``horovod_tpu/spark/estimator.py``.

Role parity: ``horovod/spark/common/estimator.py`` (HorovodEstimator),
``spark/keras/estimator.py`` and ``spark/torch/estimator.py`` +
``torch/remote.py`` — there: materialize the DataFrame to Parquet in a
``Store`` with Petastorm, run a remote training fn under mpirun-on-Spark,
return a Spark Model.  Redesigned for this stack:

* Materialization is plain pyarrow parquet, one shard per rank, written
  through :class:`horovod_tpu_torch.spark.store.Store` — works with a
  pyspark DataFrame, a pandas DataFrame, or a dict of numpy arrays, so
  the whole estimator path executes (and is tested) without a Spark
  cluster.
* The distributed run uses ``horovod_tpu_torch.spark.run`` (barrier
  mode) when a Spark session is available, else the port's launcher's
  programmatic ``horovod_tpu_torch.runner.run.run`` — the estimator is
  backend-agnostic the way the reference's ``Backend`` abstraction
  intended.
* The fitted wrapper exposes ``getModel()`` / ``predict`` / ``transform``
  (pandas in, pandas out) instead of a Spark Transformer.

``TorchEstimator`` trains through the port's classic torch front-end
(``horovod_tpu_torch.torch``) on the ranks' ``device`` (the estimator's
keyword; the card, ``cuda:<local_rank>``, when None, as every entry
point of the port's); ``KerasEstimator`` through the port's Keras
front-end.  The ranks initialize as the launcher's function mode does, on
that device with the eager engine and no process group.  Nothing is left
out.
"""

from __future__ import annotations

import copy
import os
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.spark.store import Store


# ---------------------------------------------------------------------------
# data plumbing
# ---------------------------------------------------------------------------


def _to_pandas(df):
    if hasattr(df, "toPandas"):          # pyspark DataFrame
        return df.toPandas()
    if hasattr(df, "iloc"):              # already pandas
        return df
    import pandas as pd

    return pd.DataFrame({k: list(np.asarray(v)) for k, v in df.items()})


def _df_digest(pdf, num_shards: int, validation, seed: int) -> str:
    """Content digest of a materialization request (parity:
    spark/common/cache.py TrainingDataCache — repeated fits over the
    same data skip the Petastorm re-write there; the parquet re-write
    here).  Hashes the raw column bytes: equal bytes = equal shards."""
    import hashlib

    m = hashlib.sha1()
    m.update(repr((sorted(map(str, pdf.columns)), num_shards,
                   validation, seed)).encode())
    for c in sorted(map(str, pdf.columns)):
        col = pdf[c].to_numpy()
        # dtype + length prefix: byte-identical buffers of different
        # dtypes (int32 [1,2] vs int64 [big]) must not collide.
        m.update(f"{c}:{col.dtype.str}:{len(col)}:".encode())
        if col.dtype == object:
            # NEVER col.tobytes() on object arrays — that serializes
            # heap POINTERS (no error raised), so equal values hash
            # differently and, worse, recycled addresses can collide.
            hashed = False
            if len(col) and isinstance(col[0], (list, np.ndarray)):
                try:
                    arr = np.stack([np.asarray(v) for v in col])
                    m.update(f"{arr.dtype.str}:{arr.shape}:".encode())
                    m.update(np.ascontiguousarray(arr).tobytes())
                    hashed = True
                except (TypeError, ValueError):
                    pass
            if not hashed:
                m.update(repr(col.tolist()).encode())
        else:
            m.update(np.ascontiguousarray(col).tobytes())
    return m.hexdigest()


def _write_shards(pdf, store: Store, path: str, num_shards: int) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    store.delete(path)
    store.makedirs(path)
    bounds = np.linspace(0, len(pdf), num_shards + 1).astype(int)
    for i in range(num_shards):
        shard = pdf.iloc[bounds[i]:bounds[i + 1]]
        # Through the store's own open() so remote (fsspec) stores get
        # the shards too, not just local paths.
        with store.open(store.join(path, f"part-{i:05d}.parquet"),
                        "wb") as f:
            pq.write_table(pa.Table.from_pandas(shard), f)


def materialize(df, store: Store, run_id: str, num_shards: int,
                validation=None, seed: int = 0) -> int:
    """Write ``df`` as ``num_shards`` parquet shards (shard i is rank i's
    training data).  Returns the training row count.  Parity:
    ``util.prepare_data`` + Petastorm materialization in
    ``spark/common/util.py``.

    ``validation`` (parity: common/params.py:52 + util.py:426-449):
    a float in (0, 1) holds out that fraction of rows (seeded shuffle);
    a string names an indicator column — truthy rows become the
    validation set and the column is dropped from both splits.
    Validation shards land in ``store.val_data_path(run_id)``.

    Repeated fits over byte-identical data under the same ``run_id``
    skip the re-write entirely (a content digest is stored alongside
    the shards; parity: spark/common/cache.py TrainingDataCache).
    """
    pdf = _to_pandas(df)
    digest = _df_digest(pdf, num_shards, validation, seed)
    digest_path = store.join(store.train_data_path(run_id), "_digest")
    try:
        prev = store.read_bytes(digest_path).decode().splitlines()
        if prev and prev[0] == digest:
            return int(prev[1])
    except Exception:
        pass  # absent/corrupt digest -> materialize fresh
    val_pdf = None
    if validation is not None:
        if isinstance(validation, str):
            mask = pdf[validation].astype(bool).to_numpy()
            val_pdf = pdf[mask].drop(columns=[validation])
            pdf = pdf[~mask].drop(columns=[validation])
        elif isinstance(validation, float) and 0 < validation < 1:
            rs = np.random.RandomState(seed)
            idx = rs.permutation(len(pdf))
            n_val = int(round(len(pdf) * validation))
            val_pdf = pdf.iloc[idx[:n_val]]
            pdf = pdf.iloc[idx[n_val:]]
        else:
            raise ValueError(
                f"validation must be a float in (0, 1) or a column "
                f"name, got {validation!r}")
    if val_pdf is not None and len(val_pdf) < num_shards:
        # Fail here, not as a per-rank shape error mid-collective: an
        # empty shard on some ranks only would desync the epoch-end
        # val-loss allreduce.
        raise ValueError(
            f"validation selected {len(val_pdf)} row(s) but the job "
            f"has {num_shards} ranks; every rank needs at least one "
            "validation row — increase the fraction or provide more "
            "rows")
    if len(pdf) < num_shards:
        # Same desync hazard on the training side: some ranks would get
        # an empty shard and fail (or skip steps) mid-gang.
        raise ValueError(
            f"training split has {len(pdf)} row(s) but the job has "
            f"{num_shards} ranks; every rank needs at least one "
            "training row — provide more rows or reduce num_proc")
    _write_shards(pdf, store, store.train_data_path(run_id), num_shards)
    if val_pdf is not None:
        _write_shards(val_pdf, store, store.val_data_path(run_id),
                      num_shards)
    # Digest written LAST: a partial materialization can never pass as
    # cached on the next fit.
    store.write_bytes(digest_path,
                      f"{digest}\n{len(pdf)}\n".encode())
    return len(pdf)


def _keras_ckpt_encode(weights, opt_vars, history) -> bytes:
    """Pickle-free epoch-checkpoint codec: weight/slot arrays in an npz
    archive, history and counts as a JSON blob riding a uint8 array.
    The store is attacker-writable territory (the trust model
    ``TorchModel.load`` already assumes) — loading one of these must
    never be able to execute embedded code."""
    import io
    import json

    arrays = {f"w{i}": np.asarray(a) for i, a in enumerate(weights)}
    n_opt = -1
    if opt_vars is not None:
        opt_vars = list(opt_vars)
        n_opt = len(opt_vars)
        arrays.update({f"o{i}": np.asarray(a)
                       for i, a in enumerate(opt_vars)})
    meta = {"n_weights": len(weights), "n_opt": n_opt,
            "history": {str(k): [float(x) for x in v]
                        for k, v in (history or {}).items()}}
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _keras_ckpt_decode(payload: bytes) -> Dict[str, Any]:
    """Inverse of :func:`_keras_ckpt_encode`; ``allow_pickle=False`` is
    the point — a poisoned checkpoint fails to parse instead of running."""
    import io
    import json

    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        meta = json.loads(z["meta"].tobytes().decode("utf-8"))
        weights = [z[f"w{i}"] for i in range(meta["n_weights"])]
        opt_vars = None if meta["n_opt"] < 0 else \
            [z[f"o{i}"] for i in range(meta["n_opt"])]
    return {"weights": weights, "opt_vars": opt_vars,
            "history": meta["history"]}


def _restore_optimizer_slots(variables, saved) -> bool:
    """Positionally restore optimizer slot values after validating count
    and shapes.  A checkpoint from a different model/optimizer config
    must not be zipped in silently (short zip = partial restore); warn
    and keep fresh optimizer state instead.  Returns True on restore."""
    import warnings

    saved = list(saved)
    if len(variables) != len(saved):
        warnings.warn(
            f"optimizer checkpoint has {len(saved)} slot variables but "
            f"the model expects {len(variables)}; ignoring saved "
            "optimizer state (fresh slots)")
        return False
    for var, val in zip(variables, saved):
        if tuple(var.shape) != tuple(np.shape(val)):
            warnings.warn(
                f"optimizer slot {var.name if hasattr(var, 'name') else var} "
                f"shape {tuple(var.shape)} does not match checkpoint "
                f"value shape {tuple(np.shape(val))}; ignoring saved "
                "optimizer state (fresh slots)")
            return False
    for var, val in zip(variables, saved):
        var.assign(val)
    return True


def columns_to_matrix(pdf, cols: Sequence[str]) -> np.ndarray:
    """Dense float32 matrix from DataFrame columns.  Columns holding
    vectors (lists/arrays) are stacked; scalars become width-1 features,
    matching the reference's flattening of Spark vector columns."""
    if len(pdf) == 0:
        # An empty frame cannot reveal vector-column widths; the caller
        # would get a wrong-shaped matrix and fail later, possibly on
        # only some ranks of a collective.
        raise ValueError("cannot build a feature matrix from an empty "
                         "shard")
    parts = []
    for c in cols:
        col = pdf[c].to_numpy()
        if len(col) and isinstance(col[0], (list, np.ndarray)):
            parts.append(np.stack([np.asarray(v) for v in col]))
        else:
            parts.append(col.reshape(-1, 1))
    return np.concatenate(parts, axis=1).astype(np.float32)


def read_shard(store: Store, run_id: str, rank: int, size: int,
               feature_cols: Sequence[str], label_cols: Sequence[str],
               val: bool = False):
    """Load this rank's shard(s) back as dense float32 arrays."""
    import pyarrow.parquet as pq

    paths = store.shard_paths(run_id, val=val)
    mine = paths[rank::size] if len(paths) != size else [paths[rank]]
    if not mine:
        raise ValueError(
            f"rank {rank}: no {'validation' if val else 'training'} "
            f"shard — {len(paths)} shard(s) were "
            f"materialized but the job has {size} ranks; set the "
            f"estimator's num_proc to the actual world size")

    frames = []
    for p in mine:
        with store.open(p, "rb") as f:
            frames.append(pq.read_table(f).to_pandas())
    import pandas as pd

    pdf = pd.concat(frames) if len(frames) > 1 else frames[0]
    return columns_to_matrix(pdf, feature_cols), \
        columns_to_matrix(pdf, label_cols)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class LocalBackend:
    """Launcher-backed execution (programmatic run-func) — the default in
    environments without a Spark session.  ``device``: each rank's (the
    card, ``cuda:<local_rank>``, when None)."""

    def __init__(self, num_proc: int, device=None):
        self.num_proc = num_proc
        self.device = device

    def run(self, fn: Callable) -> List[Any]:
        from horovod_tpu_torch.runner.run import run as run_func

        return run_func(fn, np=self.num_proc, device=self.device)


class SparkBackend:
    """Barrier-mode execution via ``horovod_tpu_torch.spark.run`` (parity:
    spark/common/backend.py SparkBackend)."""

    def __init__(self, num_proc: Optional[int] = None, device=None):
        self.num_proc = num_proc
        self.device = device

    def run(self, fn: Callable) -> List[Any]:
        from horovod_tpu_torch.spark import run as spark_run

        return spark_run(fn, num_proc=self.num_proc, device=self.device)


def default_backend(num_proc: int, device=None):
    try:
        from pyspark.sql import SparkSession

        if SparkSession.getActiveSession() is not None:
            return SparkBackend(num_proc, device)
    except Exception:
        pass
    return LocalBackend(num_proc, device)


# ---------------------------------------------------------------------------
# base estimator
# ---------------------------------------------------------------------------


class HorovodEstimator:
    """Shared fit() skeleton (parity: spark/common/estimator.py:27):
    materialize → distributed train fn → collect rank-0 artifacts →
    return a fitted model wrapper."""

    def __init__(self, *, feature_cols=("features",), label_cols=("label",),
                 batch_size=32, epochs=1, num_proc=2, store=None,
                 backend=None, run_id=None, verbose=1, seed=1234,
                 resume=True, validation=None, device=None):
        """``resume=True`` (default, matching the reference's
        torch/remote.py contract): a fit whose ``run_id`` already has
        epoch checkpoints in the store continues from the newest one.
        ``resume=False`` deletes the run's directory first so the fit
        is clean even under a reused ``run_id``.

        ``validation`` (parity: common/params.py:52): float fraction in
        (0, 1) or an indicator column name; held-out rows are scored
        each epoch with the cross-rank-averaged validation loss.  Keras
        reports it as ``fitted.history["val_loss"]``; torch as the
        ``fitted.val_history`` list (``fitted.history`` stays the flat
        train-loss list), aligned by epoch (``None`` for epochs that
        ran before validation was enabled).

        ``device``: the ranks' device, for the default backend (the card,
        ``cuda:<local_rank>``, when None); a ``backend`` passed in names
        its own."""
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.num_proc = num_proc
        self.store = store or Store.create(
            os.path.join(os.getcwd(), ".horovod_tpu_store"))
        self.backend = backend
        self.run_id = run_id
        self.verbose = verbose
        self.seed = seed
        self.resume = resume
        self.validation = validation
        self.device = device

    def _fit(self, df, train_fn_builder) -> Dict[str, Any]:
        run_id = self.run_id or f"run-{uuid.uuid4().hex[:8]}"
        self._last_run_id = run_id
        if not self.resume:
            self.store.delete(self.store.run_path(run_id))
        materialize(df, self.store, run_id, self.num_proc,
                    validation=self.validation, seed=self.seed)
        backend = self.backend or default_backend(self.num_proc,
                                                  self.device)
        results = backend.run(train_fn_builder(run_id))
        arts = next(r for r in results if r is not None)
        return arts


# ---------------------------------------------------------------------------
# torch
# ---------------------------------------------------------------------------


class TorchEstimator(HorovodEstimator):
    """Parity: ``horovod/spark/torch/estimator.py`` + ``torch/remote.py``.

    ``model``: a ``torch.nn.Module``; ``optimizer``: an instance (rebuilt
    per worker from its class + defaults, like the reference's optimizer
    serialization) or a factory ``params -> Optimizer``; ``loss``: a
    callable ``(pred, target) -> scalar tensor``.
    """

    def __init__(self, model, optimizer=None, loss=None,
                 classification=None, metrics=(), **kw):
        """``classification``: force (True/False) the index-target
        coercion for single-column labels; default None auto-detects
        CrossEntropyLoss/NLLLoss instances — pass True for functional
        or custom index-target losses.

        ``metrics`` (parity: common/params.py:32 + torch/remote.py
        metric aggregation): callables ``(pred, target) -> scalar
        tensor``, evaluated per epoch on train and validation data and
        cross-rank averaged; results land in the fitted model's
        ``metrics_history[name]`` / ``val_metrics_history[name]``
        (``name`` = the callable's ``__name__``)."""
        super().__init__(**kw)
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.classification = classification
        self.metrics = list(metrics)

    def fit(self, df) -> "TorchModel":
        import torch

        model = self.model
        loss_fn = self.loss or torch.nn.MSELoss()
        opt = self.optimizer
        if opt is None:
            opt_builder = lambda ps: torch.optim.SGD(ps, lr=0.01)  # noqa: E731
        elif callable(opt) and not isinstance(opt, torch.optim.Optimizer):
            opt_builder = opt
        else:
            opt_cls, opt_defaults = opt.__class__, dict(opt.defaults)
            opt_builder = lambda ps: opt_cls(ps, **opt_defaults)  # noqa: E731
        store, feature_cols, label_cols = (
            self.store, self.feature_cols, self.label_cols)
        batch_size, epochs, seed = self.batch_size, self.epochs, self.seed
        classification = self.classification
        has_validation = self.validation is not None
        metric_fns = list(self.metrics)
        metric_names = []
        for i, m in enumerate(metric_fns):
            base = getattr(m, "__name__", "") or f"metric{i}"
            name = base
            k = 2
            while name in metric_names:  # two lambdas must not merge
                name = f"{base}_{k}"
                k += 1
            metric_names.append(name)

        def build(run_id):
            def _train():
                import torch

                import horovod_tpu_torch.torch as hvd
                from horovod_tpu_torch import basics

                dev = basics.device()
                rank, size = hvd.rank(), hvd.size()
                X, y = read_shard(store, run_id, rank, size,
                                  feature_cols, label_cols)
                Xv = yv = None
                if has_validation:
                    Xv, yv = read_shard(store, run_id, rank, size,
                                        feature_cols, label_cols,
                                        val=True)
                # Classification losses take 1-D class indices; the
                # parquet shards carry labels as float32 matrices
                # (parity: the reference feeds NLLLoss int targets in
                # examples/pytorch_spark_mnist.py).  Only single-column
                # labels coerce — multi-column targets (one-hot / soft
                # labels) stay (B, C) float for CE's soft-target mode.
                classify = classification if classification is not None \
                    else isinstance(loss_fn, (torch.nn.CrossEntropyLoss,
                                              torch.nn.NLLLoss))
                classify = classify and y.shape[1] == 1
                local = copy.deepcopy(model).to(dev)
                dist_opt = hvd.DistributedOptimizer(
                    opt_builder(local.parameters()),
                    named_parameters=local.named_parameters())
                # Resume: the newest epoch checkpoint in the run's store
                # directory restores model + optimizer + history, and
                # training continues from the following epoch (parity:
                # torch/remote.py loads the store checkpoint before the
                # epoch loop).  Rank 0 reads; broadcast aligns everyone.
                import io as _io

                def _pad(seq, upto):
                    # History lists always index by epoch; epochs that
                    # ran before a knob was enabled read as None.
                    return [None] * (upto - len(seq)) + list(seq)

                start_epoch = 0
                history = []
                val_history = []
                metrics_history = {n: [] for n in metric_names}
                val_metrics_history = {n: [] for n in metric_names}
                ck = store.latest_checkpoint(run_id) if rank == 0 else None
                flag = hvd.broadcast_object(
                    ck[0] if ck else None, root_rank=0,
                    name="est.resume.epoch")
                if flag is not None:
                    if rank == 0:
                        # weights_only: the store is writable by anyone
                        # with filesystem access (same trust model as
                        # TorchModel.load) — never unpickle arbitrary
                        # objects from it.  The checkpoint holds only
                        # tensors and plain containers, all on the
                        # weights_only allowlist.
                        st = torch.load(_io.BytesIO(ck[1]),
                                        map_location="cpu",
                                        weights_only=True)
                        local.load_state_dict(st["model"])
                        dist_opt.load_state_dict(st["optimizer"])
                        history = list(st.get("history", []))
                        val_history = list(st.get("val_history", []))
                        # Only metrics still configured survive resume;
                        # stale keys would stop indexing by epoch.
                        for n in metric_names:
                            if n in st.get("metrics_history", {}):
                                metrics_history[n] = list(
                                    st["metrics_history"][n])
                            if n in st.get("val_metrics_history", {}):
                                val_metrics_history[n] = list(
                                    st["val_metrics_history"][n])
                    start_epoch = int(flag) + 1
                    (history, val_history, metrics_history,
                     val_metrics_history) = hvd.broadcast_object(
                        (history, val_history, metrics_history,
                         val_metrics_history), root_rank=0,
                        name="est.resume.hist")
                    if Xv is not None:
                        val_history = _pad(val_history, start_epoch)
                    for n in metric_names:
                        metrics_history[n] = _pad(
                            metrics_history.get(n, []), start_epoch)
                        if Xv is not None:
                            val_metrics_history[n] = _pad(
                                val_metrics_history.get(n, []),
                                start_epoch)

                def _eval_split(Xa, ya, tag, epoch, named_fns):
                    """Cross-rank-averaged values of ``(name, fn)``
                    pairs over a split: one forward per batch shared by
                    every fn, eval mode, a single sum+count allreduce."""
                    names = [n for n, _ in named_fns]
                    sums = {n: 0.0 for n in names}
                    count = 0
                    local.eval()
                    with torch.no_grad():
                        for i in range(0, len(Xa), batch_size):
                            xb = torch.from_numpy(
                                Xa[i:i + batch_size]).to(dev)
                            yb = torch.from_numpy(
                                ya[i:i + batch_size]).to(dev)
                            if classify:
                                yb = yb.reshape(-1).long()
                            pred = local(xb)
                            for n, fn in named_fns:
                                sums[n] += float(fn(pred, yb)) * len(xb)
                            count += len(xb)
                    local.train()
                    flat = [sums[n] for n in names] + [float(count)]
                    agg = hvd.allreduce(
                        torch.tensor(flat, dtype=torch.float64),
                        op=hvd.Sum, name=f"est.metrics.{tag}.{epoch}")
                    total = max(float(agg[-1]), 1.0)
                    return {n: float(agg[i]) / total
                            for i, n in enumerate(names)}
                # Optimizer state FIRST: on a fresh optimizer its
                # broadcast initializes state via a root-only zero-grad
                # step, which can move root's params (e.g. AdamW's
                # decoupled decay) — the parameter broadcast after it
                # re-syncs every replica.
                hvd.broadcast_optimizer_state(dist_opt, root_rank=0)
                hvd.broadcast_parameters(local.state_dict(), root_rank=0)
                for _epoch in range(start_epoch, epochs):
                    # Permutation keyed by (seed, rank, epoch) so a
                    # resumed epoch E shuffles exactly like epoch E of
                    # an uninterrupted run.
                    perm = np.random.RandomState(
                        [seed, rank, _epoch]).permutation(len(X))
                    total, nb = 0.0, 0
                    for i in range(0, len(X), batch_size):
                        idx = perm[i:i + batch_size]
                        xb = torch.from_numpy(X[idx]).to(dev)
                        yb = torch.from_numpy(y[idx]).to(dev)
                        if classify:
                            yb = yb.reshape(-1).long()
                        dist_opt.zero_grad()
                        out = local(xb)
                        l = loss_fn(out, yb)
                        l.backward()
                        dist_opt.step()
                        total += float(l.detach())
                        nb += 1
                    avg = float(hvd.allreduce(
                        torch.tensor([total / max(nb, 1)]),
                        op=hvd.Average, name=f"est.loss.{_epoch}")[0])
                    history.append(avg)
                    metric_pairs = list(zip(metric_names, metric_fns))
                    if Xv is not None:
                        # One eval pass over the validation shard covers
                        # the loss AND every metric (shared forwards;
                        # eval mode = frozen BN stats, no dropout;
                        # batched so peak memory matches training;
                        # sum+count allreduce = exact mean under uneven
                        # per-rank rows).
                        v = _eval_split(Xv, yv, "v", _epoch,
                                        [("__loss__", loss_fn)]
                                        + metric_pairs)
                        val_history.append(v["__loss__"])
                        for n in metric_names:
                            val_metrics_history[n].append(v[n])
                    if metric_pairs:
                        tr_m = _eval_split(X, y, "t", _epoch,
                                           metric_pairs)
                        for n in metric_names:
                            metrics_history[n].append(tr_m[n])
                    if rank == 0:
                        buf = _io.BytesIO()
                        torch.save(
                            {"model": local.state_dict(),
                             "optimizer": dist_opt.state_dict(),
                             "history": history,
                             "val_history": val_history,
                             "metrics_history": metrics_history,
                             "val_metrics_history": val_metrics_history},
                            buf)
                        store.save_checkpoint(run_id, _epoch,
                                              buf.getvalue())
                if rank == 0:
                    buf = _io.BytesIO()
                    torch.save(local.state_dict(), buf)
                    store.write_bytes(store.checkpoint_path(run_id)
                                      + ".pt", buf.getvalue())
                    return {"state_dict": {
                        k: v.detach().cpu().numpy()
                        for k, v in local.state_dict().items()},
                        "history": history,
                        "val_history": val_history,
                        "metrics_history": metrics_history,
                        "val_metrics_history": val_metrics_history}
                return None

            return _train

        arts = self._fit(df, build)
        fitted = copy.deepcopy(model)
        fitted.load_state_dict(
            {k: __import__("torch").from_numpy(np.asarray(v))
             for k, v in arts["state_dict"].items()})
        return TorchModel(
            fitted, self.feature_cols, self.label_cols,
            history=arts["history"], run_id=self._last_run_id,
            val_history=arts.get("val_history"),
            metrics_history=arts.get("metrics_history"),
            val_metrics_history=arts.get("val_metrics_history"))


class _FittedModel:
    """Shared fitted-model surface (parity role: the Spark Transformer
    returned by estimator.fit — pandas in/out instead of Spark
    DataFrames)."""

    def __init__(self, model, feature_cols, label_cols, history=None,
                 run_id=None, val_history=None, metrics_history=None,
                 val_metrics_history=None):
        self._model = model
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.history = history
        self.run_id = run_id
        self.val_history = list(val_history or [])
        self.metrics_history = dict(metrics_history or {})
        self.val_metrics_history = dict(val_metrics_history or {})

    def getModel(self):
        return self._model

    def transform(self, df):
        pdf = _to_pandas(df).copy()
        pred = self.predict(columns_to_matrix(pdf, self.feature_cols))
        for j, c in enumerate(self.label_cols):
            pdf[f"{c}__output"] = list(pred[:, j] if pred.ndim > 1
                                       else pred)
        return pdf


class TorchModel(_FittedModel):
    def predict(self, X: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            return self._model(
                torch.from_numpy(np.asarray(X, np.float32))).numpy()

    @classmethod
    def load(cls, store, run_id: str, model,
             feature_cols=("features",), label_cols=("label",)
             ) -> "TorchModel":
        """Rebuild a fitted model from the store's final artifact
        (parity: the reference estimator's model-back-from-store
        serialization, spark/torch/estimator.py).  ``model``: a module
        with the fitted architecture; its state is loaded from
        ``<run_path>/checkpoint.pt``."""
        import copy as _copy
        import io as _io

        import torch

        payload = store.read_bytes(store.checkpoint_path(run_id) + ".pt")
        fitted = _copy.deepcopy(model)
        # weights_only: the artifact is a plain tensor state_dict, and
        # a remote store is attacker-writable territory — full pickle
        # would mean arbitrary code execution on load.
        fitted.load_state_dict(
            torch.load(_io.BytesIO(payload), map_location="cpu",
                       weights_only=True))
        return cls(fitted, feature_cols, label_cols, run_id=run_id)


# ---------------------------------------------------------------------------
# keras
# ---------------------------------------------------------------------------


def _alias_registered_names(model_json: str, custom_objects):
    """Extend a plain-name custom_objects mapping with the
    ``package>Name`` registered-name keys keras 3 actually looks up.

    Workers receive custom classes by cloudpickle, which does not
    re-run ``@register_keras_serializable`` — their registry is empty
    and ``deserialize_keras_object`` resolves classes by
    ``registered_name``.  The architecture JSON carries both names, so
    the alias map is derivable without asking the user for keras-3
    registry syntax."""
    if not custom_objects:
        return {}
    import json as _json

    out = dict(custom_objects)

    def walk(node):
        if isinstance(node, dict):
            rn, cn = node.get("registered_name"), node.get("class_name")
            if rn and cn and cn in custom_objects:
                out[rn] = custom_objects[cn]
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(_json.loads(model_json))
    return out


class KerasEstimator(HorovodEstimator):
    """Parity: ``horovod/spark/keras/estimator.py`` — the model travels as
    architecture JSON + weights (the reference serializes the compiled
    model the same way, keras/util.py), the optimizer as its keras config.
    """

    def __init__(self, model, optimizer=None, loss="mse", metrics=(),
                 custom_objects=None, **kw):
        """``custom_objects``: name → class/function mapping consulted
        when the architecture JSON is rebuilt on the workers and the
        driver (parity: keras/estimator.py custom_objects param)."""
        super().__init__(**kw)
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = list(metrics)
        self.custom_objects = custom_objects

    def fit(self, df) -> "KerasModel":
        import keras

        model_json = self.model.to_json()
        weights = self.model.get_weights()
        opt_cfg = keras.optimizers.serialize(
            self.optimizer or keras.optimizers.SGD(learning_rate=0.01))
        loss, metrics = self.loss, self.metrics
        custom_objects = self.custom_objects
        has_validation = self.validation is not None
        store, feature_cols, label_cols = (
            self.store, self.feature_cols, self.label_cols)
        batch_size, epochs = self.batch_size, self.epochs

        def build(run_id):
            def _train():
                import keras

                import horovod_tpu_torch.keras as hvd_keras
                import horovod_tpu_torch.tensorflow as hvd

                rank, size = hvd.rank(), hvd.size()
                X, y = read_shard(store, run_id, rank, size,
                                  feature_cols, label_cols)
                val_data = None
                if has_validation:
                    Xv, yv = read_shard(store, run_id, rank, size,
                                        feature_cols, label_cols,
                                        val=True)
                    val_data = (Xv, yv)
                # custom_object_scope with registered-name aliases, not
                # the model_from_json kwarg: keras 3 resolves classes
                # by 'package>Name' and drops the kwarg's mapping in
                # nested from_config calls.
                with keras.saving.custom_object_scope(
                        _alias_registered_names(model_json,
                                                custom_objects)):
                    local = keras.models.model_from_json(model_json)
                local.set_weights(weights)
                opt = hvd_keras.DistributedOptimizer(
                    keras.optimizers.deserialize(copy.deepcopy(opt_cfg)))
                local.compile(optimizer=opt, loss=loss, metrics=metrics,
                              run_eagerly=True)
                # Resume from the newest epoch checkpoint in the store
                # (weights + history; parity: keras/estimator.py resumes
                # from store checkpoints between fit() invocations).
                start_epoch = 0
                prev_hist: Dict[str, List[float]] = {}
                ck = store.latest_checkpoint(run_id) if rank == 0 else None
                resume = hvd.broadcast_object(
                    None if ck is None else
                    {"epoch": ck[0],
                     **_keras_ckpt_decode(ck[1])}, root_rank=0,
                    name="est.keras.resume")
                if resume is not None:
                    local.set_weights(resume["weights"])
                    prev_hist = resume.get("history", {})
                    start_epoch = resume["epoch"] + 1
                    # Restore optimizer slots + iteration counter so the
                    # resumed dynamics (Adam moments, LR schedules)
                    # continue instead of restarting (the torch path
                    # restores dist_opt.state_dict() the same way).
                    # Count/shape-validated: a checkpoint from another
                    # model config falls back to fresh slots with a
                    # warning instead of a silent partial restore.
                    if resume.get("opt_vars") is not None:
                        local.optimizer.build(local.trainable_variables)
                        _restore_optimizer_slots(
                            local.optimizer.variables, resume["opt_vars"])

                class _EpochCheckpoint(keras.callbacks.Callback):
                    """Rank 0 writes weights+history to the store after
                    every epoch (reference: ckpt_callback in
                    keras/estimator.py writing to get_checkpoint_path)."""

                    def __init__(self, running_hist):
                        super().__init__()
                        self._hist = running_hist

                    def on_epoch_end(self, epoch, logs=None):
                        for k, v in (logs or {}).items():
                            self._hist.setdefault(k, []).append(float(v))
                        if rank == 0:
                            store.save_checkpoint(
                                run_id, start_epoch + epoch,
                                _keras_ckpt_encode(
                                    self.model.get_weights(),
                                    [np.asarray(v) for v in
                                     self.model.optimizer.variables],
                                    self._hist))

                running_hist = {k: list(v) for k, v in prev_hist.items()}
                if start_epoch < epochs:
                    local.fit(
                        X, y, batch_size=batch_size,
                        epochs=epochs - start_epoch, verbose=0,
                        validation_data=val_data,
                        callbacks=[
                            hvd_keras.callbacks
                            .BroadcastGlobalVariablesCallback(0),
                            hvd_keras.callbacks.MetricAverageCallback(),
                            _EpochCheckpoint(running_hist),
                        ])
                if rank == 0:
                    store.makedirs(store.run_path(run_id))
                    # .keras archives need a real file; serialize via a
                    # temp file, then place the bytes through the store
                    # so remote backends get the artifact too.
                    import tempfile

                    with tempfile.NamedTemporaryFile(
                            suffix=".keras", delete=False) as tf:
                        tmp_name = tf.name
                    try:
                        local.save(tmp_name)
                        with open(tmp_name, "rb") as f:
                            store.write_bytes(
                                store.checkpoint_path(run_id) + ".keras",
                                f.read())
                    finally:
                        os.unlink(tmp_name)
                    return {"weights": local.get_weights(),
                            "history": running_hist}
                return None

            return _train

        arts = self._fit(df, build)
        with keras.saving.custom_object_scope(
                _alias_registered_names(model_json, self.custom_objects)):
            fitted = keras.models.model_from_json(model_json)
        fitted.set_weights(arts["weights"])
        return KerasModel(fitted, self.feature_cols, self.label_cols,
                          history=arts["history"],
                          run_id=self._last_run_id)


class KerasModel(_FittedModel):
    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self._model.predict(
            np.asarray(X, np.float32), verbose=0))

    @classmethod
    def load(cls, store, run_id: str, custom_objects=None,
             feature_cols=("features",), label_cols=("label",)
             ) -> "KerasModel":
        """Rebuild a fitted model from the store's ``checkpoint.keras``
        archive (parity: keras/estimator.py:521 model-back-from-store +
        keras/__init__.py load_model).  Works against remote (fsspec)
        stores — the archive bytes are staged through a temp file
        because keras archives need a real filesystem path."""
        import tempfile

        import keras

        payload = store.read_bytes(
            store.checkpoint_path(run_id) + ".keras")
        tmp_name = None
        try:
            with tempfile.NamedTemporaryFile(suffix=".keras",
                                             delete=False) as tf:
                tmp_name = tf.name
                tf.write(payload)
            # compile=False: the archive's optimizer is the runtime
            # DistributedOptimizer wrapper, which only exists inside an
            # hvd worker; this loader serves inference/transform (for
            # retraining with the wrapped optimizer, use
            # horovod_tpu_torch.keras.load_model).
            with keras.saving.custom_object_scope(custom_objects or {}):
                fitted = keras.models.load_model(tmp_name,
                                                 compile=False)
        finally:
            if tmp_name is not None:
                os.unlink(tmp_name)
        return cls(fitted, feature_cols, label_cols, run_id=run_id)
