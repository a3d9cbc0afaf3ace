"""Worker for the eager-engine gangs of ``tests/test_torch_engine.py``.

    python tests/torch_port_engine_worker.py <package> <cases> <out_dir>

``<package>`` is ``port`` (``horovod_tpu_torch``), ``port-nogroup`` (the
port with no torch process group: a port rank among JAX ranks, which have
none to join) or ``jax`` (the JAX package's ``PyEngine``; the caller sets
``HVD_TPU_CORE=py``).  The rank,
size and rendezvous come from ``HVD_*`` as the launcher sets them.  Every
case (comma-separated in ``<cases>``) runs on seeded inputs that are the
same bits in both packages, and the worker writes each result as
``(dtype name, shape, bytes)`` to ``<out_dir>/rank<r>.pkl``, with
``SCENARIO_OK <case>`` on stdout per case that ran, and the media of its
links, the fault plan's fired counts and its control tree to
``<out_dir>/rank<r>.links.json``
(the timeline, the ladder and the fault plan come from ``HVD_TIMELINE``,
``HVD_WIRE_CRC`` and ``HOROVOD_FAULT_PLAN`` as the caller sets them).  A
port rank passes
torch tensors (numpy for the integer cases, whose results the JAX package
returns in numpy's promoted type); a JAX rank passes numpy arrays
(``ml_dtypes`` for bfloat16 and fp8).  The port rank imports no JAX.
"""

import json
import os
import pickle
import sys
import traceback
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PKG, GROUP = sys.argv[1].partition("-")[::2]
if PKG == "jax":
    import ml_dtypes

    import horovod_tpu as hvd
    from horovod_tpu.process_sets import ProcessSet
    NARROW = {"bfloat16": ml_dtypes.bfloat16,
              "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
              "float8_e5m2": ml_dtypes.float8_e5m2}
else:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import floats
    from horovod_tpu_torch.common.types import DataType, dtype_to_torch
    from horovod_tpu_torch.process_sets import ProcessSet
    torch.set_num_threads(1)
    NARROW = {"bfloat16": DataType.BFLOAT16,
              "float8_e4m3fn": DataType.FLOAT8_E4M3,
              "float8_e5m2": DataType.FLOAT8_E5M2}

DTYPES = ["float32", "bfloat16", "float16", "int32", "float8_e4m3fn",
          "float8_e5m2"]
OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"]
SCALES = [(1.0, 1.0), (2.0, 0.5)]


def rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def values(key, shape, dtype, specials=True):
    """Seeded float32 values for ``dtype``: moderate normals, and for the
    floats a NaN of each sign, both infinities, and (fp8) values whose sum
    overflows."""
    r = rng(*key)
    if dtype == "int32":
        return r.integers(-20, 20, shape).astype(np.int32)
    x = (r.standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1)
    if specials and flat.size >= 8:
        flat[:4] = [np.nan, -np.nan, np.inf, -np.inf]
        flat[4:6] = [300.0, 40000.0]
    return x


def tensor(x32, dtype, as_numpy=False):
    """``x32`` (float32 or int32 numpy) in this package's input type."""
    if PKG == "jax":
        if dtype in NARROW:
            return x32.astype(NARROW[dtype])
        return x32.astype(dtype)
    if dtype in NARROW:
        bits = floats.from_f32(x32, NARROW[dtype])
        t = torch.from_numpy(bits.view(np.int16 if bits.itemsize == 2
                                       else np.uint8))
        return t.view(dtype_to_torch(NARROW[dtype]))
    arr = x32.astype(dtype)
    return arr if as_numpy else torch.from_numpy(arr)


def canon(x):
    """(dtype name, shape, bytes) of a result in either package."""
    if PKG == "port" and isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).split(".")[1]
        return (name, tuple(t.shape),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.ascontiguousarray(x)
    return (a.dtype.name, a.shape, a.tobytes())


RESULTS = {}


def record(case, key, x):
    RESULTS.setdefault(case, {})[key] = canon(x)


def case_allreduce(rank, size):
    for dtype in DTYPES:
        for op in OPS:
            for pre, post in SCALES:
                x = values(("ar", dtype, op, pre, rank), (5, 7), dtype)
                y = hvd.allreduce(tensor(x, dtype, dtype == "int32"),
                                  op=getattr(hvd.ReduceOp, op),
                                  prescale_factor=pre,
                                  postscale_factor=post,
                                  name=f"ar.{dtype}.{op}.{pre}")
                record("allreduce", (dtype, op, pre, post), y)
    # A compressor's wire type on fp32 input.
    for comp in ("fp16", "float16", "fp8", "fp8_e5m2"):
        x = values(("arc", comp, rank), (6, 5), "float32", specials=False)
        y = hvd.allreduce(tensor(x, "float32"), op=hvd.Sum, name=f"arc.{comp}",
                          compression=getattr(hvd.Compression, comp))
        record("allreduce", ("compressed", comp), y)


def case_fusion(rank, size):
    # Many small tensors at once; integer values, so that any grouping
    # gives the same bits.
    hs = [hvd.allreduce_async(
        tensor(np.full((64,), rank + i, np.float32), "float32"),
        name=f"fuse.{i}", op=hvd.Sum) for i in range(32)]
    hs += [hvd.allreduce_async(
        tensor(np.full((8,), rank + 1.0, np.float32), "float32"),
        name="mix.max", op=hvd.Max),
        hvd.allreduce_async(tensor(np.ones(8, np.float32), "float32"),
                            name="mix.scaled", op=hvd.Sum,
                            prescale_factor=3.0)]
    for i, h in enumerate(hs):
        record("fusion", i, hvd.synchronize(h))


def case_allgather(rank, size):
    for dtype in ("float32", "bfloat16", "int32"):
        x = values(("ag", dtype, rank), (rank + 1, 3), dtype)
        record("allgather", dtype,
               hvd.allgather(tensor(x, dtype, dtype == "int32"),
                             name=f"ag.{dtype}"))


def case_reducescatter(rank, size):
    for dtype, op in (("float32", "SUM"), ("float32", "AVERAGE"),
                      ("float32", "MIN"), ("bfloat16", "SUM"),
                      ("bfloat16", "AVERAGE"), ("int32", "SUM")):
        x = values(("rs", dtype, op, rank), (7, 3), dtype)
        y = hvd.reducescatter(tensor(x, dtype, dtype == "int32"),
                              op=getattr(hvd.ReduceOp, op),
                              name=f"rs.{dtype}.{op}")
        record("reducescatter", (dtype, op), y)


def case_sparse_allreduce(rank, size):
    v = values(("sp.v", rank), (rank + 2, 4), "float32", specials=False)
    idx = rng("sp.i", rank).integers(0, 10, rank + 2).astype(np.int64)
    iv = idx if PKG == "jax" else torch.from_numpy(idx)
    out_v, out_i = hvd.sparse_allreduce(tensor(v, "float32"), iv,
                                        op=hvd.Average, name="sp")
    record("sparse_allreduce", "values", out_v)
    record("sparse_allreduce", "indices", out_i)


def case_broadcast(rank, size):
    for dtype in ("float32", "bfloat16", "float8_e4m3fn", "int32"):
        x = values(("bc", dtype, rank), (4, 5), dtype)
        record("broadcast", dtype,
               hvd.broadcast(tensor(x, dtype, dtype == "int32"),
                             root_rank=size - 1, name=f"bc.{dtype}"))


def case_alltoall(rank, size):
    splits = [(rank + j) % 3 + 1 for j in range(size)]
    for dtype in ("float32", "bfloat16"):
        x = values(("a2a", dtype, rank), (sum(splits), 2), dtype)
        data, recv = hvd.alltoall(tensor(x, dtype), splits=splits,
                                  name=f"a2a.{dtype}")
        record("alltoall", dtype, data)
        record("alltoall", (dtype, "splits"),
               np.asarray([int(s) for s in recv], np.int64))


def case_process_sets(rank, size):
    sets = [ProcessSet([0, size - 1]), ProcessSet([size - 1])]
    record("process_sets", "member",
           np.asarray([ps.included() for ps in sets], np.bool_))
    for i, ps in enumerate(sets):
        if not ps.included():
            continue
        x = values(("ps", i, rank), (3, 4), "float32")
        record("process_sets", (i, "ar"),
               hvd.allreduce(tensor(x, "float32"), op=hvd.Sum,
                             name=f"ps{i}.ar", process_set=ps))
        record("process_sets", (i, "ag"),
               hvd.allgather(tensor(x[:rank + 1], "float32"),
                             name=f"ps{i}.ag", process_set=ps))
        record("process_sets", (i, "bc"),
               hvd.broadcast(tensor(x, "float32"), root_rank=ps.ranks[-1],
                             name=f"ps{i}.bc", process_set=ps))
        hvd.barrier(process_set=ps)


def case_broadcast_object(rank, size):
    obj = {"rank": rank, "msg": "hello" * (rank + 1), "vals": [1.5, rank]}
    got = hvd.broadcast_object(obj, root_rank=size - 1, name="obj")
    record("broadcast_object", "obj",
           np.frombuffer(pickle.dumps(got, protocol=4), np.uint8))


def case_broadcast_parameters(rank, size):
    params = {"b": values(("bp.b", rank), (3,), "float32"),
              "a": {"w": values(("bp.w", rank), (2, 3), "float32"),
                    "v": values(("bp.v", rank), (4,), "bfloat16")}}
    if PKG == "port":
        params = {"b": tensor(params["b"], "float32"),
                  "a": {"w": tensor(params["a"]["w"], "float32"),
                        "v": tensor(params["a"]["v"], "bfloat16")}}
    else:
        params["a"]["v"] = tensor(params["a"]["v"], "bfloat16")
    out = hvd.broadcast_parameters(params, root_rank=0)
    record("broadcast_parameters", "b", out["b"])
    record("broadcast_parameters", "w", out["a"]["w"])
    record("broadcast_parameters", "v", out["a"]["v"])


def case_join(rank, size):
    # Rank r allreduces r + 1 times, then joins: the joined ranks add
    # zeros to the others' allreduces.
    for i in range(rank + 1):
        y = hvd.allreduce(tensor(np.full((5,), rank + 1.0 + i, np.float32),
                                 "float32"), op=hvd.Sum, name=f"join.{i}")
        record("join", i, y)
    record("join", "last", np.asarray([hvd.join()], np.int64))


def case_barrier(rank, size):
    for _ in range(3):
        hvd.barrier()
    record("barrier", "done", np.zeros(1, np.int32))


def case_mismatch(rank, size):
    try:
        hvd.allreduce(tensor(np.ones(3 + rank, np.float32), "float32"),
                      op=hvd.Sum, name="bad.shape")
    except RuntimeError as e:
        assert "Mismatched" in str(e), e
        record("mismatch", "error",
               np.frombuffer(str(e).encode(), np.uint8))
    else:
        raise AssertionError("expected a shape-mismatch error")
    y = hvd.allreduce(tensor(np.ones(2, np.float32), "float32"),
                      op=hvd.Sum, name="good")
    record("mismatch", "after", y)


def case_cache(rank, size):
    before = hvd.cache_stats()
    for step in range(3):
        for i in range(4):
            x = values(("cache", i, rank), (16,), "float32", specials=False)
            y = hvd.allreduce(tensor(x, "float32"), op=hvd.Average,
                              name=f"cache.{i}")
            record("cache", (step, i), y)
    after = hvd.cache_stats()
    assert after["hits"] - before["hits"] >= 8, (before, after)
    record("cache", "stats", np.asarray(
        [after[k] - before.get(k, 0) for k in ("hits", "misses")], np.int64))


def case_adasum(rank, size):
    for dtype in ("float32", "float64"):
        x = values(("ada", dtype, rank), (33,), "float32", specials=False)
        t = x.astype(dtype) if PKG == "jax" else \
            torch.from_numpy(x.astype(dtype))
        record("adasum", dtype,
               hvd.allreduce(t, op=hvd.Adasum, name=f"ada.{dtype}"))


# A tensor name that a hand-written JSON emitter would break on.
HOSTILE = 'we"ird\\na\nme {}],\u00e9'


def case_timeline_ops(rank, size):
    """A few ops for the timeline, the hostile name among them; repeated,
    so that the cached path records too."""
    for step in range(2):
        for name in ("tl.a", HOSTILE):
            record("timeline_ops", (step, name), hvd.allreduce(
                tensor(np.arange(6, dtype=np.float32) + rank, "float32"),
                op=hvd.Sum, name=name))
        record("timeline_ops", (step, "ag"), hvd.allgather(
            tensor(np.ones((rank + 1, 2), np.float32), "float32"),
            name="tl.ag"))
        record("timeline_ops", (step, "bc"), hvd.broadcast(
            tensor(np.full(3, float(rank), np.float32), "float32"),
            root_rank=1, name="tl.bc"))
    hvd.barrier()


def case_instants(rank, size):
    """The integrity modules' timeline instants: a skipped step of the
    guard, a divergent audit, a checkpoint that fails verification."""
    import json as _json

    if PKG == "jax":
        from horovod_tpu.integrity.audit import audit_replicas
        from horovod_tpu.integrity.nonfinite import NonFiniteGuard
        from horovod_tpu.utils import checkpoint as ckpt
        grads = [np.array([1.0, np.nan if rank == 1 else 2.0], np.float32)]
        tree = {"w": np.full(3, float(rank == 1), np.float32)}
    else:
        from horovod_tpu_torch.integrity.audit import audit_replicas
        from horovod_tpu_torch.integrity.nonfinite import NonFiniteGuard
        from horovod_tpu_torch.utils import checkpoint as ckpt
        grads = [torch.tensor([1.0, float("nan") if rank == 1 else 2.0])]
        tree = {"w": np.full(3, float(rank == 1), np.float32)}
    _, skip = NonFiniteGuard(policy="skip").intercept(grads)
    record("instants", "skip", np.asarray([skip], np.bool_))
    try:
        audit_replicas(tree)
    except Exception as e:  # ReplicaDivergenceError in both packages
        record("instants", "diverged", np.frombuffer(
            type(e).__name__.encode(), np.uint8))
    if rank == 0:
        root = os.path.join(sys.argv[3], f"ckpt{rank}")
        step = os.path.join(root, "step_1")
        os.makedirs(step, exist_ok=True)
        with open(os.path.join(step, "data.bin"), "wb") as fh:
            fh.write(b"written")
        with open(ckpt.manifest_path(step), "w") as fh:
            _json.dump({"format": 1, "step": 1, "epoch": 0, "files": {
                "data.bin": {"sha256": "0" * 64, "bytes": 7}}}, fh)
        try:
            ckpt.restore_verified(root)
        except ckpt.CheckpointVerifyError:
            record("instants", "ckpt", np.ones(1, np.int32))


def _engine():
    if PKG == "jax":
        from horovod_tpu import basics as b
        return b._runtime
    from horovod_tpu_torch import basics as b
    return b._engine_obj


def _knobs(eng):
    return [float(eng.fusion_threshold), float(eng.cycle_time),
            float(bool(eng._cache_classify_enabled)),
            float(eng.ring_segment_bytes),
            float(bool(eng.hierarchical_allreduce)),
            float(bool(eng.hierarchical_allgather))]


def case_autotune(rank, size):
    """Steps of integer-valued fp32 allreduces (any fusion or segment gives
    the same bits) while rank 0's tuner (``HVD_AUTOTUNE``) runs; every step
    ends with a broadcast of rank 0's "settled" flag, so that the ranks stop
    at the same step, two steps after the tuner settled (its final knobs
    ride the frame after).  Records a CRC of every result, the step count,
    every rank's knobs and rank 0's settled knobs."""
    eng = _engine()
    crc, settled_at, step = 0, -1, 0
    for step in range(4000):
        hs = [hvd.allreduce_async(
            tensor(np.full((512 * (i + 1),), rank + step % 7 + i,
                           np.float32), "float32"),
            name=f"tune.{i}", op=hvd.Sum) for i in range(6)]
        for h in hs:
            crc = zlib.crc32(canon(hvd.synchronize(h))[2], crc)
        pm = getattr(eng, "_pm", None)
        flag = np.array([1 if pm is not None and pm.done else 0], np.int32)
        flag = np.asarray(hvd.broadcast(flag, 0, name="tune.settled"))
        if flag[0] and settled_at < 0:
            settled_at = step
        if settled_at >= 0 and step >= settled_at + 2:
            break
    record("autotune", "crc", np.array([crc, step, settled_at], np.int64))
    record("autotune", "knobs", np.array(_knobs(eng), np.float64))
    pm = getattr(eng, "_pm", None)
    if pm is not None:
        c = pm.current
        record("autotune", "final", np.array(
            [float(c.fusion_threshold), float(c.cycle_time_s),
             float(c.cache_enabled), float(c.ring_segment_bytes),
             float(c.hierarchical_allreduce),
             float(c.hierarchical_allgather), float(pm.done)], np.float64))


def case_metrics(rank, size):
    """A scripted workload for the telemetry gangs (``HVD_METRICS_FILE``):
    three steps of two allreduces (fp32, bf16), an allgather and a
    broadcast, under fixed names, so that the steps after the first hit
    the response cache."""
    for step in range(3):
        for i, dtype in enumerate(("float32", "bfloat16")):
            x = values(("m", step, i, rank), (32,), dtype, specials=False)
            record("metrics", (step, i), hvd.allreduce(
                tensor(x, dtype), op=hvd.Sum, name=f"m.ar.{i}"))
        x = values(("m.ag", step, rank), (4, 3), "float32", specials=False)
        record("metrics", (step, "ag"),
               hvd.allgather(tensor(x, "float32"), name="m.ag"))
        x = values(("m.bc", step, rank), (5,), "float32", specials=False)
        record("metrics", (step, "bc"),
               hvd.broadcast(tensor(x, "float32"), 0, name="m.bc"))


def case_gang_view(rank, size):
    """The metrics workload, then (``HVD_METRICS_PORT``, the flusher and
    rank 0's gang fold on, at short intervals) a barrier and a pause of
    several flushes and folds; each rank writes its own registry snapshot
    to ``<out_dir>/snap<r>.json``, rank 0 its ``/gang/metrics.json``,
    ``/gang/health`` and ``/gang/metrics`` to ``gang_view.json``, and a
    last barrier keeps every rank up until then."""
    import time
    import urllib.request

    case_metrics(rank, size)
    hvd.barrier()
    time.sleep(1.5)
    out_dir = sys.argv[3]
    with open(os.path.join(out_dir, f"snap{rank}.json"), "w") as f:
        json.dump(hvd.metrics_snapshot(), f)
    if rank == 0:
        base = f"http://127.0.0.1:{os.environ['HVD_METRICS_PORT']}"
        doc = {}
        for path in ("/gang/metrics.json", "/gang/health"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                doc[path] = json.loads(r.read().decode())
        with urllib.request.urlopen(base + "/gang/metrics",
                                    timeout=10) as r:
            doc["/gang/metrics"] = r.read().decode()
        with open(os.path.join(out_dir, "gang_view.json"), "w") as f:
            json.dump(doc, f)
    hvd.barrier()


CASES = {n[len("case_"):]: f for n, f in globals().items()
         if n.startswith("case_")}


def links():
    """This rank's link media by peer and its fault plan's fired counts."""
    if PKG == "jax":
        from horovod_tpu import basics as b
        from horovod_tpu.common import fault_injection as f
        eng = b._runtime
        media = {p: getattr(t, "_mode", t.kind)
                 for p, t in getattr(eng, "_transports", {}).items()}
    else:
        from horovod_tpu_torch import basics as b
        from horovod_tpu_torch.common import fault_injection as f
        eng = b._engine_obj
        media = eng.transport_media() if hasattr(eng, "transport_media") \
            else {}
    fired = [x.fired for x in f._PLAN.faults] if f._PLAN else []
    hier = [bool(getattr(eng, "hierarchical_allreduce", False)),
            bool(getattr(eng, "hierarchical_allgather", False)),
            bool(eng.hierarchical_topology_ok())
            if hasattr(eng, "hierarchical_topology_ok") else False]
    # The control tree this rank planned: (parent, children).
    tree = [getattr(eng, "_tree_parent", None),
            list(getattr(eng, "_tree_children", []))]
    return {"media": {str(p): m for p, m in media.items()}, "fired": fired,
            "hierarchical": hier, "tree": tree}


def main():
    names = sys.argv[2].split(",")
    out_dir = sys.argv[3]
    if PKG == "port":
        hvd.init(device="cpu", init_method=f"file://{out_dir}/store",
                 backend="none" if GROUP == "nogroup" else None)
    else:
        hvd.init()
    rank, size = hvd.rank(), hvd.size()
    failed = False
    for name in names:
        try:
            CASES[name](rank, size)
            print(f"SCENARIO_OK {name}", flush=True)
        except Exception:
            failed = True
            print(f"SCENARIO_FAIL {name}\n{traceback.format_exc()}",
                  flush=True)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(RESULTS, f)
    with open(os.path.join(out_dir, f"rank{rank}.links.json"), "w") as f:
        json.dump(links(), f)
    hvd.shutdown()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
