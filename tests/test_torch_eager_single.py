"""The port's eager API at size 1 (``SingleProcessEngine``) against the JAX
package's, in this process.

Both packages run the same calls on the same numpy inputs and must give
the same dtypes, shapes and bits; handles, ``poll`` and the auto-names
behave alike; torch tensors come back in their own dtype and on their own
device; and a multi-rank ``init`` without a rendezvous starts no engine,
so that an eager op raises an error naming the missing variables.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import eager as peager


@pytest.fixture(scope="module")
def both(monkeypatch_module):
    """The port and the JAX package, each initialized at size 1."""
    import horovod_tpu as jhvd

    for k in list(__import__("os").environ):
        if k.startswith("HVD_"):
            monkeypatch_module.delenv(k)
    hvd.shutdown()
    hvd.init(device="cpu")
    jhvd.init()
    try:
        yield hvd, jhvd
    finally:
        jhvd.shutdown()
        hvd.shutdown()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _canon(x):
    a = np.ascontiguousarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _inputs():
    import ml_dtypes

    rs = np.random.RandomState(5)
    x = rs.randn(3, 4).astype(np.float32)
    return {"float32": x, "float16": x.astype(np.float16),
            "bfloat16": x.astype(ml_dtypes.bfloat16),
            "float8_e4m3fn": x.astype(ml_dtypes.float8_e4m3fn),
            "int32": (x * 10).astype(np.int32),
            "float64": x.astype(np.float64)}


OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT", "ADASUM"]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "float8_e4m3fn", "int32", "float64"])
def test_allreduce_matches_jax(both, dtype):
    port, jax = both
    x = _inputs()[dtype]
    for op in OPS:
        for pre, post in ((1.0, 1.0), (2.0, 0.5), (3.0, 1.0)):
            p = port.allreduce(x, op=getattr(port.ReduceOp, op),
                               prescale_factor=pre, postscale_factor=post)
            j = jax.allreduce(x, op=getattr(jax.ReduceOp, op),
                              prescale_factor=pre, postscale_factor=post)
            assert _canon(p) == _canon(j), (dtype, op, pre, post)


def test_other_collectives_match_jax(both):
    port, jax = both
    ins = _inputs()
    for dtype, x in ins.items():
        for fn, kw in (("allgather", {}), ("broadcast", {"root_rank": 0}),
                       ("reducescatter", {"op": "SUM"}),
                       ("alltoall", {"splits": [3]})):
            args = dict(kw)
            if "op" in args:
                args_p = dict(args, op=port.ReduceOp.SUM)
                args_j = dict(args, op=jax.ReduceOp.SUM)
            else:
                args_p = args_j = args
            p = getattr(port, fn)(x, **args_p)
            j = getattr(jax, fn)(x, **args_j)
            if fn == "alltoall":
                assert list(p[1]) == list(j[1])
                p, j = p[0], j[0]
            assert _canon(p) == _canon(j), (fn, dtype)
    xs = [ins["float32"], ins["bfloat16"], ins["int32"]]
    for p, j in zip(port.grouped_allreduce(xs, op=port.Sum),
                    jax.grouped_allreduce(xs, op=jax.Sum)):
        assert _canon(p) == _canon(j)
    idx = np.array([3, 1, 3], np.int64)
    vals = ins["float32"]
    for p, j in zip(port.sparse_allreduce(vals, idx, op=port.Average),
                    jax.sparse_allreduce(vals, idx, op=jax.Average)):
        assert _canon(p) == _canon(j)
    obj = {"a": [1, 2.5], "b": "x"}
    assert port.broadcast_object(obj) == jax.broadcast_object(obj) == obj
    params = {"w": ins["float32"], "b": {"z": ins["int32"],
                                         "a": ins["bfloat16"]}}
    p = port.broadcast_parameters(params)
    j = jax.broadcast_parameters(params)
    for path in (("w",), ("b", "z"), ("b", "a")):
        pv, jv = p, j
        for k in path:
            pv, jv = pv[k], jv[k]
        assert _canon(pv) == _canon(jv)
    assert port.join() == jax.join() == 0
    assert port.barrier() is None and jax.barrier() is None


def test_handles_poll_and_auto_names(both):
    port, jax = both
    from horovod_tpu.ops import eager as jeager

    x = _inputs()["float32"]
    hp = port.allreduce_async(x, op=port.Sum)
    hj = jax.allreduce_async(x, op=jax.Sum)
    assert port.poll(hp) and jax.poll(hj)
    assert _canon(port.synchronize(hp)) == _canon(jax.synchronize(hj))
    with pytest.raises(ValueError, match="unknown handle"):
        port.poll(hp)
    # The same sequence of unnamed calls gives the same names.
    for kind in ("allreduce", "allgather", "broadcast_object"):
        assert peager._auto_name(kind, None) == \
            jeager._auto_name(kind, None)
    assert peager._auto_name("allreduce", "mine") == "mine"
    with pytest.raises(ValueError, match="supersedes"):
        port.allreduce(x, average=True, op=port.Sum)
    with pytest.raises(ValueError, match="out of range"):
        port.broadcast(x, root_rank=1)
    with pytest.raises(ValueError, match="one split per participant"):
        port.alltoall(x, splits=[1, 2])
    with pytest.raises(ValueError, match="scalar"):
        port.reducescatter(np.float32(1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64,
                                   torch.float8_e4m3fn, torch.float8_e5m2])
def test_torch_tensors_keep_dtype_and_device(both, dtype):
    """A torch tensor's result is a tensor of its dtype on its device,
    with the values the JAX package gives its numpy twin."""
    port, jax = both
    import ml_dtypes

    base = torch.tensor(np.random.RandomState(1).randn(2, 5) * 3)
    t = base.to(dtype)
    as_np = {torch.bfloat16: ml_dtypes.bfloat16,
             torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
             torch.float8_e5m2: ml_dtypes.float8_e5m2}
    if dtype in as_np:
        twin = t.view(torch.int16 if dtype == torch.bfloat16
                      else torch.uint8).numpy().view(as_np[dtype])
    else:
        twin = t.numpy()
    for fn in ("allreduce", "allgather", "broadcast"):
        p = getattr(port, fn)(t)
        j = getattr(jax, fn)(twin)
        assert isinstance(p, torch.Tensor)
        assert p.dtype == dtype and p.device == t.device
        assert torch.equal(p.float(), torch.from_numpy(
            np.asarray(j).astype(np.float32)))
    p = port.allreduce(t, op=port.Sum, postscale_factor=0.5)
    assert p.dtype == dtype and p.device == t.device
    with pytest.raises(ValueError, match="do not support|not support"):
        peager._to_numpy(torch.zeros(2, dtype=torch.complex64))


def test_compression_at_size_one_matches_jax(both):
    port, jax = both
    x = _inputs()["float32"]
    for name in ("none", "fp16", "float16", "fp8", "fp8_e5m2"):
        p = port.allreduce(x, op=port.Sum,
                           compression=getattr(port.Compression, name))
        j = jax.allreduce(x, op=jax.Sum,
                          compression=getattr(jax.Compression, name))
        assert _canon(p) == _canon(j), name


def test_queries():
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        assert hvd.is_homogeneous()
        assert hvd.cache_stats() == {"hits": 0, "misses": 0,
                                     "evictions": 0, "size": 0,
                                     "capacity": 0}
        assert hvd.nccl_built() == torch.distributed.is_nccl_available()
        assert hvd.gloo_built()
        assert hvd.cuda_built() == (torch.version.cuda is not None)
        assert not hvd.xla_built() and not hvd.mpi_enabled()
    finally:
        hvd.shutdown()


def test_multi_rank_init_without_rendezvous_starts_no_engine(monkeypatch):
    for k in list(__import__("os").environ):
        if k.startswith("HVD_"):
            monkeypatch.delenv(k)
    hvd.shutdown()
    hvd.init(rank=0, size=2, device="cpu", backend="none")
    try:
        assert basics._engine_obj is None
        with pytest.raises(basics.EngineUnavailableError,
                           match="HVD_RENDEZVOUS_ADDR and "
                                 "HVD_RENDEZVOUS_PORT"):
            hvd.allreduce(torch.ones(2))
        with pytest.raises(basics.EngineUnavailableError):
            hvd.broadcast_parameters({"w": torch.ones(2)})
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="init"):
        hvd.allreduce(torch.ones(2))
