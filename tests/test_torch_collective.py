"""The port's collectives in a two-process gloo gang, against numpy, and its
compressors against the JAX package's.

The gang runs once per module (``gang`` fixture): each rank runs every
collective and writes what it got; the tests compare.  The worker imports
only torch and the port at module level; JAX is imported inside the tests.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.types import ReduceOp


def _spawn_gang(fn, nprocs, args, timeout=120.0):
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; kill them
    and fail if they have not all finished within ``timeout`` seconds."""
    ctx = mp.start_processes(fn, nprocs=nprocs, join=False,
                             start_method="spawn", args=args)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gang did not finish in {timeout:g}s")


SIZE = 2
OPS = [ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX,
       ReduceOp.PRODUCT]
SCALES = [(1.0, 1.0), (2.0, 0.5)]


def _rank_input(rank):
    rs = np.random.RandomState(100 + rank)
    return rs.uniform(-2.0, 2.0, (3, 5)).astype(np.float32)


def _leaves(rank):
    rs = np.random.RandomState(200 + rank)
    return [torch.tensor(rs.randn(3, 4).astype(np.float32)),
            torch.tensor(rs.randn(5).astype(np.float32)).to(torch.bfloat16),
            torch.tensor(rs.randn(2).astype(np.float32)),
            torch.tensor(rs.randint(-5, 5, (3,)), dtype=torch.int64)]


def _np(t):
    return (t.float() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                                     torch.float8_e5m2) else t).numpy()


def _collective_worker(rank, size, store, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        out = {}
        x = torch.tensor(_rank_input(rank))
        for op in OPS:
            for pre, post in SCALES:
                y = hvd.allreduce(x, op=op, prescale_factor=pre,
                                  postscale_factor=post)
                out[f"ar.{op.name}.{pre}.{post}"] = _np(y)
        out["ar.int.SUM"] = _np(hvd.allreduce(
            torch.arange(4, dtype=torch.int32) * (rank + 1), op=hvd.Sum))
        for wire in (torch.float8_e4m3fn, torch.float8_e5m2):
            out[f"ar.{wire}"] = _np(hvd.allreduce(x.to(wire), op=hvd.Sum))
        leaves = _leaves(rank)
        grouped = hvd.grouped_allreduce(leaves, op=hvd.Sum)
        for i, (g, leaf) in enumerate(zip(grouped, leaves)):
            assert g.dtype == leaf.dtype and g.shape == leaf.shape
            out[f"grouped.{i}"] = _np(g)
            out[f"single.{i}"] = _np(hvd.allreduce(leaf, op=hvd.Sum))
        out["bcast"] = _np(hvd.broadcast(x, root_rank=1))
        out["gather"] = _np(hvd.allgather(x))
        hvd.barrier()
        out["input"] = _np(x)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("collective_gang")
    _spawn_gang(_collective_worker, SIZE, (SIZE, str(d / "store"), str(d)))
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)]


def _numpy_allreduce(op, xs, pre, post):
    g = np.stack(xs) * pre
    y = {ReduceOp.AVERAGE: lambda: g.sum(0) / len(xs),
         ReduceOp.SUM: lambda: g.sum(0),
         ReduceOp.MIN: lambda: g.min(0),
         ReduceOp.MAX: lambda: g.max(0),
         ReduceOp.PRODUCT: lambda: g.prod(0)}[op]()
    return y * post


@pytest.mark.parametrize("pre,post", SCALES)
@pytest.mark.parametrize("op", OPS, ids=lambda o: o.name)
def test_allreduce_matches_numpy(gang, op, pre, post):
    xs = [_rank_input(r) for r in range(SIZE)]
    want = _numpy_allreduce(op, xs, pre, post)
    for out in gang:
        np.testing.assert_allclose(out[f"ar.{op.name}.{pre}.{post}"], want,
                                   rtol=1e-6, atol=1e-6)


def test_integer_sum(gang):
    for out in gang:
        np.testing.assert_array_equal(out["ar.int.SUM"],
                                      np.arange(4) * 3)


@pytest.mark.parametrize("wire", ["torch.float8_e4m3fn",
                                  "torch.float8_e5m2"])
def test_fp8_allreduce_sums_in_fp32(gang, wire):
    dt = getattr(torch, wire.split(".")[1])
    xs = [torch.tensor(_rank_input(r)).to(dt).float() for r in range(SIZE)]
    want = (xs[0] + xs[1]).to(dt).float().numpy()
    for out in gang:
        np.testing.assert_array_equal(out[f"ar.{wire}"], want)


def test_grouped_allreduce_equals_per_leaf(gang):
    for out in gang:
        for i in range(4):
            np.testing.assert_array_equal(out[f"grouped.{i}"],
                                          out[f"single.{i}"])
        sums = [_np(a + b) for a, b in zip(_leaves(0), _leaves(1))]
        for i, want in enumerate(sums):
            np.testing.assert_allclose(out[f"grouped.{i}"], want, rtol=1e-6,
                                       atol=1e-6)


def test_broadcast_and_allgather(gang):
    xs = [_rank_input(r) for r in range(SIZE)]
    for out in gang:
        np.testing.assert_array_equal(out["bcast"], xs[1])
        np.testing.assert_array_equal(out["gather"], np.concatenate(xs))


def test_adasum_raises_and_uninitialized_raises():
    x = torch.ones(2)
    hvd.shutdown()
    with pytest.raises(ValueError, match="init"):
        hvd.allreduce(x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hvd.allreduce(x, op=hvd.Adasum)


@pytest.mark.parametrize("name", ["none", "fp16", "float16", "bfloat16",
                                  "fp8", "fp8_e5m2"])
def test_compressor_round_trip_matches_jax(name):
    """compress → decompress bit-for-bit like the JAX package's
    Compression on the same values (within each wire type's range)."""
    import jax.numpy as jnp

    from horovod_tpu.ops.compression import Compression as JC

    rs = np.random.RandomState(9)
    vals = (rs.randn(257) * np.logspace(-3, 2, 257)).astype(np.float32)
    port = getattr(hvd.Compression, name)
    jc = getattr(JC, name)
    c, ctx = port.compress(torch.tensor(vals))
    jcv, jctx = jc.compress(jnp.asarray(vals))
    assert (ctx is None) == (jctx is None)
    if ctx is not None:
        assert str(c.dtype).split(".")[1] == str(jcv.dtype)
    back = port.decompress(c, ctx)
    jback = jc.decompress(jcv, jctx)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(jback).view(np.uint32))
    ints = torch.arange(5)
    assert port.compress(ints)[0] is ints
