"""The port's input pipeline (``horovod_tpu_torch.data``) against the JAX
package's, on the CPU: the cases of ``tests/test_data.py``, with the
port's sampler giving the JAX ``ShardedSampler``'s indices exactly for the
same ``(seed, epoch, rank, size)``, and ``prefetch_to_device`` on the CPU
(``device="cpu"``; without a card and without ``device`` it raises)."""

import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.types import NoCudaDeviceError
from horovod_tpu_torch.data import (ArrayDataset, ShardedSampler, batches,
                                    prefetch_to_device)


@pytest.mark.parametrize("n,size,kw", [
    (103, 4, dict(shuffle=False)), (103, 4, dict(shuffle=False,
                                                 drop_last=True)),
    (50, 2, dict(seed=7)), (1000, 8, dict(seed=3)),
    (1000, 8, dict(seed=3, drop_last=True)), (7, 3, dict(seed=123456))])
def test_indices_are_the_jax_samplers(n, size, kw):
    from horovod_tpu.data import ShardedSampler as JaxSampler

    for rank in range(size):
        mine, theirs = ShardedSampler(n, rank, size, **kw), \
            JaxSampler(n, rank, size, **kw)
        for epoch in (0, 1, 5):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(mine) == list(theirs)
            assert len(mine) == len(theirs)


def test_shards_cover_and_are_disjoint():
    n, size = 103, 4
    shards = [list(ShardedSampler(n, r, size, shuffle=False))
              for r in range(size)]
    assert {len(s) for s in shards} == {26}
    flat = [i for s in shards for i in s]
    assert sorted(set(flat)) == list(range(n))
    assert len(flat) == 104  # one wrapped index


def test_drop_last_truncates():
    shards = [list(ShardedSampler(103, r, 4, shuffle=False,
                                  drop_last=True)) for r in range(4)]
    assert all(len(s) == 25 for s in shards)
    assert len({i for s in shards for i in s}) == 100


def test_epoch_reshuffle_is_deterministic_and_rank_consistent():
    s0, s1 = ShardedSampler(50, 0, 2, seed=7), ShardedSampler(50, 1, 2,
                                                              seed=7)
    a = list(s0)
    assert list(s0) == a
    s0.set_epoch(1)
    b = list(s0)
    assert a != b
    s1.set_epoch(1)
    assert sorted(b + list(s1)) == sorted(range(50))


def test_validation_errors():
    with pytest.raises(ValueError):
        ShardedSampler(10, 4, 4)
    with pytest.raises(ValueError):
        ShardedSampler(0, 0, 1)
    with pytest.raises(ValueError):
        ShardedSampler(3, 0, 8, drop_last=True)
    with pytest.raises(ValueError):
        ArrayDataset()
    with pytest.raises(ValueError, match="disagree"):
        ArrayDataset(np.zeros(3), np.zeros(4))


def test_batches_static_shapes():
    ds = ArrayDataset(np.arange(10, dtype=np.float32),
                      np.arange(10, dtype=np.int32) * 2)
    s = ShardedSampler(10, 0, 1, shuffle=False)
    got = list(batches(ds, s, batch_size=4))
    assert len(got) == 2
    x, y = got[0]
    assert x.shape == (4,) and y.shape == (4,)
    np.testing.assert_array_equal(y, x.astype(np.int32) * 2)
    got = list(batches(ds, s, batch_size=4, drop_remainder=False))
    assert len(got) == 3 and got[-1][0].shape == (2,)


def test_batches_match_the_jax_packages():
    from horovod_tpu.data import ArrayDataset as JaxDataset
    from horovod_tpu.data import ShardedSampler as JaxSampler
    from horovod_tpu.data import batches as jax_batches

    rs = np.random.RandomState(0)
    arrays = (rs.randn(37, 3).astype(np.float32), rs.randint(0, 9, 37))
    for rank in range(2):
        mine = list(batches(ArrayDataset(*arrays),
                            ShardedSampler(37, rank, 2, seed=1), 5,
                            drop_remainder=False))
        theirs = list(jax_batches(JaxDataset(*arrays),
                                  JaxSampler(37, rank, 2, seed=1), 5,
                                  drop_remainder=False))
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_prefetch_matches_plain_iteration():
    ds = ArrayDataset(np.random.RandomState(0).randn(32, 3)
                      .astype(np.float32), np.arange(32))
    plain = list(batches(ds, ShardedSampler(32, 0, 1, shuffle=False), 8))
    pre = list(prefetch_to_device(
        batches(ds, ShardedSampler(32, 0, 1, shuffle=False), 8),
        device="cpu"))
    assert len(plain) == len(pre) == 4
    for a, b in zip(plain, pre):
        assert isinstance(b, tuple) and all(
            isinstance(t, torch.Tensor) and t.device.type == "cpu"
            for t in b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v.numpy())


def test_prefetch_takes_dicts_and_tensors():
    batch = {"x": np.ones((2, 3), np.float32), "y": torch.arange(2)}
    (got,) = list(prefetch_to_device(iter([batch]), device="cpu"))
    assert torch.equal(got["x"], torch.ones(2, 3))
    assert torch.equal(got["y"], torch.arange(2))


def test_prefetch_early_exit_unblocks_producer():
    """Breaking out of the loop must not leak a blocked producer."""
    produced = []

    def reader():
        for i in range(100):
            produced.append(i)
            yield (np.full(2, i, np.float32),)

    it = prefetch_to_device(reader(), buffer_size=2, device="cpu")
    np.testing.assert_array_equal(next(it)[0].numpy(), [0.0, 0.0])
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline:
        if not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate()):
            break
        time.sleep(0.05)
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())
    assert len(produced) < 100


def test_prefetch_propagates_errors():
    def boom():
        yield (np.zeros(2, np.float32),)
        raise RuntimeError("reader failed")

    it = prefetch_to_device(boom(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="reader failed"):
        for _ in it:
            pass


def test_prefetch_raises_without_a_card(monkeypatch):
    """Without ``device`` it puts batches on the card, and without a card
    it raises when called, rather than hand over CPU tensors."""
    import horovod_tpu_torch as hvd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.shutdown()
    with pytest.raises(NoCudaDeviceError, match="prefetch_to_device"):
        prefetch_to_device(iter([]))
    with pytest.raises(ValueError, match="buffer_size"):
        prefetch_to_device(iter([]), buffer_size=0, device="cpu")


def test_from_parquet(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    import pyarrow as pa

    rs = np.random.RandomState(0)
    feats = rs.randn(10, 4).astype(np.float32)
    labels = rs.randint(0, 3, 10).astype(np.int64)
    for i, sl in enumerate((slice(0, 6), slice(6, 10))):
        pq.write_table(pa.table({"features": list(feats[sl]),
                                 "label": labels[sl]}),
                       tmp_path / f"part-{i:05d}.parquet")
    ds = ArrayDataset.from_parquet(str(tmp_path / "*.parquet"),
                                   columns=["features", "label"])
    assert len(ds) == 10
    x, y = ds.batch([0, 7])
    assert x.dtype == np.float32 and y.dtype == np.int64
    np.testing.assert_allclose(x, feats[[0, 7]], rtol=1e-6)
    np.testing.assert_array_equal(y, labels[[0, 7]])
    with pytest.raises(FileNotFoundError, match="matched no files"):
        ArrayDataset.from_parquet(str(tmp_path / "nope-*.parquet"),
                                  columns=["label"])


def test_end_to_end_sharded_training():
    """Two ranks' samplers (concatenated into the global batch, as the
    JAX package's test stands in for two ranks) feed the port's MNIST step
    through ``prefetch_to_device`` for ten epochs: each batch the step
    takes is the one the JAX package's pipeline builds, and the loss
    falls."""
    import horovod_tpu_torch as hvd
    from horovod_tpu.data import ArrayDataset as JaxDataset
    from horovod_tpu.data import ShardedSampler as JaxSampler
    from horovod_tpu.data import batches as jax_batches

    rs = np.random.RandomState(0)
    labels = rs.randint(0, 10, (64,)).astype(np.int64)
    images = (rs.rand(64, 28, 28, 1) * 0.1
              + labels[:, None, None, None] / 10.0).astype(np.float32)

    def global_batches(dataset, sampler, batcher, epoch):
        per_rank = []
        for r in range(2):
            smp = sampler(64, r, 2, seed=3)
            smp.set_epoch(epoch)
            per_rank.append(batcher(dataset, smp, batch_size=8))
        return (tuple(np.concatenate(p) for p in zip(b0, b1))
                for b0, b1 in zip(*per_rank))

    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        step, init = hvd.make_mnist_train_step(
            lambda ps: torch.optim.Adam(ps, lr=1e-2), device="cpu")
        state = init(0)
        losses = []
        for epoch in range(10):
            want = list(global_batches(JaxDataset(images, labels),
                                       JaxSampler, jax_batches, epoch))
            got = prefetch_to_device(global_batches(
                ArrayDataset(images, labels), ShardedSampler, batches,
                epoch), device="cpu")
            n = 0
            for (xb, yb), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(xb.numpy(), wx)
                np.testing.assert_array_equal(yb.numpy(), wy)
                state, loss = step(state, xb, yb)
                losses.append(float(loss))
                n += 1
            assert n == len(want) == 4
    finally:
        hvd.shutdown()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
