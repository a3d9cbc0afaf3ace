"""The port's replica-divergence audit (``integrity/audit.py``) against the
JAX package's, on the CPU.

* Digests: the port's ``fingerprint`` over tensors gives, per leaf and
  folded, the JAX package's ``fingerprint`` over the same numpy leaves in
  the same tree (fp32, bf16, int32, a 0-d leaf, an empty leaf, nested
  dicts, lists and tuples, Python scalars).
* ``_verdict`` on the same gathered matrices as the JAX package's: a
  majority, a tie (to the lowest rank), every rank disagreeing.
* One three-process gloo gang: a clean round gives every rank the same
  folded digest; one bit flipped in rank 1's first leaf makes every rank
  raise ``ReplicaDivergenceError`` naming rank 1 and that leaf.
* ``ReplicaAuditor``'s pacing: ``step=``, ``HVD_AUDIT_INTERVAL``, 0 turning
  it off, a negative interval refused.
* The error types are the JAX package's: the same messages and attributes.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import types as ptypes
from horovod_tpu_torch.integrity import audit

from test_torch_train_tp import join_gang, start_gang


def _numpy_tree():
    rs = np.random.RandomState(0)
    return {
        "model": {"w": rs.randn(3, 4).astype(np.float32),
                  "b": rs.randn(5).astype(ml_dtypes.bfloat16),
                  "ids": rs.randint(0, 9, (2, 3)).astype(np.int32)},
        "scalar": np.asarray(np.float32(3.5)),
        "empty": np.zeros((0, 4), np.float32),
        "nested": [rs.randn(2).astype(np.float32),
                   (np.arange(4, dtype=np.int32), 0.001, 7)],
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        if tree.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(tree)
    return tree


def test_digests_equal_jax():
    from horovod_tpu.integrity import audit as jaudit

    tree = _numpy_tree()
    jfold, jleaves = jaudit.fingerprint(tree)
    fold, leaves = audit.fingerprint(_to_torch(tree))
    assert [d for _, d in leaves] == [d for _, d in jleaves]
    assert fold == jfold
    assert [p for p, _ in leaves] == [
        "empty", "model.b", "model.ids", "model.w", "nested.0", "nested.1.0",
        "nested.1.1", "nested.1.2", "scalar"]
    assert [p for p, _ in jleaves][1] == "['model']['b']"


def test_digest_sees_dtype_shape_and_one_bit():
    t = torch.arange(6, dtype=torch.float32)
    base = audit.fingerprint({"x": t})[0]
    assert audit.fingerprint({"x": t.to(torch.float64)})[0] != base
    assert audit.fingerprint({"x": t.view(2, 3)})[0] != base
    flipped = t.clone()
    flipped.view(torch.int32)[0] ^= 1
    assert audit.fingerprint({"x": flipped})[0] != base
    assert audit.fingerprint({"x": t.clone()})[0] == base


@pytest.mark.parametrize("col,deviants,canon", [
    ([7, 7, 9, 7], [2], 0),         # a majority
    ([9, 7, 7, 9], [1, 2], 0),      # a tie: the digest of the lowest rank
    ([5, 9, 9, 5, 3], [1, 2, 4], 0),
    ([4, 5, 6], [1, 2], 0),         # every rank disagrees
    ([8, 4, 4], [0], 1),
], ids=["majority", "tie", "tie-of-three", "all-differ", "rank0-deviant"])
def test_verdict_equals_jax(col, deviants, canon):
    from horovod_tpu.integrity import audit as jaudit

    mat = np.stack([np.asarray(col, np.uint64),
                    np.arange(len(col), dtype=np.uint64)], 1)
    assert audit._verdict(mat) == (deviants, canon)
    assert jaudit._verdict(mat) == (deviants, canon)


def _gang_tree(rank):
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(4, 4, generator=g),
            "b": torch.randn(6, generator=g).to(torch.bfloat16),
            "n": [torch.arange(5, dtype=torch.int32)]}


def _worker(rank, size, store, out_dir):
    torch.set_num_threads(1)
    hvd.init(rank=rank, size=size, device="cpu",
             init_method=f"file://{store}")
    try:
        tree = _gang_tree(rank)
        out = {"clean": f"{audit.audit_replicas(tree):016x}"}
        if rank == 1:  # one bit of the first leaf ("b", in sorted order)
            tree["b"].view(torch.int16)[0] ^= 1
        try:
            audit.audit_replicas(tree)
            out["raised"] = None
        except ptypes.ReplicaDivergenceError as e:
            out["raised"] = {"ranks": e.ranks, "leaf": e.leaf_path,
                             "digests": {str(k): v
                                         for k, v in e.digests.items()},
                             "message": str(e)}
        with open(f"{out_dir}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("audit_gang")
    ctx = start_gang(_worker, 3, (3, str(d / "store"), str(d)))
    join_gang(ctx, timeout=120.0)
    out = []
    for r in range(3):
        with open(d / f"rank{r}.json") as fh:
            out.append(json.load(fh))
    return out


@pytest.mark.timeout(180)
def test_gang_clean_round_agrees(gang):
    want = f"{audit.fingerprint(_gang_tree(0))[0]:016x}"
    assert [o["clean"] for o in gang] == [want] * 3


@pytest.mark.timeout(180)
def test_gang_names_the_flipped_rank_and_leaf(gang):
    for o in gang:
        r = o["raised"]
        assert r is not None
        assert r["ranks"] == [1] and r["leaf"] == "b"
        d = r["digests"]
        assert d["0"] == d["2"] == gang[0]["clean"] != d["1"]
        assert "diverged on rank(s) [1] (first divergent leaf: b)" in \
            r["message"]


@pytest.mark.parametrize("interval,steps,fired", [
    (2, [1, 2, 3, 4, 6], [2, 4, 6]),
    (3, [3, 4, 5, 9], [3, 9]),
    (0, [1, 2, 3], []),
], ids=["every-2", "every-3", "off"])
def test_auditor_paces_off_the_step(monkeypatch, interval, steps, fired):
    calls = []
    monkeypatch.setattr(audit, "audit_replicas", calls.append)
    a = audit.ReplicaAuditor(interval)
    ran = [s for s in steps if a.maybe_audit({"s": s}, step=s)]
    assert ran == fired and [c["s"] for c in calls] == fired
    assert a.audits == len(fired)


def test_auditor_reads_the_env_and_counts_without_step(monkeypatch):
    calls = []
    monkeypatch.setattr(audit, "audit_replicas", calls.append)
    monkeypatch.setenv("HVD_AUDIT_INTERVAL", "3")
    a = audit.ReplicaAuditor()
    assert a.interval == 3
    assert [a.maybe_audit("tree") for _ in range(7)] == [
        False, False, True, False, False, True, False]
    monkeypatch.delenv("HVD_AUDIT_INTERVAL")
    assert audit.ReplicaAuditor().interval == 0
    with pytest.raises(ValueError, match=">= 0"):
        audit.ReplicaAuditor(-1)


def test_audit_at_one_rank_returns_the_folded_digest():
    hvd.init(device="cpu")
    try:
        tree = _gang_tree(0)
        assert audit.audit_replicas(tree) == audit.fingerprint(tree)[0]
    finally:
        hvd.shutdown()


def test_error_types_are_the_jax_packages():
    from horovod_tpu.common import types as jtypes

    for args in (([3, 1], "layers.0.wq", {0: "ab"}), ([2],)):
        a = ptypes.ReplicaDivergenceError(*args)
        b = jtypes.ReplicaDivergenceError(*args)
        assert str(a) == str(b) and a.ranks == b.ranks == sorted(args[0])
        assert a.leaf_path == b.leaf_path and a.digests == b.digests
        assert isinstance(a, ptypes.RanksFailedError)
    assert str(ptypes.RanksFailedError([2, 0])) == \
        str(jtypes.RanksFailedError([2, 0]))
    f, g = (m.FencedError("kv write 'k'", 1, 3) for m in (ptypes, jtypes))
    assert str(f) == str(g) and (f.stale_epoch, f.current_epoch) == (1, 3)
    assert not isinstance(f, ptypes.RanksFailedError)
