"""The port's checkpoints (``horovod_tpu_torch.utils.checkpoint``) on the
CPU: the plain and verified layers in one process (round trips, the
manifest, which the JAX package's ``verify_checkpoint`` accepts, pruning,
the fallback past a corrupted file, and past one that the ``ckpt.corrupt``
fault site corrupted), and, in one two-process gloo gang,
training states resumed bit for bit: replicated state (rank 0 writes),
ZeRO-1 moments over ``{"dp": 2}`` and a pipeline stage over ``{"pp": 2}``
(every rank writes its shard).  A resumed state's next step gives the same
loss and parameters, bit for bit, as the step the saved state took."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel import train
from horovod_tpu_torch.parallel.mesh import make_mesh
from horovod_tpu_torch.utils import checkpoint as ckpt

from test_torch_train_tp import join_gang, start_gang

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=64, compute_dtype=torch.float32)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g), "step": 7,
            "nested": [torch.arange(5), {"b": torch.randn(2, generator=g)}]}


def _equal(a, b):
    la, sa = torch.utils._pytree.tree_flatten(a)
    lb, sb = torch.utils._pytree.tree_flatten(b)
    return sa == sb and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _flip_a_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_save_restore_round_trip(tmp_path):
    tree = _tree()
    assert not ckpt.exists(str(tmp_path / "c"))
    assert ckpt.save(str(tmp_path / "c"), tree)
    assert ckpt.exists(str(tmp_path / "c"))
    assert _equal(ckpt.restore(str(tmp_path / "c")), tree)
    with pytest.raises(FileExistsError):
        ckpt.save(str(tmp_path / "c"), tree, force=False)
    # A template gives each tensor its dtype (and device).
    template = dict(tree, w=tree["w"].to(torch.float64))
    got = ckpt.restore(str(tmp_path / "c"), template)
    assert got["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path / "c"), {"w": tree["w"]})


def test_resume_or_init(tmp_path):
    path = str(tmp_path / "c")
    fresh = ckpt.resume_or_init(path, lambda: {"w": torch.zeros(3)})
    assert torch.equal(fresh["w"], torch.zeros(3))
    ckpt.save(path, {"w": torch.ones(3)})
    got = ckpt.resume_or_init(path, lambda: {"w": torch.zeros(3)})
    assert torch.equal(got["w"], torch.ones(3))


def test_verified_manifest_and_pruning(tmp_path, monkeypatch):
    from horovod_tpu.utils import checkpoint as jckpt

    root = str(tmp_path / "ck")
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "4")
    monkeypatch.setenv("HVD_CKPT_KEEP", "2")
    for step in (1, 2, 3):
        final = ckpt.save_verified(root, _tree(), step=step)
        assert final == os.path.join(root, f"step_{step}")
    assert [s for s, _ in ckpt.list_steps(root)] == [3, 2]
    assert sorted(os.listdir(root)) == ["step_2", "step_2.manifest.json",
                                        "step_3", "step_3.manifest.json"]
    with open(ckpt.manifest_path(final)) as fh:
        manifest = json.load(fh)
    assert manifest["format"] == 1 and manifest["step"] == 3
    assert manifest["epoch"] == 4 and list(manifest["files"]) == ["state.pt"]
    # The JAX package reads the same layout.
    assert jckpt.verify_checkpoint(final) == (True, "")
    assert jckpt.list_steps(root) == ckpt.list_steps(root)
    tree, step = ckpt.restore_verified(root)
    assert step == 3 and _equal(tree, _tree())
    with pytest.raises(ValueError, match="keep"):
        ckpt.save_verified(root, _tree(), step=4, keep=0)


def test_corrupt_file_falls_back_to_the_previous(tmp_path, caplog):
    root = str(tmp_path / "ck")
    ckpt.save_verified(root, {"w": torch.zeros(4)}, step=1)
    ckpt.save_verified(root, {"w": torch.ones(4)}, step=2)
    _flip_a_byte(os.path.join(root, "step_2", "state.pt"))
    ok, reason = ckpt.verify_checkpoint(os.path.join(root, "step_2"))
    assert not ok and "sha256 mismatch" in reason
    with caplog.at_level(logging.WARNING,
                         logger="horovod_tpu_torch.checkpoint"):
        tree, step = ckpt.restore_verified(root)
    assert step == 1 and torch.equal(tree["w"], torch.zeros(4))
    assert "failed verification" in caplog.text
    _flip_a_byte(os.path.join(root, "step_1", "state.pt"))
    with pytest.raises(ckpt.CheckpointVerifyError, match="step_2.*step_1"):
        ckpt.restore_verified(root)
    os.remove(ckpt.manifest_path(os.path.join(root, "step_1")))
    assert ckpt.verify_checkpoint(os.path.join(root, "step_1")) == (
        False, "no manifest sidecar")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_verified(str(tmp_path / "empty"))


def test_ckpt_corrupt_site_falls_back_to_the_previous(tmp_path):
    """The ``ckpt.corrupt`` fault site corrupts the newest checkpoint
    after its manifest is sealed; restore falls back to the previous
    verified step, as in the JAX package's
    ``test_ckpt_corrupt_falls_back_to_previous`` on the same plan."""
    root = str(tmp_path / "ver")
    ckpt.save_verified(root, {"w": torch.full((8,), 1.0)}, step=1)
    try:
        fi.configure({"faults": [
            {"site": "ckpt.corrupt", "kind": "corrupt", "times": 1}]})
        ckpt.save_verified(root, {"w": torch.full((8,), 2.0)}, step=2)
        assert fi._PLAN.faults[0].fired == 1
    finally:
        fi.clear()
    ok, reason = ckpt.verify_checkpoint(os.path.join(root, "step_2"))
    assert not ok and "sha256 mismatch" in reason
    tree, step = ckpt.restore_verified(root)
    assert step == 1 and torch.equal(tree["w"], torch.full((8,), 1.0))


def test_ckpt_corrupt_site_on_every_save_leaves_none_to_restore(tmp_path):
    root = str(tmp_path / "ver")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_verified(root)
    try:
        fi.configure({"faults": [
            {"site": "ckpt.corrupt", "kind": "corrupt"}]})
        ckpt.save_verified(root, {"w": torch.full((8,), 1.0)}, step=1)
        ckpt.save_verified(root, {"w": torch.full((8,), 2.0)}, step=2)
        assert fi._PLAN.faults[0].fired == 2
    finally:
        fi.clear()
    with pytest.raises(ckpt.CheckpointVerifyError, match="no verifiable"):
        ckpt.restore_verified(root)


def _resume(name, make, mesh, toks, tgts, root, sharded, out):
    """Two steps, a verified checkpoint, a third step; then a state made
    from another seed, restored, takes the third step again."""
    step_fn, init_fn = make()
    state = init_fn(0)
    for _ in range(2):
        state, _ = step_fn(state, toks, tgts)
    final = ckpt.save_verified(root, train.state_tree(state), step=2,
                               mesh=mesh if sharded else None)
    C.barrier()  # replicated: the other ranks wait for rank 0's write
    state, loss = step_fn(state, toks, tgts)
    fresh = init_fn(1)
    tree, step = ckpt.restore_verified(root, mesh=mesh if sharded else None)
    fresh = train.load_state_tree(fresh, tree)
    fresh, again = step_fn(fresh, toks, tgts)
    out[f"{name}.written"] = np.array(final is not None)
    out[f"{name}.files"] = np.array(sorted(os.listdir(
        os.path.join(root, "step_2"))))
    out[f"{name}.step"] = np.array([step, fresh.step])
    out[f"{name}.same_loss"] = np.array(float(loss) == float(again))
    out[f"{name}.same_params"] = np.array(all(
        torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                          fresh.model.state_dict().values())))
    out[f"{name}.moments_share"] = np.array(
        [st["exp_avg"].numel() for st in
         state.optimizer.inner.state.values()]).sum() / sum(
            p.numel() for p in state.model.parameters())


def _worker(rank, size, store, out_dir):
    torch.set_num_threads(1)
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        rs = np.random.RandomState(0)
        toks = rs.randint(0, 128, (4, 64))
        tgts = rs.randint(0, 128, (4, 64))
        cfg = tfm.TransformerConfig(**SMALL)
        out = {}
        dp = make_mesh({"dp": 2})
        pp = make_mesh({"pp": 2})
        half = slice(2 * rank, 2 * rank + 2)  # the rank's P('dp') rows
        cases = {
            "replicated": (lambda: train.make_transformer_train_step(
                cfg, mesh=dp, device="cpu"), dp, toks[half], tgts[half],
                False),
            "zero1": (lambda: train.make_transformer_train_step(
                cfg, mesh=dp, zero1=True, device="cpu"), dp, toks[half],
                tgts[half], True),
            "pp": (lambda: pl.make_pipeline_train_step(
                cfg, mesh=pp, device="cpu"), pp, toks, tgts, True),
        }
        for name, (make, mesh, x, y, sharded) in cases.items():
            _resume(name, make, mesh, torch.tensor(x), torch.tensor(y),
                    os.path.join(out_dir, name), sharded, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkpoint_gang")
    ctx = start_gang(_worker, 2, (2, str(d / "store"), str(d)))
    join_gang(ctx, timeout=240.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name,files,writers,share", [
    ("replicated", ["state.pt"], [True, False], 1.0),
    ("zero1", ["shard_dp0.pt", "shard_dp1.pt"], [True, True], 0.5),
    ("pp", ["shard_pp0.pt", "shard_pp1.pt"], [True, True], 1.0)])
def test_gang_resumes_bit_for_bit(gang, name, files, writers, share):
    """Rank 0 alone writes replicated state; every rank writes its shard
    of ZeRO-1 (each rank's moments are half of the model) and pipeline
    state, under its mesh coordinates; the resumed step equals the
    original bit for bit on every rank."""
    for r, out in enumerate(gang):
        assert bool(out[f"{name}.written"]) == writers[r]
        assert list(out[f"{name}.files"]) == files
        assert list(out[f"{name}.step"]) == [2, 3]
        assert bool(out[f"{name}.same_loss"]), f"rank {r}"
        assert bool(out[f"{name}.same_params"]), f"rank {r}"
        assert float(out[f"{name}.moments_share"]) == share
