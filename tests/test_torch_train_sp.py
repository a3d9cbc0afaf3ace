"""The port's sequence-parallel training step against the JAX package's, on
the CPU.

Three AdamW steps of ``make_transformer_train_step(cfg, mesh=...)`` in a
four-process gloo gang, from the JAX package's initial weights (converted)
on the same global batch (numpy), against JAX's
``make_transformer_train_step(cfg, mesh)`` on a four-device CPU mesh with
the batch laid out ``P('dp', 'sp')``:

* ``{"dp": 2, "sp": 2}`` with ring and with Ulysses attention;
* ``{"sp": 4}`` with ring attention.

(Dense and flash attention over ``sp``, and tensor parallelism, are
``tests/test_torch_train_tp.py``'s.)

2 layers, d_model 64, 4 heads, vocab 128, global batch 4 x 64, fp32.  Every
rank's loss at every step is the JAX step's (the loss over the global
batch), every rank ends with the same weights, and those are JAX's: both at
1e-4, as ``tests/test_torch_train.py`` holds the data-parallel step (Adam
divides by the gradient's own size).  The gang also computes each rank's
logits at the initial weights over ``{"sp": 4}``: RoPE must rotate each
position at its place in the whole sequence, so they are the whole
sequence's logits (JAX, no mesh) at 1e-5.  The worker imports only torch
and the port at module level; JAX is imported inside the tests.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import train
from horovod_tpu_torch.parallel.mesh import make_mesh


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


SIZE = 4
SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=64)
B, S = 4, 64
STEPS = 3
# name -> (mesh axes, attn_impl)
RUNS = {"dp2_sp2-ring": ({"dp": 2, "sp": 2}, "ring"),
        "dp2_sp2-ulysses": ({"dp": 2, "sp": 2}, "ulysses"),
        "sp4-ring": ({"sp": 4}, "ring")}


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 128, (B, S)), rs.randint(0, 128, (B, S))


def _shard(x, mesh):
    """This rank's [B/dp, S/sp] slice of a P('dp', 'sp') batch."""
    dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
    i, j = mesh.coords.get("dp", 0), mesh.coords.get("sp", 0)
    b, s = x.shape[0] // dp, x.shape[1] // sp
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def _sp_worker(rank, size, store, data_path, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        d = dict(np.load(data_path))
        sd = convert.params_from_jax(
            {"embed": d["embed"], "ln_f": d["ln_f"],
             "layers": {k: d[f"layers.{k}"] for k in convert.LAYER_KEYS}})
        out = {}
        for name, (axes, impl) in RUNS.items():
            mesh = make_mesh(axes)
            cfg = tfm.TransformerConfig(compute_dtype=torch.float32,
                                        attn_impl=impl, **SMALL)
            step_fn, init_fn = train.make_transformer_train_step(
                cfg, mesh=mesh, device="cpu")
            state = init_fn(0)
            with torch.no_grad():
                state.model.load_state_dict(sd)
            if name == "sp4-ring":
                with torch.no_grad():
                    logits, _ = tfm.apply(state.model, torch.tensor(
                        _shard(d["toks"], mesh)), mesh=mesh)
                out["logits"] = logits.numpy()
            toks, tgts = (torch.tensor(_shard(d[k], mesh))
                          for k in ("toks", "tgts"))
            losses = []
            for _ in range(STEPS):
                state, loss = step_fn(state, toks, tgts)
                losses.append(float(loss))
            out[f"{name}.losses"] = np.array(losses)
            for k, v in state.model.state_dict().items():
                out[f"{name}.{k}"] = v.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


def _jax_cfg(impl):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    return jtfm.TransformerConfig(compute_dtype=jnp.float32, attn_impl=impl,
                                  **SMALL)


@pytest.fixture(scope="module")
def params0():
    import jax

    from horovod_tpu.models import transformer as jtfm

    params = jtfm.init(jax.random.PRNGKey(0), _jax_cfg("dense"))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def gang(tmp_path_factory, params0):
    d = tmp_path_factory.mktemp("train_sp_gang")
    toks, tgts = _batch()
    data = d / "data.npz"
    np.savez(data, toks=toks, tgts=tgts, embed=params0["embed"],
             ln_f=params0["ln_f"],
             **{f"layers.{k}": v for k, v in params0["layers"].items()})
    _spawn_gang(_sp_worker, SIZE, (SIZE, str(d / "store"), str(data),
                                   str(d)), timeout=300.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)]


def _jax_run(eight_devices, params0, axes, impl):
    """JAX's make_transformer_train_step on a mesh with ``axes`` from
    ``params0``: (losses, final params as numpy)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import train as jtrain

    mesh = jmesh.make_mesh(axes, devices=eight_devices[:SIZE])
    step, init = jtrain.make_transformer_train_step(_jax_cfg(impl), mesh)
    state = init(jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, params0))
    toks, tgts = _batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_sequence_parallel_steps_match_jax(eight_devices, params0, gang, run):
    axes, impl = RUNS[run]
    jlosses, jparams = _jax_run(eight_devices, params0, axes, impl)
    keys = [k for k in gang[0] if k.startswith(run + ".")
            and not k.endswith(".losses")]
    assert len(keys) == 2 + 9 * SMALL["n_layers"]
    for k in keys:  # every rank holds the same model
        for out in gang[1:]:
            np.testing.assert_array_equal(out[k], gang[0][k], err_msg=k)
    for r, out in enumerate(gang):
        np.testing.assert_allclose(out[f"{run}.losses"], jlosses, rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
    assert jlosses[-1] < jlosses[0]
    got = convert.params_to_jax({k[len(run) + 1:]: torch.from_numpy(
        gang[0][k]) for k in keys})
    for name in ("embed", "ln_f"):
        np.testing.assert_allclose(got[name], jparams[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for k, v in jparams["layers"].items():
        np.testing.assert_allclose(got["layers"][k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_sequence_shards_see_their_positions(gang, params0):
    """Each sp rank's logits are the whole sequence's at its positions:
    RoPE rotates rank i's tokens at i*S_local + arange(S_local)."""
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    toks, _ = _batch()
    want, _ = jtfm.apply(params0, jnp.asarray(toks), _jax_cfg("dense"))
    want = np.asarray(want)
    n = S // SIZE
    for r, out in enumerate(gang):
        np.testing.assert_allclose(out["logits"], want[:, r * n:(r + 1) * n],
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


def test_rope_rotates_at_the_offset():
    x = torch.randn(1, 12, 2, 8)
    whole = tfm._rope(x, 10000.0)
    torch.testing.assert_close(tfm._rope(x[:, 8:], 10000.0, 8),
                               whole[:, 8:], rtol=0, atol=0)
    assert not torch.allclose(tfm._rope(x[:, 8:], 10000.0), whole[:, 8:])


def test_what_the_step_does_not_take_raises(caplog):
    """ZeRO-1 and a pipeline (``pp``) axis no longer raise (meshes stand
    in by their shape: nothing is built before the step runs): ZeRO-1
    without a dp axis > 1 logs the JAX package's warning and keeps the
    state replicated, and a ``pp`` axis holds replicas
    (``tests/test_torch_zero1.py``, ``tests/test_torch_pipeline.py``).
    Tensor and expert axes, and dense or flash attention over a
    sequence-sharded batch, run (``tests/test_torch_train_tp.py``,
    ``tests/test_torch_moe.py``): there dense and flash attention gather
    K/V over ``sp``, as GSPMD does.  Ulysses raises where a tp rank's heads
    do not split over ``sp``; a mesh whose tp does not divide the heads
    raises."""
    from horovod_tpu_torch.parallel import ring_attention as ra

    cfg = tfm.TransformerConfig(compute_dtype=torch.float32, **SMALL)
    with caplog.at_level("WARNING", logger="horovod_tpu_torch"):
        train.make_transformer_train_step(cfg, zero1=True, device="cpu")
    assert "zero1=True but the mesh has no dp axis > 1" in caplog.text
    train.make_transformer_train_step(
        cfg, mesh=SimpleNamespace(shape={"dp": 2, "pp": 2}), device="cpu")
    with pytest.raises(ValueError, match="n_heads 4 is not divisible"):
        train.make_transformer_train_step(
            cfg, mesh=SimpleNamespace(shape={"tp": 3}), device="cpu")

    def axis(n):
        return SimpleNamespace(names=("sp",), size=n, index=0)

    mesh = SimpleNamespace(shape={"sp": 2, "tp": 2},
                           axis=lambda name: axis(2))
    for impl in ("dense", "flash"):
        fn = tfm._attention_fn(dataclasses.replace(cfg, attn_impl=impl),
                               mesh)
        assert fn.func is ra.gathered_attention
    q = torch.zeros(1, 4, 2, 16)  # a tp rank's 2 of 4 heads
    with pytest.raises(ValueError, match=r"H/tp = 2, tp 2\) divisible by "
                       r"sp \(4\)"):
        ra.ulysses_attention(q, q, q, axis(4), head_axis=axis(2))
