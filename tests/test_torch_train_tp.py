"""The port's transformer step over tensor-parallel meshes, and dense
attention over a sequence-sharded batch, against the JAX package's, on the
CPU.

Three AdamW steps of ``make_transformer_train_step(cfg, mesh=...)`` in one
four-process gloo gang, from the JAX package's initial weights (converted,
each rank keeping its shard by ``param_specs``) on the same global batch
(numpy), against JAX's ``make_transformer_train_step(cfg, mesh)`` on a
four-device CPU mesh (GSPMD):

* ``{"dp": 2, "tp": 2}`` with dense attention (Megatron layers, the
  vocabulary-parallel embedding, projection and cross-entropy);
* ``{"tp": 2, "sp": 2}`` with ring attention over each rank's heads;
* ``{"dp": 2, "sp": 2}`` with dense attention, and with flash attention,
  which the JAX package runs as dense there (K/V gathered over ``sp``).

2 layers, d_model 64, 4 heads, vocab 128, global batch 4 x 64, fp32.
Every rank's loss at every step is JAX's (the loss over the global batch),
and each rank's shard of every parameter is JAX's slice of it, both at
1e-4 (as ``tests/test_torch_train.py`` holds the data-parallel step);
replicated parameters end equal on every rank, and sharded ones on the
ranks that hold the same shard.  The gang runs while the JAX side does.
The worker imports only torch and the port at module level; JAX is
imported inside the tests.
"""

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

SIZE = 4
SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=64)
B, S = 4, 64
STEPS = 3
TOL = 1e-4
# name -> (mesh axes, attn_impl)
RUNS = {"dp2_tp2-dense": ({"dp": 2, "tp": 2}, "dense"),
        "tp2_sp2-ring": ({"tp": 2, "sp": 2}, "ring"),
        "dp2_sp2-dense": ({"dp": 2, "sp": 2}, "dense"),
        "dp2_sp2-flash": ({"dp": 2, "sp": 2}, "flash")}


def start_gang(fn, nprocs, args):
    return mp.start_processes(fn, nprocs=nprocs, join=False,
                              start_method="spawn", args=args)


def join_gang(ctx, timeout):
    """Wait for a gang from :func:`start_gang`; kill it and fail if it has
    not finished within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gang did not finish in {timeout:g}s")


def batch(vocab=128):
    rs = np.random.RandomState(0)
    return rs.randint(0, vocab, (B, S)), rs.randint(0, vocab, (B, S))


def shard_batch(x, mesh):
    """This rank's [B/dp, S/sp] slice of a P('dp', 'sp') batch."""
    dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
    i, j = mesh.coords.get("dp", 0), mesh.coords.get("sp", 0)
    b, s = x.shape[0] // dp, x.shape[1] // sp
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def save_tree(path, tree, **extra):
    np.savez(path, embed=tree["embed"], ln_f=tree["ln_f"],
             **{f"layers.{k}": v for k, v in tree["layers"].items()},
             **extra)


def load_tree(d):
    return {"embed": d["embed"], "ln_f": d["ln_f"],
            "layers": {k[7:]: v for k, v in d.items()
                       if k.startswith("layers.")}}


def run_gang_steps(runs, small, data_path, out_path, grads_of=()):
    """In a gang rank: STEPS steps of each run from the weights in
    ``data_path``; saves every run's losses, final shard, coordinates and,
    for the parameter names in ``grads_of``, the first step's reduced
    gradient."""
    d = dict(np.load(data_path))
    tree = load_tree({k: v for k, v in d.items() if k not in ("toks",
                                                             "tgts")})
    out = {}
    for name, (axes, impl) in runs.items():
        mesh = make_mesh(axes)
        cfg = tfm.TransformerConfig(compute_dtype=torch.float32,
                                    attn_impl=impl, **small)
        step_fn, init_fn = train.make_transformer_train_step(
            cfg, mesh=mesh, device="cpu")
        state = init_fn(0)
        with torch.no_grad():
            state.model.load_state_dict(convert.params_from_jax(tree,
                                                                mesh=mesh))
        toks, tgts = (torch.tensor(shard_batch(d[k], mesh))
                      for k in ("toks", "tgts"))
        losses = []
        for step in range(STEPS):
            state, loss = step_fn(state, toks, tgts)
            losses.append(float(loss))
            if step == 0:
                for k, p in state.model.named_parameters():
                    if k.split(".")[-1] in grads_of:
                        out[f"{name}.grad.{k}"] = p.grad.numpy().copy()
        out[f"{name}.losses"] = np.array(losses)
        for a, c in mesh.coords.items():
            out[f"{name}.coord.{a}"] = np.array(c)
        for k, v in state.model.state_dict().items():
            out[f"{name}.{k}"] = v.numpy()
    np.savez(out_path, **out)


def _worker(rank, size, store, data_path, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        run_gang_steps(RUNS, SMALL, data_path, f"{out_dir}/rank{rank}.npz")
    finally:
        hvd.shutdown()


def jax_cfg(impl, **small):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    return jtfm.TransformerConfig(compute_dtype=jnp.float32, attn_impl=impl,
                                  **small)


def jax_steps(eight_devices, params0, cfg, axes, toks, tgts):
    """JAX's make_transformer_train_step on a mesh with ``axes`` from
    ``params0``: (losses, final params as numpy)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import train as jtrain

    mesh = jmesh.make_mesh(axes, devices=eight_devices[:SIZE])
    step, init = jtrain.make_transformer_train_step(cfg, mesh)
    state = init(jax.random.PRNGKey(0))
    state = state._replace(params=jax.device_put(
        jax.tree.map(jnp.asarray, params0),
        jax.tree.map(lambda a: a.sharding, state.params)))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def rank_view(out, run):
    """A rank's run: (coords as a mesh stand-in, losses, state_dict)."""
    p = run + "."
    coords = {k[len(p) + 6:]: int(v) for k, v in out.items()
              if k.startswith(p + "coord.")}
    sd = {k[len(p):]: v for k, v in out.items() if k.startswith(p)
          and not k.startswith((p + "coord.", p + "grad."))
          and k != p + "losses"}
    return coords, out[p + "losses"], sd


def assert_run_matches(gang, run, axes, jlosses, jparams, specs):
    """Every rank's losses and shard against JAX's; equal shards equal."""
    views = [rank_view(out, run) for out in gang]
    assert jlosses[-1] < jlosses[0]
    for r, (coords, losses, sd) in enumerate(views):
        np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL,
                                   err_msg=f"{run} rank {r}")
        want = convert.params_from_jax(
            jparams, mesh=SimpleNamespace(shape=axes, coords=coords))
        assert sorted(sd) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{run} rank {r} {k}")
    for k in views[0][2]:
        spec = tfm.spec_of(specs, k)
        for r, (coords, _, sd) in enumerate(views[1:], 1):
            same = all(coords.get(a, 0) == views[0][0].get(a, 0)
                       for a in spec if a is not None)
            if same:  # replicated, or the same shard
                np.testing.assert_array_equal(sd[k], views[0][2][k],
                                              err_msg=f"{run} rank {r} {k}")


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    """The gang's outputs, and each run's JAX (losses, params)."""
    import jax

    from horovod_tpu.models import transformer as jtfm

    d = tmp_path_factory.mktemp("train_tp_gang")
    params0 = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0),
                                                 jax_cfg("dense", **SMALL)))
    toks, tgts = batch()
    save_tree(d / "data.npz", params0, toks=toks, tgts=tgts)
    ctx = start_gang(_worker, SIZE, (SIZE, str(d / "store"),
                                     str(d / "data.npz"), str(d)))
    try:
        jax_runs = {name: jax_steps(eight_devices, params0,
                                    jax_cfg(impl, **SMALL), axes, toks, tgts)
                    for name, (axes, impl) in RUNS.items()}
    finally:
        join_gang(ctx, timeout=240.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)], jax_runs


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_steps_match_jax(runs, run):
    gang, jax_runs = runs
    jlosses, jparams = jax_runs[run]
    assert_run_matches(gang, run, RUNS[run][0], jlosses, jparams,
                       tfm.param_specs(tfm.TransformerConfig(**SMALL)))


@pytest.mark.timeout(300)
def test_tp_shards_are_halves(runs):
    """Under tp each rank holds half the heads, FFN columns and vocabulary
    rows; the norms are whole."""
    coords, _, sd = rank_view(runs[0][0], "dp2_tp2-dense")
    assert sd["embed"].shape == (64, 64)
    assert sd["layers.0.wq"].shape == (64, 2, 16)
    assert sd["layers.0.wo"].shape == (2, 16, 64)
    assert sd["layers.0.w_in"].shape == (64, 64)
    assert sd["layers.0.w_out"].shape == (64, 64)
    assert sd["layers.0.ln1"].shape == (64,)
