"""The port's Switch MoE FFN against the JAX package's, on the CPU.

2 layers, d_model 64, 4 heads, vocab 128, 4 experts, fp32, global batch
4 x 64, at a ``capacity_factor`` (1.0) at which the JAX package drops
tokens (asserted):

* without a mesh, the MoE layer (``_moe_ffn``) on the same input and
  weights: the output at 1e-5, the aux loss at 1e-6 and the same set of
  dropped tokens (the rows whose output is zero); and the whole model's
  logits at 1e-5 and aux loss at 1e-6;
* three AdamW steps of ``make_transformer_train_step(cfg, mesh=...)`` in
  one four-process gloo gang on ``{"dp": 2, "ep": 2}`` (experts split),
  ``{"ep": 2, "tp": 2}`` (experts split over ep and their width over tp)
  and ``{"dp": 2, "sp": 2}`` with ring attention (tokens of one row on two
  ranks: each token's place in its expert's buffer comes from the global
  order), against JAX's ``make_transformer_train_step(cfg, mesh)`` on a
  four-device CPU mesh: every rank's losses and shard of every parameter
  at 1e-4, and the first step's router gradient on every rank against the
  JAX package's gradient of the loss over the global batch at 1e-4 of
  itself (relative, and absolute against its largest element: it is about
  4e-4).

The worker imports only torch and the port at module level; JAX is
imported inside the tests.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm

from test_torch_train_tp import (SIZE, assert_run_matches, batch, jax_cfg,
                                 jax_steps, join_gang, run_gang_steps,
                                 save_tree, start_gang)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=64, n_experts=4, capacity_factor=1.0)
RUNS = {"dp2_ep2": ({"dp": 2, "ep": 2}, "dense"),
        "ep2_tp2": ({"ep": 2, "tp": 2}, "dense"),
        "dp2_sp2-ring": ({"dp": 2, "sp": 2}, "ring")}


def _worker(rank, size, store, data_path, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        run_gang_steps(RUNS, SMALL, data_path, f"{out_dir}/rank{rank}.npz",
                       grads_of=("router",))
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def params0():
    import jax

    from horovod_tpu.models import transformer as jtfm

    return jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0),
                                              jax_cfg("dense", **SMALL)))


def _port_model(params, **kw):
    model = tfm.Transformer(tfm.TransformerConfig(
        compute_dtype=torch.float32, **{**SMALL, **kw}))
    with torch.no_grad():
        model.load_state_dict(convert.params_from_jax(params))
    return model


def test_moe_layer_matches_jax_and_drops_the_same_tokens(params0):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    rs = np.random.RandomState(5)
    x = rs.randn(4, 64, 64).astype(np.float32)
    lp = {k: v[0] for k, v in params0["layers"].items()}
    want, waux = jtfm._moe_ffn(jnp.asarray(x),
                               {k: jnp.asarray(v) for k, v in lp.items()},
                               jax_cfg("dense", **SMALL))
    want = np.asarray(want).reshape(-1, 64)
    model = _port_model(params0)
    stats = []
    with torch.no_grad():
        got, aux = tfm._moe_ffn(torch.tensor(x), model.layers[0], model.cfg,
                                tfm._layout(None), stats)
    got = got.numpy().reshape(-1, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6, atol=1e-6)
    dropped = np.all(want == 0, axis=1)
    assert dropped.sum() > 0, "JAX drops no token at this capacity factor"
    np.testing.assert_array_equal(np.all(got == 0, axis=1), dropped)
    assert int(stats[0]["dropped"]) == dropped.sum()


def test_moe_model_logits_match_jax(params0):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    toks, _ = batch()
    want, waux = jtfm.apply(params0, jnp.asarray(toks),
                            jax_cfg("dense", **SMALL))
    with torch.no_grad():
        got, aux = tfm.apply(_port_model(params0), torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory, params0):
    """The gang's outputs, each run's JAX (losses, params), and JAX's
    gradient of the loss over the global batch at the initial weights."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    d = tmp_path_factory.mktemp("moe_gang")
    toks, tgts = batch()
    save_tree(d / "data.npz", params0, toks=toks, tgts=tgts)
    ctx = start_gang(_worker, SIZE, (SIZE, str(d / "store"),
                                     str(d / "data.npz"), str(d)))
    try:
        jax_runs = {name: jax_steps(eight_devices, params0,
                                    jax_cfg(impl, **SMALL), axes, toks, tgts)
                    for name, (axes, impl) in RUNS.items()}
        grads = jax.tree.map(np.asarray, jax.grad(jtfm.loss_fn)(
            jax.tree.map(jnp.asarray, params0), jnp.asarray(toks),
            jnp.asarray(tgts), jax_cfg("dense", **SMALL)))
    finally:
        join_gang(ctx, timeout=240.0)
    return ([dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)],
            jax_runs, grads)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_moe_steps_match_jax(runs, run):
    gang, jax_runs, _ = runs
    jlosses, jparams = jax_runs[run]
    assert_run_matches(gang, run, RUNS[run][0], jlosses, jparams,
                       tfm.param_specs(tfm.TransformerConfig(**SMALL)))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_moe_router_gradient_is_the_global_loss_gradient(runs, run):
    """The router is replicated; its reduced gradient on every rank is the
    gradient of the global batch's loss (cross-entropy through the gates,
    and the aux loss's global statistics)."""
    gang, _, grads = runs
    want = grads["layers"]["router"]
    scale = np.abs(want).max()
    assert scale > 1e-5
    for r, out in enumerate(gang):
        for i in range(SMALL["n_layers"]):
            got = out[f"{run}.grad.layers.{i}.router"]
            np.testing.assert_allclose(got, want[i], rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=f"{run} rank {r} layer {i}")


@pytest.mark.parametrize("coords", [{"ep": 0, "tp": 1}, {"ep": 1, "tp": 0}])
def test_convert_keeps_this_ranks_shard(coords):
    """``params_from_jax`` and ``params_to_jax`` with a mesh keep the
    rank's block by ``param_specs``: experts over ep, their width over
    tp, heads and the vocabulary over tp, the router and norms whole."""
    from types import SimpleNamespace

    rs = np.random.RandomState(9)
    L, D, H, HD, E, F_, V = 2, 8, 4, 2, 4, 6, 10
    shapes = {"ln1": (L, D), "ln2": (L, D), "wq": (L, D, H, HD),
              "wk": (L, D, H, HD), "wv": (L, D, H, HD), "wo": (L, H, HD, D),
              "router": (L, D, E), "w_in": (L, E, D, F_),
              "w_gate": (L, E, D, F_), "w_out": (L, E, F_, D)}
    tree = {"embed": rs.randn(V, D), "ln_f": rs.randn(D),
            "layers": {k: rs.randn(*s) for k, s in shapes.items()}}
    mesh = SimpleNamespace(shape={"ep": 2, "tp": 2}, coords=coords)
    e, t = coords["ep"], coords["tp"]
    got = convert.params_from_jax(tree, mesh=mesh)
    lay = tree["layers"]
    want = {"embed": tree["embed"][t * 5:(t + 1) * 5], "ln_f": tree["ln_f"],
            "layers.1.wq": lay["wq"][1][:, t * 2:(t + 1) * 2],
            "layers.1.wo": lay["wo"][1][t * 2:(t + 1) * 2],
            "layers.1.router": lay["router"][1],
            "layers.1.w_in": lay["w_in"][1][e * 2:(e + 1) * 2, :,
                                            t * 3:(t + 1) * 3],
            "layers.1.w_out": lay["w_out"][1][e * 2:(e + 1) * 2,
                                              t * 3:(t + 1) * 3]}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.astype(np.float32),
                                      err_msg=k)
    back = convert.params_to_jax(convert.params_from_jax(tree), mesh=mesh)
    for k, v in got.items():
        name = k.split(".")[-1]
        b = back[name] if name in ("embed", "ln_f") else \
            back["layers"][name][int(k.split(".")[1])]
        np.testing.assert_array_equal(b, v.numpy(), err_msg=k)
