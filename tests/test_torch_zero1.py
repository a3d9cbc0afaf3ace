"""ZeRO-1 (``make_transformer_train_step(zero1=True)``) against the JAX
package's, on the CPU.

One four-process gloo gang, run while the JAX side does, takes four AdamW
steps at ``{"dp": 4}`` and at ``{"dp": 2, "tp": 2}``, with ``zero1=True``
and with ``zero1=False``, from the JAX package's initial weights on the
same global batch; the JAX side is its ``zero1=True`` step on a CPU mesh
of four devices.  2 layers, d_model 64, 4 heads, vocab 128, fp32, batch
4 x 64.

Tolerances: losses and every rank's shard of every parameter at 1e-4 of
JAX's (as the other train-step parity tests), and the AdamW moments,
gathered over dp, at 1e-4 of JAX's; the port's ``zero1`` losses against
its own ``zero1=False`` losses at rtol 1e-5, as the JAX package's own
ZeRO-1 test holds its two steps.  Each rank's moments of a sharded
parameter hold 1/dp of it.  The two warnings are the JAX package's, word
for word.
"""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import train
from horovod_tpu_torch.parallel.mesh import make_mesh

from test_torch_train_tp import (SIZE, batch, jax_cfg, join_gang, load_tree,
                                 save_tree, shard_batch, start_gang)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=64)
# No dimension of any parameter divisible by 4 (the second warning).
ODD = dict(vocab_size=6, d_model=6, n_layers=1, n_heads=2, d_ff=6,
           max_seq_len=8)
STEPS = 4
TOL = 1e-4
SELF_RTOL = 1e-5
RUNS = {"dp4": {"dp": 4}, "dp2_tp2": {"dp": 2, "tp": 2}}
NO_DP = {"tp": 4}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _moments(opt, model):
    """{"mu.<name>", "nu.<name>": this rank's whole moment of each
    parameter}: a ZeRO-1 piece is all-gathered over dp."""
    out = {}
    pieces = opt.pieces if isinstance(opt, train.Zero1Optimizer) else {}
    params = dict(opt.params) if pieces else dict(model.named_parameters())
    for name, p in params.items():
        st = opt.inner.state[pieces.get(name, p)]
        for key, tag in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            m = st[key]
            if name in pieces:
                d = opt.dims[name]
                out[f"{tag}.{name}.share"] = np.array(m.numel() / p.numel())
                m = C.allgather(m.movedim(d, 0).contiguous(),
                                axis=opt.dp).movedim(0, d)
            out[f"{tag}.{name}"] = m.numpy()
    return out


def _worker(rank, size, store, data_path, out_dir):
    torch.set_num_threads(1)
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        d = dict(np.load(data_path))
        tree = load_tree({k: v for k, v in d.items()
                          if k not in ("toks", "tgts")})
        out = {}
        cfg = tfm.TransformerConfig(compute_dtype=torch.float32, **SMALL)
        for name, axes in RUNS.items():
            mesh = make_mesh(axes)
            toks, tgts = (torch.tensor(shard_batch(d[k], mesh))
                          for k in ("toks", "tgts"))
            for zero1 in (True, False):
                run = f"{name}.{'zero1' if zero1 else 'plain'}"
                step_fn, init_fn = train.make_transformer_train_step(
                    cfg, mesh=mesh, zero1=zero1, device="cpu")
                state = init_fn(0)
                with torch.no_grad():
                    state.model.load_state_dict(
                        convert.params_from_jax(tree, mesh=mesh))
                losses = []
                for _ in range(STEPS):
                    state, loss = step_fn(state, toks, tgts)
                    losses.append(float(loss))
                out[f"{run}.losses"] = np.array(losses)
                if zero1:
                    for a, c in mesh.coords.items():
                        out[f"{run}.coord.{a}"] = np.array(c)
                    for k, v in state.model.state_dict().items():
                        out[f"{run}.{k}"] = v.numpy()
                    for k, v in _moments(state.optimizer,
                                         state.model).items():
                        out[f"{run}.moment.{k}"] = v
        records = _Records()
        logging.getLogger("horovod_tpu_torch").addHandler(records)
        for tag, axes, small in (("no_dp", NO_DP, SMALL),
                                 ("odd", {"dp": 4}, ODD)):
            records.messages.clear()
            train.make_transformer_train_step(
                tfm.TransformerConfig(compute_dtype=torch.float32, **small),
                mesh=make_mesh(axes), zero1=True, device="cpu")
            out[f"warn.{tag}"] = np.array(records.messages)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


def _jax_zero1(eight_devices, params0, cfg, axes, toks, tgts):
    """JAX's zero1=True steps: (losses, params, mu, nu) as numpy."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import train as jtrain

    mesh = jmesh.make_mesh(axes, devices=eight_devices[:SIZE])
    step, init = jtrain.make_transformer_train_step(cfg, mesh, zero1=True)
    state = init(jax.random.PRNGKey(0))
    state = state._replace(params=jax.device_put(
        jax.tree.map(jnp.asarray, params0),
        jax.tree.map(lambda a: a.sharding, state.params)))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(loss))
    adam = state.opt_state[0]
    return (losses,) + tuple(jax.tree.map(np.asarray, t) for t in
                             (state.params, adam.mu, adam.nu))


def _jax_warnings(eight_devices):
    """The JAX package's two ZeRO-1 warnings, as its logger emits them."""
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import train as jtrain
    from horovod_tpu.utils.logging import get_logger

    records = _Records()
    logger = get_logger()
    logger.addHandler(records)
    out = {}
    try:
        for tag, axes, small in (("no_dp", NO_DP, SMALL),
                                 ("odd", {"dp": 4}, ODD)):
            records.messages.clear()
            jtrain.make_transformer_train_step(
                jtfm.TransformerConfig(compute_dtype=jnp.float32, **small),
                jmesh.make_mesh(axes, devices=eight_devices[:SIZE]),
                zero1=True)
            out[tag] = list(records.messages)
    finally:
        logger.removeHandler(records)
    return out


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    import jax

    from horovod_tpu.models import transformer as jtfm

    d = tmp_path_factory.mktemp("zero1_gang")
    params0 = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0),
                                                 jax_cfg("dense", **SMALL)))
    toks, tgts = batch()
    save_tree(d / "data.npz", params0, toks=toks, tgts=tgts)
    ctx = start_gang(_worker, SIZE, (SIZE, str(d / "store"),
                                     str(d / "data.npz"), str(d)))
    try:
        jax_runs = {name: _jax_zero1(eight_devices, params0,
                                     jax_cfg("dense", **SMALL), axes, toks,
                                     tgts)
                    for name, axes in RUNS.items()}
        jax_warn = _jax_warnings(eight_devices)
    finally:
        join_gang(ctx, timeout=240.0)
    return ([dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)],
            jax_runs, jax_warn)


def _where(out, run):
    p = f"{run}.coord."
    return SimpleNamespace(shape=RUNS[run.split(".")[0]], coords={
        k[len(p):]: int(v) for k, v in out.items() if k.startswith(p)})


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_zero1_matches_jax(runs, run):
    """Losses and each rank's shard of every parameter after four steps
    against JAX's ``zero1=True`` step."""
    gang, jax_runs, _ = runs
    jlosses, jparams, _, _ = jax_runs[run]
    assert jlosses[-1] < jlosses[0]
    for r, out in enumerate(gang):
        np.testing.assert_allclose(out[f"{run}.zero1.losses"], jlosses,
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{run} rank {r}")
        want = convert.params_from_jax(jparams,
                                       mesh=_where(out, f"{run}.zero1"))
        for k, v in want.items():
            np.testing.assert_allclose(out[f"{run}.zero1.{k}"], v.numpy(),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{run} rank {r} {k}")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_zero1_matches_replicated_state(runs, run):
    """The port's ZeRO-1 losses are its replicated step's."""
    for r, out in enumerate(runs[0]):
        np.testing.assert_allclose(out[f"{run}.zero1.losses"],
                                   out[f"{run}.plain.losses"],
                                   rtol=SELF_RTOL, err_msg=f"rank {r}")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_moments_are_sharded_and_match_jax(runs, run):
    """Each rank holds 1/dp of each sharded parameter's moments (every
    parameter here has a dimension that dp divides, so all are sharded);
    gathered over dp they are JAX's."""
    gang, jax_runs, _ = runs
    _, _, jmu, jnu = jax_runs[run]
    dp = RUNS[run]["dp"]
    for r, out in enumerate(gang):
        where = _where(out, f"{run}.zero1")
        p = f"{run}.zero1.moment."
        shares = {k: float(v) for k, v in out.items()
                  if k.startswith(p) and k.endswith(".share")}
        names = {k[len(p) + 3:] for k in out if k.startswith(p + "mu.")
                 and not k.endswith(".share")}
        assert len(shares) == 2 * len(names) > 0
        assert set(shares.values()) == {1.0 / dp}
        for tag, tree in (("mu", jmu), ("nu", jnu)):
            want = convert.params_from_jax(tree, mesh=where)
            for k in names:
                np.testing.assert_allclose(
                    out[f"{p}{tag}.{k}"], want[k].numpy(), rtol=TOL,
                    atol=TOL, err_msg=f"{run} rank {r} {tag} {k}")


@pytest.mark.timeout(300)
def test_warnings_are_the_jax_packages(runs):
    """No dp axis > 1, and no dimension divisible by dp: each logs the
    JAX package's warning (and the state stays replicated)."""
    gang, _, jax_warn = runs
    assert jax_warn["no_dp"] and jax_warn["odd"]
    assert "no dp axis > 1" in jax_warn["no_dp"][0]
    assert "divisible by dp=4" in jax_warn["odd"][0]
    for out in gang:
        assert list(out["warn.no_dp"]) == jax_warn["no_dp"]
        assert list(out["warn.odd"]) == jax_warn["odd"]


def test_eligible_dimensions():
    """The first dimension no mesh axis splits and dp divides: under tp
    the heads and the FFN width are taken, so ``wq`` [D, H/tp, HD] and
    ``w_out`` [F/tp, D] shard their dimension 0, ``wo`` [H/tp, HD, D] its
    dimension 1, the vocabulary-split ``embed`` its dimension 1."""
    cfg = tfm.TransformerConfig(compute_dtype=torch.float32, **SMALL)
    dims = train._zero1_dims(cfg, SimpleNamespace(
        shape={"dp": 2, "tp": 2}, coords={"dp": 0, "tp": 0}))
    assert dims["embed"] == 1 and dims["ln_f"] == 0
    assert dims["layers.0.wq"] == 0 and dims["layers.0.wo"] == 1
    assert dims["layers.0.w_in"] == 0 and dims["layers.0.w_out"] == 1
