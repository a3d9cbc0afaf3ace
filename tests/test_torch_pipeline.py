"""The port's GPipe pipeline over ``pp`` against the JAX package's, on the
CPU.

Two gloo gangs run while the JAX side does: four processes for the meshes
``{"dp": 2, "pp": 2}`` (dense FFN, the Switch MoE FFN, and flash
attention, which the port's cells run at every dp and the JAX package's
run dense where dp > 1), ``{"tp": 2, "pp": 2}`` and ``pipeline_apply`` at pp 4 and at dp 2 x pp 2 with four
microbatches; two processes for ``{"pp": 2}``, ``pipeline_apply`` at pp 2
and the loopback (``make_pipeline_train_step(n_stages=2)``, every stage in
one process); and the unpipelined step on ``{"dp": 2, "pp": 2}``, where
the pp ranks are replicas.  The JAX side is ``horovod_tpu.parallel.pipeline`` on a CPU
mesh of as many devices, from the same initial weights (converted, each
rank keeping its stage's layers and its tp shard) and the same global
batch (numpy).

Small sizes: 2 layers (4 for pp 4), d_model 64, 4 heads, vocab 128, fp32;
three AdamW steps on a batch of 4 x 64 (M = pp: one row per dp rank and
microbatch at dp 2).  Tolerances: every rank's loss at every step, its
stage's shard of every parameter after the steps, and its step-0 gradients
of ``embed`` and ``ln_f`` (replicated over pp: a contribution counted on
every stage shows here) at 1e-4 of JAX's, as the other train-step
parity tests; logits at 2e-5, as the JAX package's own pipeline tests.
The loopback's losses and parameters at 1e-5 of the gang's.

JAX 0.9's ``scan`` refuses the JAX package's pipelined MoE step (its cell
starts the aux carry as a pp-invariant zero, which the MoE layer makes
pp-varying); the JAX side therefore runs with ``pipeline.lax.scan`` marking
the initial carry pp-varying (``lax.pcast``), an identity on every value.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel import train
from horovod_tpu_torch.parallel.mesh import make_mesh

from test_torch_train_tp import join_gang, load_tree, start_gang

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=64)
B, S = 4, 64
STEPS = 3
TOL = 1e-4
LOGIT_TOL = 2e-5
LOOP_TOL = 1e-5
# name -> (mesh axes, n_experts, attn_impl); steps of
# make_pipeline_train_step.
STEP_RUNS4 = {"dp2_pp2": ({"dp": 2, "pp": 2}, 0, "dense"),
              "dp2_pp2-moe": ({"dp": 2, "pp": 2}, 4, "dense"),
              "dp2_pp2-flash": ({"dp": 2, "pp": 2}, 0, "flash"),
              "tp2_pp2": ({"tp": 2, "pp": 2}, 0, "dense")}
STEP_RUNS2 = {"pp2": ({"pp": 2}, 0, "dense")}
# name -> (mesh axes, n_layers, n_microbatches); pipeline_apply on the
# apply batch.
APPLY_RUNS4 = {"pp4-apply": ({"pp": 4}, 4, None),
               "dp2_pp2-apply-mb4": ({"dp": 2, "pp": 2}, 2, 4)}
APPLY_RUNS2 = {"pp2-apply": ({"pp": 2}, 2, None)}
# The unpipelined make_transformer_train_step on a mesh with pp: replicas.
REPLICA_AXES = {"dp": 2, "pp": 2}
B_APPLY, S_APPLY = 8, 16


def _cfg(n_experts=0, **kw):
    return tfm.TransformerConfig(compute_dtype=torch.float32,
                                 **dict(SMALL, n_experts=n_experts, **kw))


def _slice(x, mesh):
    """This rank's P('dp', None) slice of a global batch."""
    dp, i = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    b = x.shape[0] // dp
    return torch.tensor(x[i * b:(i + 1) * b])


def _weights(d, n_experts, n_layers=2):
    return load_tree({k[len(f"w{n_experts}_{n_layers}."):]: v
                      for k, v in d.items()
                      if k.startswith(f"w{n_experts}_{n_layers}.")})


def _run_steps(runs, d, out):
    for name, (axes, ne, attn) in runs.items():
        mesh = make_mesh(axes)
        step_fn, init_fn = pl.make_pipeline_train_step(
            _cfg(ne, attn_impl=attn), mesh=mesh, device="cpu")
        state = init_fn(0)
        with torch.no_grad():
            state.model.load_state_dict(convert.params_from_jax(
                _weights(d, ne), mesh=mesh, pipeline=True))
        toks, tgts = _slice(d["toks"], mesh), _slice(d["tgts"], mesh)
        losses = []
        for step in range(STEPS):
            state, loss = step_fn(state, toks, tgts)
            losses.append(float(loss))
            if step == 0:
                for k in ("embed", "ln_f"):
                    out[f"{name}.grad.{k}"] = getattr(
                        state.model, k).grad.numpy().copy()
        out[f"{name}.losses"] = np.array(losses)
        for a, c in mesh.coords.items():
            out[f"{name}.coord.{a}"] = np.array(c)
        for k, v in state.model.state_dict().items():
            out[f"{name}.{k}"] = v.numpy()


def _run_apply(runs, d, out):
    for name, (axes, n_layers, M) in runs.items():
        mesh = make_mesh(axes)
        cfg = _cfg(n_layers=n_layers)
        model = pl.init_stage(0, cfg, device="cpu", mesh=mesh)
        with torch.no_grad():
            model.load_state_dict(convert.params_from_jax(
                _weights(d, 0, n_layers), mesh=mesh, pipeline=True))
            logits, _ = pl.pipeline_apply(model, _slice(d["apply"], mesh),
                                          mesh, n_microbatches=M)
        out[f"{name}.logits"] = logits.numpy()
        out[f"{name}.rows"] = np.array(pl.pipeline_rows(
            B_APPLY, mesh, n_microbatches=M))


def _worker(rank, size, store, data_path, out_dir):
    torch.set_num_threads(1)  # six ranks and the JAX side share the cores
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        d = dict(np.load(data_path))
        out = {}
        if size == 4:
            _run_steps(STEP_RUNS4, d, out)
            _run_apply(APPLY_RUNS4, d, out)
            mesh = make_mesh(REPLICA_AXES)
            step_fn, init_fn = train.make_transformer_train_step(
                _cfg(), mesh=mesh, device="cpu")
            state = init_fn(0)
            with torch.no_grad():
                state.model.load_state_dict(convert.params_from_jax(
                    _weights(d, 0), mesh=mesh))
            losses = []
            for _ in range(STEPS):
                state, loss = step_fn(state, _slice(d["toks"], mesh),
                                      _slice(d["tgts"], mesh))
                losses.append(float(loss))
            out["replicas.losses"] = np.array(losses)
            for k, v in state.model.state_dict().items():
                out[f"replicas.{k}"] = v.numpy()
        else:
            _run_steps(STEP_RUNS2, d, out)
            _run_apply(APPLY_RUNS2, d, out)
            # The loopback: both stages in this process, on the whole batch
            # (both ranks the same: data parallel over identical slices).
            step_fn, init_fn = pl.make_pipeline_train_step(
                _cfg(), n_stages=2, device="cpu")
            state = init_fn(0)
            with torch.no_grad():
                state.model.load_state_dict(
                    convert.params_from_jax(_weights(d, 0)))
            losses = []
            for _ in range(STEPS):
                state, loss = step_fn(state, torch.tensor(d["toks"]),
                                      torch.tensor(d["tgts"]))
                losses.append(float(loss))
            out["loopback.losses"] = np.array(losses)
            for k, v in state.model.state_dict().items():
                out[f"loopback.{k}"] = v.numpy()
        np.savez(f"{out_dir}/rank{size}_{rank}.npz", **out)
    finally:
        hvd.shutdown()


def _jax_cfg(n_experts=0, n_layers=2, attn_impl="dense"):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    return jtfm.TransformerConfig(
        compute_dtype=jnp.float32, attn_impl=attn_impl,
        **dict(SMALL, n_experts=n_experts, n_layers=n_layers))


@pytest.fixture(scope="module")
def jax_pipeline():
    """``horovod_tpu.parallel.pipeline`` with the initial scan carries
    marked pp-varying (see the module docstring)."""
    import jax
    from jax import lax

    from horovod_tpu.parallel import pipeline as jpl

    class _Lax:
        def __getattr__(self, name):
            return getattr(lax, name)

        @staticmethod
        def scan(f, init, xs=None, **kw):
            def vary(a):
                vma = getattr(jax.typeof(a), "vma", frozenset())
                return a if "pp" in vma else lax.pcast(a, "pp", to="varying")
            return lax.scan(f, jax.tree.map(vary, init), xs, **kw)

    real = jpl.lax
    jpl.lax = _Lax()
    yield jpl
    jpl.lax = real


def _jax_steps(jpl, devices, params0, cfg, axes, toks, tgts):
    """JAX's pipelined steps: (losses, final params, step-0 gradients)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh

    n = int(np.prod(list(axes.values())))
    mesh = jmesh.make_mesh(axes, devices=devices[:n])
    step, init = jpl.make_pipeline_train_step(cfg, mesh)
    state = init(jax.random.PRNGKey(0))
    state = state._replace(params=jax.device_put(
        jax.tree.map(jnp.asarray, params0),
        jax.tree.map(lambda a: a.sharding, state.params)))
    grads = jax.jit(jax.grad(jpl.pipeline_loss_fn), static_argnums=(3, 4))(
        state.params, jnp.asarray(toks), jnp.asarray(tgts), cfg, mesh)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(loss))
    return (losses, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, grads))


def _jax_apply(jpl, devices, params0, cfg, axes, toks, M):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh

    n = int(np.prod(list(axes.values())))
    mesh = jmesh.make_mesh(axes, devices=devices[:n])
    logits, _ = jpl.pipeline_apply(jax.tree.map(jnp.asarray, params0),
                                   jnp.asarray(toks), cfg, mesh,
                                   n_microbatches=M)
    return np.asarray(logits)


def _jax_replicas(devices, params0, toks, tgts):
    """JAX's unpipelined step on the replica mesh: (losses, params)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import train as jtrain

    mesh = jmesh.make_mesh(REPLICA_AXES, devices=devices[:4])
    step, init = jtrain.make_transformer_train_step(_jax_cfg(), mesh)
    state = init(jax.random.PRNGKey(0))
    state = state._replace(params=jax.device_put(
        jax.tree.map(jnp.asarray, params0),
        jax.tree.map(lambda a: a.sharding, state.params)))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def runs(eight_devices, jax_pipeline, tmp_path_factory):
    """The gangs' outputs (rank r of the four-process gang at key 4, r of
    the two-process one at 2), JAX's steps and logits, and the weights."""
    import jax

    from horovod_tpu.models import transformer as jtfm

    d = tmp_path_factory.mktemp("pipeline_gang")
    rs = np.random.RandomState(0)
    data = dict(toks=rs.randint(0, 128, (B, S)),
                tgts=rs.randint(0, 128, (B, S)),
                apply=rs.randint(0, 128, (B_APPLY, S_APPLY)))
    params = {}
    for ne, n_layers in ((0, 2), (4, 2), (0, 4)):
        params[ne, n_layers] = jax.tree.map(np.asarray, jtfm.init(
            jax.random.PRNGKey(ne + n_layers), _jax_cfg(ne, n_layers)))
        for k, v in params[ne, n_layers].items():
            if k == "layers":
                data.update({f"w{ne}_{n_layers}.layers.{n}": a
                             for n, a in v.items()})
            else:
                data[f"w{ne}_{n_layers}.{k}"] = v
    np.savez(d / "data.npz", **data)
    gangs = [start_gang(_worker, n, (n, str(d / f"store{n}"),
                                     str(d / "data.npz"), str(d)))
             for n in (4, 2)]
    try:
        jsteps = {name: _jax_steps(jax_pipeline, eight_devices,
                                   params[ne, 2], _jax_cfg(ne, 2, attn),
                                   axes, data["toks"], data["tgts"])
                  for name, (axes, ne, attn) in {**STEP_RUNS4,
                                                 **STEP_RUNS2}.items()}
        jreplicas = _jax_replicas(eight_devices, params[0, 2],
                                  data["toks"], data["tgts"])
        japply = {name: _jax_apply(jax_pipeline, eight_devices,
                                   params[0, n_layers], _jax_cfg(0, n_layers),
                                   axes, data["apply"], M)
                  for name, (axes, n_layers, M) in {**APPLY_RUNS4,
                                                    **APPLY_RUNS2}.items()}
    finally:
        for g in gangs:
            join_gang(g, timeout=240.0)
    out = {n: [dict(np.load(d / f"rank{n}_{r}.npz")) for r in range(n)]
           for n in (4, 2)}
    return out, jsteps, japply, params, data, jreplicas


def _view(out, run):
    p = run + "."
    coords = {k[len(p) + 6:]: int(v) for k, v in out.items()
              if k.startswith(p + "coord.")}
    return coords, {k[len(p):]: v for k, v in out.items()
                    if k.startswith(p) and not k.startswith(
                        (p + "coord.", p + "grad.", p + "losses"))}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(STEP_RUNS4) + list(STEP_RUNS2))
def test_train_step_matches_jax(runs, run):
    """Losses, each rank's stage shard after three steps, and the step-0
    gradients of the pp-replicated ``embed`` and ``ln_f``, against JAX's
    pipelined step on the same mesh."""
    from types import SimpleNamespace

    gangs, jsteps, _, _, _, _ = runs
    axes = {**STEP_RUNS4, **STEP_RUNS2}[run][0]
    gang = gangs[4 if run in STEP_RUNS4 else 2]
    jlosses, jparams, jgrads = jsteps[run]
    assert jlosses[-1] < jlosses[0]
    for r, out in enumerate(gang):
        coords, sd = _view(out, run)
        where = SimpleNamespace(shape=axes, coords=coords)
        np.testing.assert_allclose(out[f"{run}.losses"], jlosses, rtol=TOL,
                                   atol=TOL, err_msg=f"{run} rank {r}")
        want = convert.params_from_jax(jparams, mesh=where, pipeline=True)
        assert sorted(sd) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{run} rank {r} {k}")
        wgrad = convert.params_from_jax(jgrads, mesh=where, pipeline=True)
        for k in ("embed", "ln_f"):
            np.testing.assert_allclose(out[f"{run}.grad.{k}"],
                                       wgrad[k].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{run} rank {r} grad {k}")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(APPLY_RUNS4) + list(APPLY_RUNS2))
def test_apply_matches_jax_and_unpipelined(runs, run):
    """Each rank's logits for its rows (``pipeline_rows``) against JAX's
    ``pipeline_apply`` and against the port's unpipelined ``apply`` on the
    whole model; at dp 2 x pp 2 with four microbatches (the
    ``n_microbatches`` knob), each dp rank holds its row of each."""
    gangs, _, japply, params, data, _ = runs
    axes, n_layers, _ = {**APPLY_RUNS4, **APPLY_RUNS2}[run]
    gang = gangs[4 if run in APPLY_RUNS4 else 2]
    model = tfm.init(0, _cfg(n_layers=n_layers), device="cpu")
    model.load_state_dict(convert.params_from_jax(params[0, n_layers]))
    with torch.no_grad():
        plain, _ = tfm.apply(model, torch.tensor(data["apply"]))
    for r, out in enumerate(gang):
        rows = out[f"{run}.rows"]
        got = out[f"{run}.logits"]
        np.testing.assert_allclose(got, japply[run][rows], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"{run} rank {r}")
        np.testing.assert_allclose(got, plain.numpy()[rows], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"{run} rank {r}")
    if "dp2" in run:
        assert sorted(np.concatenate([o[f"{run}.rows"] for o in gang[::2]])
                      ) == list(range(B_APPLY))


@pytest.mark.timeout(300)
def test_loopback_matches_the_gang(runs):
    """``make_pipeline_train_step(n_stages=2)``, both stages in one
    process, against the two-process gang at ``{"pp": 2}``: losses and
    parameters (stage s's layers are the whole model's layers s)."""
    gangs, _, _, _, _, _ = runs
    for r, out in enumerate(gangs[2]):
        np.testing.assert_allclose(out["loopback.losses"], out["pp2.losses"],
                                   rtol=LOOP_TOL, atol=LOOP_TOL)
        coords, sd = _view(out, "pp2")
        for k, v in sd.items():
            if k.startswith("layers."):
                _, i, name = k.split(".")
                k = f"layers.{int(i) + coords['pp']}.{name}"
            np.testing.assert_allclose(out[f"loopback.{k}"], v,
                                       rtol=LOOP_TOL, atol=LOOP_TOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.timeout(300)
def test_unpipelined_step_over_pp_holds_replicas(runs):
    """``make_transformer_train_step`` on ``{"dp": 2, "pp": 2}``: as in the
    JAX package, whose ``param_specs`` name no ``pp``, the pp ranks hold
    the whole model and take the same batch slice; losses and parameters
    against JAX's step on that mesh."""
    gangs, _, _, _, _, (jlosses, jparams) = runs
    want = convert.params_from_jax(jparams)
    for r, out in enumerate(gangs[4]):
        np.testing.assert_allclose(out["replicas.losses"], jlosses,
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")
        assert sum(k.startswith("replicas.layers.") for k in out) == \
            len([k for k in want if k.startswith("layers.")])
        for k, v in want.items():
            np.testing.assert_allclose(out[f"replicas.{k}"], v.numpy(),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {k}")


def test_bubble_ticks_are_skipped_and_remat_recomputes():
    """Each stage runs its cell once per microbatch forward (bubble ticks
    skipped), and once more in the backward (each layer rematerialised):
    with 2 stages of 2 layers and 4 microbatches, 16 layer forwards, then
    16 recomputes."""
    from unittest import mock

    model = tfm.init(0, _cfg(n_layers=4), device="cpu")
    toks = torch.randint(0, 128, (8, 16), generator=torch.Generator()
                         .manual_seed(0))
    calls = []
    real = tfm._layer

    def count(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    with mock.patch.object(tfm, "_layer", count):
        loss = pl.pipeline_loss_fn(model, toks, torch.roll(toks, -1, 1),
                                   n_stages=2, n_microbatches=4)
        assert calls == [2] * 16
        loss.backward()
    assert calls == [2] * 32


def test_the_knobs_errors():
    """``n_layers % pp``, ``B % M`` and a microbatch that does not split
    over dp are ``ValueError``s, as is a step given both or neither of a
    mesh and ``n_stages``."""
    from types import SimpleNamespace

    model = tfm.init(0, _cfg(n_layers=3), device="cpu")
    toks = torch.zeros(4, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="n_layers"):
        pl.pipeline_apply(model, toks, SimpleNamespace(
            shape={"pp": 2}, coords={"pp": 0}))
    with pytest.raises(ValueError, match="n_layers"):
        pl.init_stage(0, _cfg(n_layers=3), device="cpu",
                      mesh=SimpleNamespace(shape={"pp": 2}, coords={"pp": 1}))
    model = tfm.init(0, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        pl.loopback_pipeline(model, toks[:3], 2)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        pl.pipeline_rows(4, SimpleNamespace(shape={"dp": 2, "pp": 2},
                                            coords={"dp": 0, "pp": 0}),
                         n_microbatches=4)
    for kw in ({}, dict(mesh=SimpleNamespace(shape={"pp": 2}), n_stages=2)):
        with pytest.raises(ValueError, match="either mesh"):
            pl.make_pipeline_train_step(_cfg(), device="cpu", **kw)


def test_stage_layers_and_specs():
    from types import SimpleNamespace

    mesh = SimpleNamespace(shape={"dp": 2, "pp": 4},
                           coords={"dp": 1, "pp": 2})
    assert pl.stage_layers(8, mesh) == range(4, 6)
    assert pl.stage_layers(8, None) == range(8)
    specs = pl.pipeline_param_specs(_cfg())
    assert specs["layers"]["wq"] == ("pp", None, "tp", None)
    assert specs["embed"] == ("tp", None)
