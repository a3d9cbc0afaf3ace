"""The port's ResNet training steps against the JAX package's, on the CPU.

A small ResNet (blocks (1, 1, 1, 1), width 8, 10 classes, fp32) from the
JAX package's ``init`` weights, converted, takes three steps of
SGD(0.01, momentum 0.9) (``bench.py``'s optimizer) on 8 images of 64x64
made with numpy, the first half scaled by 3, so that the two halves have
different batch statistics:

* one process against JAX on a ``{"dp": 1}`` mesh, for
  ``make_resnet_train_step`` and ``make_resnet_train_step_hvd`` (the same
  step at one rank) and the latter with ``Compression.fp16``;
* a two-process gloo gang, one half per rank, against JAX on a ``{"dp":
  2}`` mesh.  ``make_resnet_train_step`` must match JAX's jit step, whose
  batch norms see the global batch; ``make_resnet_train_step_hvd`` JAX's
  ``shard_map`` step, whose batch norms see each rank's half and whose
  running statistics are averaged after the step.  Losses, parameters and
  statistics must be identical on both ranks.

Tolerances.  Losses at ``LOSS_TOL``; every parameter and statistic within
``STATE_TOL`` times the largest change that tensor saw over the three steps
in JAX (a bias that moved by 1e-3 is held to its movement, not to the
weights' scale).  Measured, fp32: losses within 4e-7; states within 1.7e-4
of their movement at dp 1 and with per-rank statistics at dp 2, 6.5e-3 with
global statistics at dp 2, where JAX's own dp 1 and dp 2 steps are 1.7e-4
apart.  The first step agrees to 3e-4 of the movement in every case; the
later steps amplify summation-order differences (see below).  With
``Compression.fp16`` the gradients cross the wire in bf16 on both sides,
and a gradient that the two sides round to neighbouring bf16 values sends
its parameter another way: losses within 3.3e-4, states within 0.10 of
their movement at dp 1 and 1.3e-2 at dp 2.  The tolerances are about twice
the largest of these.

Batch norm over a few images makes this model's steps sensitive to the
last bits of the weights, the more so the larger the step: at the JAX
package's default learning rate of 0.1, a relative change of 1e-6 in the
JAX package's own initial weights moves its parameters by 4% after one step
and by 100% after three, so no port could be held to it there.  The
default optimizers are checked on their own against optax.  JAX is imported
inside the tests only.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.parallel import train

from test_torch_train import _spawn_gang

SMALL = dict(blocks=(1, 1, 1, 1), width=8, num_classes=10)
STEPS = 3
LR = 0.01
BUILDERS = ("make_resnet_train_step", "make_resnet_train_step_hvd",
            "make_resnet_train_step_hvd/fp16")
LOSS_TOL = {"": 1e-4, "fp16": 1e-3}
STATE_TOL = {"": 2e-2, "fp16": 0.25}


def _sgd(params):
    return torch.optim.SGD(params, lr=LR, momentum=0.9)


def _batch(B=8, hw=64):
    rs = np.random.RandomState(0)
    imgs = rs.rand(B, hw, hw, 3).astype(np.float32)
    imgs[:B // 2] *= 3
    return imgs, rs.randint(0, 10, (B,))


def _run_port(builder, params, stats, imgs, labels):
    """STEPS steps of ``builder`` from the given weights on this rank's
    batch; returns (losses, final state_dict as numpy)."""
    name, _, comp = builder.partition("/")
    kw = {"compression": hvd.Compression.fp16} if comp else {}
    step_fn, init_fn = getattr(train, name)(
        tr.ResNetConfig(compute_dtype=torch.float32, **SMALL), _sgd,
        device="cpu", **kw)
    state = init_fn(0)
    state.model.load_state_dict(convert.resnet_params_from_jax(params, stats))
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, torch.tensor(imgs), torch.tensor(labels))
        losses.append(loss.item())
    assert state.step == STEPS
    return losses, {k: v.numpy().copy()
                    for k, v in state.model.state_dict().items()}


def _run_jax(eight_devices, builder, dp, imgs, labels):
    """JAX's builder on a {"dp": dp} mesh: (initial params, stats, losses,
    final params and stats as one flat dict of numpy)."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import resnet as jr
    from horovod_tpu.ops.compression import Compression
    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import optimizer as opt_mod
    from horovod_tpu.parallel import train as jtrain

    cfg = jr.ResNetConfig(compute_dtype=jnp.float32, **SMALL)
    mesh = mesh_mod.make_mesh({"dp": dp}, devices=eight_devices[:dp])
    name, _, comp = builder.partition("/")
    opt = optax.sgd(LR, momentum=0.9)
    if name.endswith("_hvd"):
        opt = opt_mod.DistributedOptimizer(
            opt, axis=("dp",),
            compression=Compression.fp16 if comp else Compression.none)
    step, init = getattr(jtrain, name)(cfg, mesh, opt)
    state = init(jax.random.PRNGKey(0))
    params0, stats0 = jax.tree.map(np.array, (state.params,
                                              state.batch_stats))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(imgs), jnp.asarray(labels))
        losses.append(float(loss))
    final = convert.resnet_params_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats))
    return params0, stats0, losses, {k: v.numpy() for k, v in final.items()}


def _assert_run_close(builder, losses, final, jlosses, jfinal, init):
    """Losses and every tensor of the final state against JAX's (see the
    module's tolerances); ``init`` is the state both started from."""
    comp = builder.partition("/")[2]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL[comp],
                               atol=LOSS_TOL[comp], err_msg=builder)
    assert sorted(final) == sorted(jfinal)
    for k, want in jfinal.items():
        moved = np.abs(want - init[k]).max()
        assert moved > 0, k
        err = np.abs(final[k] - want).max()
        assert err <= STATE_TOL[comp] * moved, (
            f"{builder}: {k} is {err:.3e} from JAX's, "
            f"{err / moved:.3e} of its movement {moved:.3e}")


def _init_state(params, stats):
    return {k: v.numpy() for k, v in
            convert.resnet_params_from_jax(params, stats).items()}


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("builder", BUILDERS)
def test_three_steps_match_jax_single_process(eight_devices, one_rank,
                                              builder):
    imgs, labels = _batch()
    params0, stats0, jlosses, jfinal = _run_jax(eight_devices, builder, 1,
                                                imgs, labels)
    losses, final = _run_port(builder, params0, stats0, imgs, labels)
    assert losses[-1] < losses[0]
    _assert_run_close(builder, losses, final, jlosses, jfinal,
                      _init_state(params0, stats0))


def _gang_worker(rank, size, store, data_path, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        d = dict(np.load(data_path))
        sd = {k[3:]: v for k, v in d.items() if k.startswith("sd.")}
        params, stats = convert.resnet_params_to_jax(
            {k: torch.from_numpy(v) for k, v in sd.items()})
        per = d["imgs"].shape[0] // size
        sl = slice(rank * per, (rank + 1) * per)
        for i, builder in enumerate(BUILDERS):
            losses, final = _run_port(builder, params, stats, d["imgs"][sl],
                                      d["labels"][sl])
            np.savez(f"{out_dir}/rank{rank}_{i}.npz", losses=np.array(losses),
                     **final)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def gang_dp2(eight_devices, tmp_path_factory):
    """Each builder's JAX run at dp 2 and the port's two ranks, from the
    same weights: {builder: (JAX losses, JAX final, [rank outputs],
    initial state)}."""
    tmp = tmp_path_factory.mktemp("gang")
    imgs, labels = _batch()
    jax_runs = {b: _run_jax(eight_devices, b, 2, imgs, labels)
                for b in BUILDERS}
    params0, stats0 = jax_runs[BUILDERS[0]][:2]
    sd = convert.resnet_params_from_jax(params0, stats0)
    data = tmp / "data.npz"
    np.savez(data, imgs=imgs, labels=labels,
             **{f"sd.{k}": v.numpy() for k, v in sd.items()})
    _spawn_gang(_gang_worker, 2, (2, str(tmp / "store"), str(data),
                                  str(tmp)), timeout=180.0)
    out = {}
    for i, b in enumerate(BUILDERS):
        ranks = [dict(np.load(tmp / f"rank{r}_{i}.npz")) for r in range(2)]
        out[b] = (jax_runs[b][2], jax_runs[b][3], ranks,
                  _init_state(params0, stats0))
    return out


@pytest.mark.timeout(240)
@pytest.mark.parametrize("builder", BUILDERS)
def test_two_rank_gloo_gang_matches_jax_dp2(gang_dp2, builder):
    jlosses, jfinal, ranks, init = gang_dp2[builder]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    final = {k: v for k, v in ranks[0].items() if k != "losses"}
    _assert_run_close(builder, ranks[0]["losses"], final, jlosses, jfinal,
                      init)


@pytest.mark.timeout(240)
def test_the_two_steps_differ_at_two_ranks(gang_dp2):
    """Global-batch statistics against each rank's own: the halves differ,
    and so do the losses from the first step on."""
    glob = gang_dp2["make_resnet_train_step"][2][0]["losses"]
    local = gang_dp2["make_resnet_train_step_hvd"][2][0]["losses"]
    assert abs(glob[0] - local[0]) > 0.02, (glob, local)


def _optax_params(opt, grads, p0):
    import jax.numpy as jnp
    import optax

    p = jnp.asarray(p0)
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
    return np.asarray(p)


@pytest.mark.parametrize("name", ["resnet_sgd", "mnist_adam"])
def test_default_optimizers_match_optax(name):
    """``optax.sgd(0.1, momentum=0.9)`` and ``optax.adam(1e-3)``, the JAX
    builders' defaults, over three steps of the same gradients."""
    import optax

    rs = np.random.RandomState(0)
    p0 = rs.randn(64).astype(np.float32)
    grads = [rs.randn(64).astype(np.float32) for _ in range(3)]
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = getattr(train, name)([p])
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    want = _optax_params(optax.sgd(0.1, momentum=0.9) if name == "resnet_sgd"
                         else optax.adam(1e-3), grads, p0)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_step_writes_the_stats_once_and_returns_the_loss(one_rank):
    """At one rank the step's loss is ``loss_fn`` of the model before the
    update, and its buffers end as ``loss_fn``'s new statistics, also with
    remat (whose blocks run again in the backward pass)."""
    imgs, labels = (torch.tensor(a) for a in _batch(4, 32))
    for remat in (False, True):
        cfg = tr.ResNetConfig(compute_dtype=torch.float32, remat=remat,
                              **SMALL)
        step_fn, init_fn = train.make_resnet_train_step_hvd(cfg, _sgd,
                                                            device="cpu")
        state = init_fn(0)
        with torch.no_grad():
            want, new = tr.loss_fn(state.model, imgs, labels)
        state, loss = step_fn(state, imgs, labels)
        assert loss.shape == () and not loss.requires_grad
        torch.testing.assert_close(loss, want, rtol=0, atol=0)
        for name, value in new.items():
            torch.testing.assert_close(state.model.get_buffer(name), value,
                                       rtol=0, atol=0)
