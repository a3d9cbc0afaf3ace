"""The port's ResNet and MNIST steps over a mesh against the JAX package's,
on the CPU.

One four-process gloo gang, three steps of each from the JAX package's
initial weights (converted) on the same images (numpy), against JAX on a
four-device CPU mesh with the same axes:

* ``make_resnet_train_step_hvd(mesh={"dcn": 2, "dp": 2}, axis=("dp",))``:
  the batch splits over ``dp`` only and is replicated over ``dcn``;
  gradients, batch-norm statistics and the loss are averaged over ``dp``
  only (JAX: its ``shard_map`` step with the same mesh and axis);
* ``make_resnet_train_step(mesh={"dcn": 2, "dp": 2})``: batch norm over
  the ``dp`` halves (JAX: its jit step, the batch sharded over ``dp``);
* ``make_mnist_train_step(mesh={"dp": 2, "dcn": 2})`` (bf16, Adam).

The ResNet is ``tests/test_torch_resnet_train.py``'s (fp32, SGD(0.01,
momentum 0.9), 8 images of 64x64, the halves' statistics different) with
its tolerances; MNIST has ``tests/test_torch_mnist.py``'s three-step
tolerances (bf16 on 16 images).  Every rank ends with the same weights and
statistics.  The worker imports only torch and the port at module level;
JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.parallel import train
from horovod_tpu_torch.parallel.mesh import make_mesh

from test_torch_mnist import STEP_LOSS_TOL, STEP_TOL, _rel
from test_torch_mnist import _batch as mnist_batch
from test_torch_resnet_train import (SMALL, STEPS, _assert_run_close,
                                     _batch, _init_state, _sgd)
from test_torch_train_tp import join_gang, start_gang

SIZE = 4
RESNET_AXES = {"dcn": 2, "dp": 2}
MNIST_AXES = {"dp": 2, "dcn": 2}
BUILDERS = ("make_resnet_train_step_hvd", "make_resnet_train_step")


def _dp_half(x, mesh):
    n = x.shape[0] // mesh.shape["dp"]
    i = mesh.coords["dp"]
    return x[i * n:(i + 1) * n]


def _worker(rank, size, store, data_path, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        d = dict(np.load(data_path))
        out = {}
        mesh = make_mesh(RESNET_AXES)
        sd = {k[3:]: torch.from_numpy(v) for k, v in d.items()
              if k.startswith("sd.")}
        for builder in BUILDERS:
            kw = {"axis": ("dp",)} if builder.endswith("_hvd") else {}
            step_fn, init_fn = getattr(train, builder)(
                tr.ResNetConfig(compute_dtype=torch.float32, **SMALL), _sgd,
                mesh=mesh, device="cpu", **kw)
            state = init_fn(0)
            state.model.load_state_dict(sd)
            imgs, labels = (torch.tensor(_dp_half(d[k], mesh))
                            for k in ("imgs", "labels"))
            losses = []
            for _ in range(STEPS):
                state, loss = step_fn(state, imgs, labels)
                losses.append(loss.item())
            out[f"{builder}.losses"] = np.array(losses)
            for k, v in state.model.state_dict().items():
                out[f"{builder}.{k}"] = v.numpy().copy()
        mesh = make_mesh(MNIST_AXES)
        step_fn, init_fn = train.make_mnist_train_step(mesh=mesh,
                                                       device="cpu")
        state = init_fn(0)
        state.model.load_state_dict({k[6:]: torch.from_numpy(v)
                                     for k, v in d.items()
                                     if k.startswith("mnist.")})
        imgs, labels = (torch.tensor(_dp_half(d[k], mesh))
                        for k in ("mimgs", "mlabels"))
        losses = []
        for _ in range(STEPS):
            state, loss = step_fn(state, imgs, labels)
            losses.append(loss.item())
        out["mnist.losses"] = np.array(losses)
        for k, v in state.model.state_dict().items():
            out[f"mnist.{k}"] = v.numpy().copy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


def _jax_resnet(eight_devices, builder, imgs, labels):
    """JAX's builder on a {"dcn": 2, "dp": 2} mesh: (initial state, losses,
    final params and statistics as one flat dict of numpy)."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import resnet as jr
    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import optimizer as opt_mod
    from horovod_tpu.parallel import train as jtrain

    cfg = jr.ResNetConfig(compute_dtype=jnp.float32, **SMALL)
    mesh = mesh_mod.make_mesh(RESNET_AXES, devices=eight_devices[:SIZE])
    opt = optax.sgd(0.01, momentum=0.9)
    if builder.endswith("_hvd"):
        step, init = jtrain.make_resnet_train_step_hvd(
            cfg, mesh, opt_mod.DistributedOptimizer(opt, axis=("dp",)),
            axis=("dp",))
    else:
        step, init = jtrain.make_resnet_train_step(cfg, mesh, opt)
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
    return (params0, stats0), losses, {k: v.numpy() for k, v in final.items()}


def _jax_mnist(eight_devices, imgs, labels):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import train as jtrain

    mesh = mesh_mod.make_mesh(MNIST_AXES, devices=eight_devices[:SIZE])
    step, init = jtrain.make_mnist_train_step(mesh)
    state = init(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.array, state.params)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(imgs), jnp.asarray(labels))
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    d = tmp_path_factory.mktemp("resnet_mesh_gang")
    imgs, labels = _batch()
    mimgs, mlabels = mnist_batch(16)
    jax_runs = {b: _jax_resnet(eight_devices, b, imgs, labels)
                for b in BUILDERS[:1]}
    init0 = jax_runs[BUILDERS[0]][0]
    mparams0, *mnist_run = _jax_mnist(eight_devices, mimgs, mlabels)
    sd = convert.resnet_params_from_jax(*init0)
    np.savez(d / "data.npz", imgs=imgs, labels=labels, mimgs=mimgs,
             mlabels=mlabels,
             **{f"sd.{k}": v.numpy() for k, v in sd.items()},
             **{f"mnist.{k}": v.numpy() for k, v in
                convert.mnist_params_from_jax(mparams0).items()})
    ctx = start_gang(_worker, SIZE, (SIZE, str(d / "store"),
                                     str(d / "data.npz"), str(d)))
    try:
        for b in BUILDERS[1:]:
            jax_runs[b] = _jax_resnet(eight_devices, b, imgs, labels)
    finally:
        join_gang(ctx, timeout=240.0)
    gang = [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)]
    return gang, jax_runs, (mparams0, *mnist_run)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("builder", BUILDERS)
def test_resnet_steps_over_a_mesh_match_jax(runs, builder):
    gang, jax_runs, _ = runs
    init0, jlosses, jfinal = jax_runs[builder]
    start = _init_state(*init0)
    first = _init_state(*jax_runs[BUILDERS[0]][0])
    # Both JAX runs start from the state the gang was given.
    assert all(np.array_equal(v, first[k]) for k, v in start.items())
    p = builder + "."
    for r, out in enumerate(gang):
        for k in out:
            if k.startswith(p):
                np.testing.assert_array_equal(out[k], gang[0][k],
                                              err_msg=f"rank {r} {k}")
    final = {k[len(p):]: v for k, v in gang[0].items()
             if k.startswith(p) and k != p + "losses"}
    _assert_run_close(builder, gang[0][p + "losses"], final, jlosses, jfinal,
                      start)


@pytest.mark.timeout(300)
def test_the_hvd_step_reduces_over_dp_only(runs):
    """The hvd step's batch norms see each dp half, the jit step's the
    halves together: over the same mesh their first losses differ, as at
    two ranks without a mesh."""
    gang, _, _ = runs
    hvd_losses = gang[0]["make_resnet_train_step_hvd.losses"]
    jit_losses = gang[0]["make_resnet_train_step.losses"]
    assert abs(hvd_losses[0] - jit_losses[0]) > 0.02


@pytest.mark.timeout(300)
def test_mnist_steps_over_a_mesh_match_jax(runs):
    gang, _, (params0, jlosses, jparams) = runs
    for r, out in enumerate(gang):
        for k in out:
            if k.startswith("mnist."):
                np.testing.assert_array_equal(out[k], gang[0][k],
                                              err_msg=f"rank {r} {k}")
    losses = gang[0]["mnist.losses"]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_LOSS_TOL)
    got = convert.mnist_params_to_jax({k[6:]: torch.from_numpy(v)
                                       for k, v in gang[0].items()
                                       if k.startswith("mnist.")
                                       and k != "mnist.losses"})
    gaps = {k: _rel(got[k] - params0[k], np.asarray(v) - params0[k])
            for k, v in jparams.items()}
    assert max(gaps.values()) < STEP_TOL, gaps
