"""``DistributedOptimizer`` with parameters that receive no gradient,
against the JAX package's ``DistributedOptimizer`` over optax's ``adamw``.

In the JAX package every leaf of the parameter pytree has a gradient (zero
where the loss does not use it), so it is reduced and updated like any
other, and AdamW decays it.  In PyTorch an unused parameter's ``.grad`` is
None; the port reduces a zero gradient in its place.  A two-process gloo
gang, where ``u`` is used on rank 0 only and ``z`` on no rank, takes three
AdamW steps; JAX takes them on a ``{"dp": 2}`` mesh, where the loss
multiplies ``u``'s term by a per-device flag that is 0 on device 1.  fp32;
weights at 1e-6 (the two AdamW formulas add the same terms in another
order).  The same gang holds ``distributed_grad`` and
``distributed_value_and_grad`` (``torch.func`` gradients, averaged over
the ranks) against the JAX package's in a ``shard_map``, at 1e-6.  The
worker imports only torch and the port at module level; JAX is imported
inside the tests.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd

STEPS = 3
LR, WD = 0.05, 0.1
NAMES = ("w", "b", "u", "z")


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


def _data():
    """Initial weights, and each rank's inputs ``x[rank, step]``."""
    rs = np.random.RandomState(21)
    params = {"w": rs.randn(4, 3), "b": rs.randn(3), "u": rs.randn(3),
              "z": rs.randn(2)}
    x = rs.randn(2, STEPS, 5, 4)
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def _port_steps(rank, params, x):
    """STEPS steps of this rank's loss; ``u`` enters it on rank 0 only and
    ``z`` never.  Returns the final weights as numpy."""
    ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        [ps[k] for k in NAMES], lr=LR, weight_decay=WD))
    for step in range(STEPS):
        opt.zero_grad()
        y = torch.tensor(x[rank, step]) @ ps["w"] + ps["b"]
        loss = y.square().mean()
        if rank == 0:
            loss = loss + (y.mean(0) * ps["u"]).sum()
        loss.backward()
        assert ps["z"].grad is None and (ps["u"].grad is None) == (rank == 1)
        opt.step()
    return {k: p.detach().numpy() for k, p in ps.items()}


def _loss(p, xs):
    y = xs @ p["w"] + p["b"]
    return (y ** 2).mean() + (y.mean(0) * p["u"]).sum(), (y ** 2).sum()


def _port_grads(rank, params, x):
    """``distributed_grad`` (with respect to the weights and the inputs)
    and ``distributed_value_and_grad`` (with an aux) on this rank's first
    inputs; the values stay this rank's, the gradients are averaged."""
    p = {k: torch.tensor(v) for k, v in params.items()}
    xs = torch.tensor(x[rank, 0])
    gp, gx = hvd.distributed_grad(lambda p, xs: _loss(p, xs)[0],
                                  argnums=(0, 1))(p, xs)
    (val, aux), g2 = hvd.distributed_value_and_grad(_loss, has_aux=True)(
        p, xs)
    return {"dg.x": gx.numpy(), "val": val.numpy(), "aux": aux.numpy(),
            **{f"dg.{k}": v.numpy() for k, v in gp.items()},
            **{f"dvg.{k}": v.numpy() for k, v in g2.items()}}


def _gang_worker(rank, size, store, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        params, x = _data()
        np.savez(f"{out_dir}/rank{rank}.npz", **_port_steps(rank, params, x),
                 **_port_grads(rank, params, x))
    finally:
        hvd.shutdown()


def _jax_steps(eight_devices, params, x):
    """The same steps through the JAX package on a {"dp": 2} mesh."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import optimizer as jopt
    from horovod_tpu.parallel.shard import shard_map

    mesh = mesh_mod.make_mesh({"dp": 2}, devices=eight_devices[:2])
    opt = jopt.DistributedOptimizer(
        optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD),
        axis="dp")
    flag = jnp.asarray([1.0, 0.0])  # u's term: device 0 only

    def loss_fn(p, xs, f):
        y = xs @ p["w"] + p["b"]
        return jnp.mean(y ** 2) + f * jnp.sum(jnp.mean(y, 0) * p["u"])

    def body(p, state, xs, f):
        grads = jax.grad(loss_fn)(p, xs[0], f[0])
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    step = jax.jit(shard_map(body, mesh, in_specs=(P(), P(), P("dp"),
                                                   P("dp")),
                             out_specs=(P(), P())))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for s in range(STEPS):
        p, state = step(p, state, jnp.asarray(x[:, s]), flag)
    return {k: np.asarray(v) for k, v in p.items()}


def _jax_grads(eight_devices, params, x):
    """JAX's ``distributed_grad`` and ``distributed_value_and_grad`` in a
    ``shard_map`` over {"dp": 2}: (gradients, [values], [auxes])."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import optimizer as jopt
    from horovod_tpu.parallel.shard import shard_map

    mesh = mesh_mod.make_mesh({"dp": 2}, devices=eight_devices[:2])

    def loss(p, xs):
        y = xs @ p["w"] + p["b"]
        return (jnp.mean(y ** 2) + jnp.sum(jnp.mean(y, 0) * p["u"]),
                jnp.sum(y ** 2))

    def body(p, xs):
        gp, gx = jopt.distributed_grad(lambda p, xs: loss(p, xs)[0],
                                       axis="dp", argnums=(0, 1))(p, xs[0])
        (val, aux), g2 = jopt.distributed_value_and_grad(
            loss, axis="dp", has_aux=True)(p, xs[0])
        return gp, gx, g2, val[None], aux[None]

    f = jax.jit(shard_map(body, mesh, in_specs=(P(), P("dp")),
                          out_specs=(P(), P(), P(), P("dp"), P("dp"))))
    gp, gx, g2, val, aux = f({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x[:, 0]))
    grads = {"dg.x": np.asarray(gx),
             **{f"dg.{k}": np.asarray(v) for k, v in gp.items()},
             **{f"dvg.{k}": np.asarray(v) for k, v in g2.items()}}
    return grads, np.asarray(val), np.asarray(aux)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("optimizer_gang")
    _spawn_gang(_gang_worker, 2, (2, str(tmp / "store"), str(tmp)),
                timeout=180.0)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.timeout(240)
def test_distributed_grad_matches_jax(eight_devices, gang):
    """Gradients averaged over the two ranks, each rank's own value and
    aux, as the JAX package's (fp32, 1e-6)."""
    params, x = _data()
    grads, vals, auxes = _jax_grads(eight_devices, params, x)
    for r, out in enumerate(gang):
        for k, want in grads.items():
            np.testing.assert_allclose(out[k], want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(out["val"], vals[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out["aux"], auxes[r], rtol=1e-6,
                                   atol=1e-6)
    assert not np.allclose(gang[0]["val"], gang[1]["val"])


@pytest.mark.timeout(240)
def test_unused_parameters_reduce_and_update_as_jax(eight_devices, gang):
    params, x = _data()
    want = _jax_steps(eight_devices, params, x)
    outs = gang
    for k in NAMES:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
        np.testing.assert_allclose(outs[0][k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # z's gradient is zero everywhere: AdamW only decays it.
    np.testing.assert_allclose(outs[0]["z"],
                               params["z"] * (1 - LR * WD) ** STEPS,
                               rtol=1e-6)


def test_accumulated_passes_count_a_missing_gradient_as_zero():
    """With ``backward_passes_per_step=2`` a parameter used in one pass only
    steps on the mean of its gradient and a zero, as JAX's accumulator
    does; one never used is decayed."""
    hvd.init(device="cpu")
    try:
        a = torch.nn.Parameter(torch.ones(3))
        unused = torch.nn.Parameter(torch.ones(2))
        b = torch.nn.Parameter(torch.ones(3))
        opt_a = hvd.DistributedOptimizer(
            torch.optim.SGD([a, unused], lr=0.5, weight_decay=0.1),
            backward_passes_per_step=2)
        opt_b = hvd.DistributedOptimizer(torch.optim.SGD([b], lr=0.5,
                                                         weight_decay=0.1))
        g = torch.tensor([1.0, -2.0, 3.0])
        (a * g).sum().backward()
        assert opt_a.step() is None
        opt_a.zero_grad()
        opt_a.step()  # the second pass gives ``a`` no gradient
        (b * g / 2).sum().backward()
        opt_b.step()
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
        torch.testing.assert_close(unused.detach(), torch.full((2,), 0.95),
                                   rtol=0, atol=1e-7)
    finally:
        hvd.shutdown()
