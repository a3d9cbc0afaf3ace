"""Adasum (``ops/adasum.py``, ``allreduce(op=ReduceOp.ADASUM)``) against
the JAX package's, on the CPU.

One four-process gloo gang, run while the JAX side does: ``allreduce`` with
``ADASUM`` over one axis (``{"dp": 4}``) and over two (``mesh.axis("dp",
"tp")`` of ``{"dp": 2, "tp": 2}``), in fp32 and bf16, with one rank's
gradient all zeros (the zero-norm guard); ``grouped_allreduce`` over a list
of fp32 and bf16 tensors (each dtype's fused buffer combined as one
vector); two SGD steps of ``DistributedOptimizer(op=ADASUM)``; and
``ppermute`` with a partial permutation, forward and backward.  The JAX
side is its in-graph ``allreduce``/``grouped_allreduce`` and
``DistributedOptimizer`` in a ``shard_map`` over four CPU devices, on the
same per-rank inputs (numpy, seeded).

Tolerances: fp32 results at rtol 1e-5, atol 1e-6 of JAX's (the two sum
the fp32 dot products and norms in different orders; a coefficient moves
by a few fp32 ulps), and of the float64 oracle; bf16 at rtol 2^-7 (one
bf16 ulp: both cast each round's fp32 combine to bf16, and a coefficient a
few fp32 ulps apart can round the other way), atol 1e-3.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel.mesh import make_mesh

from test_torch_train_tp import SIZE, join_gang, start_gang

SHAPE = (3, 5, 7)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-3)}
AXES = {"dp4": ({"dp": 4}, ("dp",)), "dp2_tp2": ({"dp": 2, "tp": 2},
                                                 ("dp", "tp"))}
LR = 0.1
STEPS = 2
PERM = [(0, 2), (1, 0), (2, 1)]


def _inputs():
    """Per rank: ``x[r]`` and ``zero[r]`` (rank 2's all zeros), the grouped
    tensors, and the optimizer's weights and inputs."""
    rs = np.random.RandomState(11)
    x = rs.randn(SIZE, *SHAPE).astype(np.float32)
    # Correlated gradients, as a model's usually are: a common direction
    # plus each rank's own.
    x += 2.0 * rs.randn(*SHAPE).astype(np.float32)
    zero = x.copy()
    zero[2] = 0.0
    grouped = [rs.randn(SIZE, 3, 4).astype(np.float32),
               rs.randn(SIZE, 5).astype(np.float32),
               rs.randn(SIZE, 6).astype(np.float32)]
    params = {"w": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    data = rs.randn(SIZE, STEPS, 5, 4).astype(np.float32)
    return x, zero, grouped, params, data


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


def _worker(rank, size, store, out_dir):
    torch.set_num_threads(1)
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        x, zero, grouped, params, data = _inputs()
        out = {}
        for name, (axes, names) in AXES.items():
            mesh = make_mesh(axes)
            axis = mesh.axis(*names)
            for tag, arr in (("x", x), ("zero", zero)):
                for dt in ("float32", "bfloat16"):
                    t = torch.tensor(arr[rank]).to(getattr(torch, dt))
                    y = C.allreduce(t, op=ReduceOp.ADASUM, axis=axis)
                    out[f"{name}.{tag}.{dt}"] = y.float().numpy()
        world = make_mesh({"dp": 4}).axis("dp")
        t = torch.tensor(x[rank])
        scaled = C.allreduce(t, op=ReduceOp.ADASUM, axis=world,
                             prescale_factor=3.0, postscale_factor=0.5)
        out["scaled_equal"] = np.array(torch.equal(
            scaled, C.allreduce(t, op=ReduceOp.ADASUM, axis=world)))
        ts = [torch.tensor(grouped[0][rank]), _bf16(grouped[1][rank]),
              torch.tensor(grouped[2][rank])]
        for i, y in enumerate(C.grouped_allreduce(ts, op=ReduceOp.ADASUM,
                                                  axis=world)):
            out[f"grouped.{i}"] = y.float().numpy()
        ps = {k: torch.nn.Parameter(torch.tensor(v))
              for k, v in params.items()}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([ps["w"], ps["b"]], lr=LR), op=ReduceOp.ADASUM,
            axis=world)
        for step in range(STEPS):
            opt.zero_grad()
            y = torch.tensor(data[rank, step]) @ ps["w"] + ps["b"]
            y.square().mean().backward()
            opt.step()
        out.update({f"opt.{k}": p.detach().numpy() for k, p in ps.items()})
        # ppermute with a partial permutation (index 3 sends and receives
        # nothing), and its backward: the inverse permutation.
        v = torch.full((3,), float(rank + 1), requires_grad=True)
        y = C.ppermute(v, world, PERM)
        (y * (rank + 1)).sum().backward()
        out["perm.y"], out["perm.grad"] = y.detach().numpy(), v.grad.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


def _jax_side(devices):
    """The same reductions through the JAX package, each output stacked
    over the four devices."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.common.types import ReduceOp as JOp
    from horovod_tpu.ops import collective as JC
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import optimizer as jopt
    from horovod_tpu.parallel.shard import shard_map

    x, zero, grouped, params, data = _inputs()
    out = {}

    def stacked(fn, mesh, *args, in_specs=None):
        spec = P(tuple(mesh.axis_names))
        f = shard_map(lambda *a: jax.tree.map(lambda o: o[None],
                                              fn(*[b[0] for b in a])),
                      mesh, in_specs=in_specs or (spec,) * len(args),
                      out_specs=spec)
        return jax.tree.map(np.asarray, jax.jit(f)(*args))

    for name, (axes, names) in AXES.items():
        mesh = jmesh.make_mesh(axes, devices=devices[:SIZE])
        for tag, arr in (("x", x), ("zero", zero)):
            for dt in ("float32", "bfloat16"):
                a = jnp.asarray(arr).astype(getattr(jnp, dt))
                y = stacked(lambda v: JC.allreduce(v, op=JOp.ADASUM,
                                                   axis=names), mesh, a)
                out[f"{name}.{tag}.{dt}"] = np.asarray(y, np.float32)
    mesh = jmesh.make_mesh({"dp": 4}, devices=devices[:SIZE])
    leaves = [jnp.asarray(grouped[0]),
              jnp.asarray(grouped[1]).astype(jnp.bfloat16),
              jnp.asarray(grouped[2])]
    red = stacked(lambda *v: JC.grouped_allreduce(list(v), op=JOp.ADASUM,
                                                  axis="dp"), mesh, *leaves)
    for i, y in enumerate(red):
        out[f"grouped.{i}"] = np.asarray(y, np.float32)

    opt = jopt.DistributedOptimizer(optax.sgd(LR), op=JOp.ADASUM, axis="dp")

    def loss(p, xs):
        return jnp.mean((xs @ p["w"] + p["b"]) ** 2)

    def body(p, state, xs):
        updates, state = opt.update(jax.grad(loss)(p, xs[0]), state, p)
        return optax.apply_updates(p, updates), state

    step = jax.jit(shard_map(body, mesh, in_specs=(P(), P(), P("dp")),
                             out_specs=(P(), P())))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for s in range(STEPS):
        p, state = step(p, state, jnp.asarray(data[:, s]))
    out.update({f"opt.{k}": np.asarray(v) for k, v in p.items()})
    return out


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    d = tmp_path_factory.mktemp("adasum_gang")
    ctx = start_gang(_worker, SIZE, (SIZE, str(d / "store"), str(d)))
    try:
        want = _jax_side(eight_devices)
    finally:
        join_gang(ctx, timeout=240.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)], want


def _close(got, want, dt, msg):
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def test_pair_matches_jax():
    """The pairwise combine, and its zero-norm guard (a coefficient of 1
    where a norm is zero: a plain sum)."""
    import jax.numpy as jnp

    from horovod_tpu.ops import adasum as jadasum

    rs = np.random.RandomState(3)
    a, b = rs.randn(2, 50).astype(np.float32)
    for a_, b_ in ((a, b), (np.zeros_like(a), b), (a, np.zeros_like(b))):
        ta, tb = torch.tensor(a_), torch.tensor(b_)
        stats = [torch.dot(ta, tb), torch.dot(ta, ta), torch.dot(tb, tb)]
        got = adasum.adasum_pair(ta, tb, *stats).numpy()
        ja, jb = jnp.asarray(a_), jnp.asarray(b_)
        want = jadasum.adasum_pair(ja, jb, jnp.vdot(ja, jb), jnp.vdot(ja, ja),
                                   jnp.vdot(jb, jb))
        _close(got, np.asarray(want), "float32", "pair")
    np.testing.assert_allclose(
        adasum.adasum_pair(torch.zeros(3), torch.ones(3), torch.tensor(0.0),
                           torch.tensor(0.0), torch.tensor(3.0)).numpy(),
        np.ones(3))


def test_oracle_is_the_jax_packages():
    from horovod_tpu.ops import adasum as jadasum

    x = _inputs()[0]
    np.testing.assert_array_equal(adasum.adasum_reduce_numpy(list(x)),
                                  jadasum.adasum_reduce_numpy(list(x)))
    np.testing.assert_array_equal(adasum.adasum_pair_numpy(x[0], x[1]),
                                  jadasum.adasum_pair_numpy(x[0], x[1]))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", ["x", "zero"])
@pytest.mark.parametrize("name", list(AXES))
def test_allreduce_matches_jax(runs, name, tag, dt):
    """Every rank's result against JAX's on its device (every rank gets
    the same), and the fp32 results against the float64 oracle."""
    gang, want = runs
    x, zero = _inputs()[:2]
    oracle = adasum.adasum_reduce_numpy(list(x if tag == "x" else zero))
    for r, out in enumerate(gang):
        got = out[f"{name}.{tag}.{dt}"]
        _close(got, want[f"{name}.{tag}.{dt}"][r], dt, f"rank {r}")
        np.testing.assert_array_equal(got, gang[0][f"{name}.{tag}.{dt}"])
        if dt == "float32":
            _close(got, oracle, dt, f"rank {r} against the oracle")


@pytest.mark.timeout(300)
def test_grouped_allreduce_combines_each_fused_buffer(runs):
    """``grouped_allreduce`` combines each dtype's fused buffer as one
    vector (JAX's result), which differs from combining each tensor
    alone."""
    gang, want = runs
    grouped = _inputs()[2]
    alone = adasum.adasum_reduce_numpy(list(grouped[0]))
    assert not np.allclose(gang[0]["grouped.0"], alone, rtol=1e-3)
    for r, out in enumerate(gang):
        for i, dt in enumerate(("float32", "bfloat16", "float32")):
            _close(out[f"grouped.{i}"], want[f"grouped.{i}"][r], dt,
                   f"rank {r} tensor {i}")


@pytest.mark.timeout(300)
def test_distributed_optimizer_adasum_matches_jax(runs):
    """Two SGD steps with Adasum-combined gradients; pre- and postscale
    are ignored under ADASUM, as in the JAX package."""
    gang, want = runs
    for r, out in enumerate(gang):
        assert bool(out["scaled_equal"])
        for k in ("w", "b"):
            _close(out[f"opt.{k}"], want[f"opt.{k}"], "float32",
                   f"rank {r} {k}")


@pytest.mark.timeout(300)
def test_ppermute_and_its_inverse(runs):
    """Rank d gets the vector of the rank s with (s, d) in the
    permutation, zeros where none sends; the gradient goes back the
    inverse way (the loss weighs rank d's output by d + 1)."""
    gang, _ = runs
    src = {d: s for s, d in PERM}
    dst = {s: d for s, d in PERM}
    for r, out in enumerate(gang):
        want_y = src[r] + 1.0 if r in src else 0.0
        want_g = dst[r] + 1.0 if r in dst else 0.0
        np.testing.assert_array_equal(out["perm.y"], np.full(3, want_y))
        np.testing.assert_array_equal(out["perm.grad"], np.full(3, want_g))


def test_loopback_and_sizes():
    """The loopback's virtual ranks get the gang's schedule (each row the
    oracle's result, all rows equal); a size that is not a power of two
    raises ``ValueError``, in the loopback and over an axis."""
    x = torch.tensor(_inputs()[0])
    got = adasum.adasum_loopback(x)
    assert all(torch.equal(got[0], g) for g in got)
    _close(got[0].numpy(), adasum.adasum_reduce_numpy(list(x.numpy())),
           "float32", "loopback")
    with pytest.raises(ValueError, match="power-of-two"):
        adasum.adasum_loopback(x[:3])
    three = SimpleNamespace(names=("dp",), size=3, index=0, ranks=(0, 1, 2),
                            group=None)
    with pytest.raises(ValueError, match="power-of-two"):
        adasum.adasum_allreduce(x[0], axis=three)
    with pytest.raises(ValueError, match="power-of-two"):
        adasum.adasum_reduce_numpy(list(x.numpy())[:3])


def test_ppermute_validates_its_permutation():
    axis = SimpleNamespace(names=("dp",), size=4, index=0,
                           ranks=(0, 1, 2, 3), group=None)
    for perm in ([(0, 1), (1, 1)], [(0, 4)], [(0, 1), (0, 2)]):
        with pytest.raises(ValueError, match="partial permutation"):
            C.ppermute(torch.zeros(2), axis, perm)
