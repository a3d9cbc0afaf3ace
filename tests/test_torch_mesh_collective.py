"""The port's mesh and collectives in a four-process gloo gang, against the
JAX package's on a four-device CPU mesh (``shard_map``).

The gang runs once per module (``gang`` fixture), two ranks per host
(``local_size=2``, so two hosts): each rank builds the meshes, runs every
collective and writes what it got; the tests run the JAX package's ops on
the same per-rank inputs (made with numpy) and compare rank by rank.  JAX
device ``r`` and port rank ``r`` hold the same input.  fp32; sums of four
values in other orders, so 1e-6.  The worker imports only torch and the
port at module level; JAX is imported inside the tests.
"""

import time
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.parallel.optimizer import allreduce_gradients


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
# The meshes of the gang, by name: their axes and sizes.
MESHES = {"dp2_sp2": {"dp": 2, "sp": 2}, "sp": {"sp": 4},
          "dcn2_dp2": {"dcn": 2, "dp": 2}}


def _x(name, rank, shape):
    rs = np.random.RandomState(zlib.crc32(f"{name}.{rank}".encode()))
    return rs.uniform(-2.0, 2.0, shape).astype(np.float32)


def _inputs(rank):
    return {"rs": _x("rs", rank, (4, 3)), "hier": _x("hier", rank, (5, 3)),
            "a2a": _x("a2a", rank, (4, 3)), "pp": _x("pp", rank, (3, 2)),
            "ppw": _x("ppw", rank, (3, 2)), "g0": _x("g0", rank, (3, 2)),
            "g1": _x("g1", rank, (5,)), "ar": _x("ar", rank, (2, 3))}


def _collective_worker(rank, size, store, out_dir):
    hvd.init(rank=rank, size=size, local_rank=rank % 2, local_size=2,
             device="cpu", init_method=f"file://{store}")
    try:
        out = {"cross": np.array([hvd.cross_rank(), hvd.cross_size()])}
        meshes = {"dp2_sp2": M.make_mesh({"dp": 2, "sp": 2}),
                  "sp": M.make_mesh({"sp": -1}),
                  "dcn2_dp2": M.make_hierarchical_mesh()}
        for name, mesh in meshes.items():
            out[f"{name}.shape"] = np.array(list(mesh.shape.values()))
            out[f"{name}.coords"] = np.array(list(mesh.coords.values()))
            for ax in mesh.axis_names:
                a = mesh.axis(ax)
                out[f"{name}.{ax}.ranks"] = np.array(a.ranks)
                out[f"{name}.{ax}.index"] = np.array(
                    [a.index, C.axis_index(a), C.axis_size(a)])
        x = {k: torch.tensor(v) for k, v in _inputs(rank).items()}
        dp_sp = meshes["dp2_sp2"]
        sp = meshes["sp"].axis("sp")
        hier = meshes["dcn2_dp2"]
        for op in (ReduceOp.SUM, ReduceOp.AVERAGE):
            out[f"rs.{op.name}"] = C.reduce_scatter(
                x["rs"], op, axis=dp_sp.axis("sp")).numpy()
            out[f"hier.{op.name}"] = C.hierarchical_allreduce(
                x["hier"], op, inner_axis=hier.axis("dp"),
                outer_axis=hier.axis("dcn")).numpy()
        out["a2a"] = C.alltoall(x["a2a"], axis=sp).numpy()
        out["a2a.dp"] = C.alltoall(x["a2a"], axis=dp_sp.axis("dp")).numpy()
        for shift in (1, -1):
            xp = x["pp"].clone().requires_grad_()
            y = C.ppermute_ring(xp, sp, shift)
            (y * x["ppw"]).sum().backward()
            out[f"pp.{shift}"] = y.detach().numpy()
            out[f"pp.{shift}.grad"] = xp.grad.numpy()
        both = hier.axis("dcn", "dp")
        leaves = [x["g0"], x["g1"]]
        for i, g in enumerate(C.grouped_allreduce(
                leaves, ReduceOp.AVERAGE, axis=both, hierarchical=True,
                outer_axis="dcn")):
            out[f"grouped.{i}"] = g.numpy()
        for i, g in enumerate(allreduce_gradients(
                leaves, axis=both, hierarchical=True)):
            out[f"grads.{i}"] = g.numpy()
        out["ar.dp"] = C.allreduce(x["ar"], ReduceOp.SUM,
                                   axis=dp_sp.axis("dp")).numpy()
        out["bcast.sp"] = C.broadcast(x["ar"], root_rank=1,
                                      axis=dp_sp.axis("sp")).numpy()
        out["gather.sp"] = C.allgather(x["ar"], axis=dp_sp.axis("sp")).numpy()
        C.barrier(axis=dp_sp.axis("dp"))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_collective_gang")
    _spawn_gang(_collective_worker, SIZE, (SIZE, str(d / "store"), str(d)),
                timeout=150.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)]


def _jax_mesh(eight_devices, axes):
    from horovod_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(axes, devices=eight_devices[:SIZE])


def _per_device(eight_devices, axes, fn, *names):
    """``fn`` on each JAX device of a mesh with ``axes``, device ``r`` given
    rank ``r``'s inputs ``names``; returns one numpy result per rank."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel.shard import shard_map

    mesh = _jax_mesh(eight_devices, axes)
    spec = P(tuple(axes))
    args = [jnp.stack([jnp.asarray(_inputs(r)[n]) for r in range(SIZE)])
            for n in names]
    out = shard_map(lambda *a: fn(*(t[0] for t in a))[None], mesh,
                    in_specs=(spec,) * len(args), out_specs=spec)(*args)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_places_ranks_where_jax_places_devices(eight_devices, gang,
                                                    name):
    """Rank r sits at the coordinates of device r in the JAX package's CPU
    mesh, and each axis groups the ranks JAX's mesh lines up along it.
    (On the CPU every JAX device reports one slice, so the two-host
    hierarchical mesh is held against ``make_mesh({"dcn": 2, "dp": 2})``,
    the layout of two slices of contiguous devices.)"""
    axes = MESHES[name]
    jm = _jax_mesh(eight_devices, axes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    rank_of = {d.id: r for r, d in enumerate(eight_devices[:SIZE])}
    for r, out in enumerate(gang):
        np.testing.assert_array_equal(out[f"{name}.shape"], ids.shape)
        at = np.argwhere(ids == eight_devices[r].id)[0]
        np.testing.assert_array_equal(out[f"{name}.coords"], at)
        for i, ax in enumerate(jm.axis_names):
            line = list(at)
            line[i] = slice(None)
            want = [rank_of[d] for d in ids[tuple(line)]]
            np.testing.assert_array_equal(out[f"{name}.{ax}.ranks"], want)
            idx, via_c, n = out[f"{name}.{ax}.index"]
            assert idx == via_c == at[i] and n == ids.shape[i]


def test_cross_rank_and_size_match_jax(gang, monkeypatch):
    from horovod_tpu import basics as jbasics

    for r, out in enumerate(gang):
        np.testing.assert_array_equal(out["cross"], [r // 2, 2])
        assert basics._discover(r, 4, r % 2, 2)[4:] == \
            jbasics._discover(r, 4, r % 2, 2, None, None)[4:]
    env = dict(HVD_RANK="5", HVD_SIZE="8", HVD_LOCAL_RANK="1",
               HVD_LOCAL_SIZE="2", HVD_CROSS_RANK="2", HVD_CROSS_SIZE="4")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert basics._discover(None, None, None, None) == \
        jbasics._discover(None, None, None, None, None, None) == \
        (5, 8, 1, 2, 2, 4)


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVERAGE],
                         ids=lambda o: o.name)
def test_reduce_scatter_matches_jax(eight_devices, gang, op):
    from horovod_tpu.common.types import ReduceOp as JOp
    from horovod_tpu.ops import collective as JC

    want = _per_device(eight_devices, MESHES["dp2_sp2"],
                       lambda x: JC.reduce_scatter(x, JOp(op), axis="sp"),
                       "rs")
    for r, out in enumerate(gang):
        assert out[f"rs.{op.name}"].shape == (2, 3)
        np.testing.assert_allclose(out[f"rs.{op.name}"], want[r], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVERAGE],
                         ids=lambda o: o.name)
def test_hierarchical_allreduce_with_padding_matches_jax(eight_devices, gang,
                                                         op):
    """Dim 0 of 5 over an inner axis of 2: padded to 6 and back."""
    from horovod_tpu.common.types import ReduceOp as JOp
    from horovod_tpu.ops import collective as JC

    want = _per_device(
        eight_devices, MESHES["dcn2_dp2"],
        lambda x: JC.hierarchical_allreduce(x, JOp(op), inner_axis="dp",
                                            outer_axis="dcn"), "hier")
    flat = sum(_inputs(r)["hier"] for r in range(SIZE))
    if op == ReduceOp.AVERAGE:
        flat = flat / SIZE
    for r, out in enumerate(gang):
        assert out[f"hier.{op.name}"].shape == (5, 3)
        np.testing.assert_allclose(out[f"hier.{op.name}"], want[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[f"hier.{op.name}"], flat, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh,axis,key", [("sp", "sp", "a2a"),
                                           ("dp2_sp2", "dp", "a2a.dp")])
def test_alltoall_matches_jax(eight_devices, gang, mesh, axis, key):
    from horovod_tpu.ops import collective as JC

    want = _per_device(eight_devices, MESHES[mesh],
                       lambda x: JC.alltoall(x, axis=axis), "a2a")
    for r, out in enumerate(gang):
        np.testing.assert_array_equal(out[key], want[r])


@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_ring_and_its_gradient_match_jax(eight_devices, gang, shift):
    """The value, and the gradient of sum(ppermute(x) * w) with respect to
    x: w sent the other way round the ring."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops import collective as JC
    from horovod_tpu.parallel.shard import shard_map

    want = _per_device(eight_devices, MESHES["sp"],
                       lambda x: JC.ppermute_ring(x, "sp", shift), "pp")
    mesh = _jax_mesh(eight_devices, MESHES["sp"])
    xs, ws = (jnp.stack([jnp.asarray(_inputs(r)[n]) for r in range(SIZE)])
              for n in ("pp", "ppw"))
    fn = shard_map(lambda x, w: JC.ppermute_ring(x, "sp", shift) * w, mesh,
                   in_specs=(P("sp"), P("sp")), out_specs=P("sp"))
    grad = np.asarray(jax.grad(lambda x: jnp.sum(fn(x, ws)))(xs))
    for r, out in enumerate(gang):
        np.testing.assert_array_equal(out[f"pp.{shift}"], want[r])
        np.testing.assert_array_equal(out[f"pp.{shift}.grad"], grad[r])
        np.testing.assert_array_equal(
            out[f"pp.{shift}.grad"], _inputs((r + shift) % SIZE)["ppw"])


def test_hierarchical_grouped_allreduce_matches_jax(eight_devices, gang):
    """The fused leaves through reduce-scatter, allreduce, all-gather (and
    through ``allreduce_gradients(hierarchical=True)``) against the JAX
    package's ``grouped_allreduce(hierarchical=True)``."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops import collective as JC
    from horovod_tpu.parallel.shard import shard_map

    mesh = _jax_mesh(eight_devices, MESHES["dcn2_dp2"])
    spec = P(("dcn", "dp"))
    leaves = [jnp.stack([jnp.asarray(_inputs(r)[n]) for r in range(SIZE)])
              for n in ("g0", "g1")]

    def body(a, b):
        red = JC.grouped_allreduce([a[0], b[0]], axis=("dcn", "dp"),
                                   hierarchical=True, outer_axis="dcn")
        return [t[None] for t in red]

    want = shard_map(body, mesh, in_specs=(spec, spec),
                     out_specs=[spec, spec])(*leaves)
    for r, out in enumerate(gang):
        for i in range(2):
            np.testing.assert_allclose(out[f"grouped.{i}"],
                                       np.asarray(want[i])[r], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_array_equal(out[f"grads.{i}"],
                                          out[f"grouped.{i}"])


def test_reductions_over_one_axis_match_jax(eight_devices, gang):
    """allreduce, broadcast and allgather over one axis of a dp x sp mesh:
    each reaches only the ranks along it."""
    from horovod_tpu.common.types import ReduceOp as JOp
    from horovod_tpu.ops import collective as JC

    axes = MESHES["dp2_sp2"]
    want = {
        "ar.dp": _per_device(eight_devices, axes, lambda x: JC.allreduce(
            x, JOp.SUM, axis="dp"), "ar"),
        "bcast.sp": _per_device(eight_devices, axes, lambda x: JC.broadcast(
            x, root_rank=1, axis="sp"), "ar"),
        "gather.sp": _per_device(eight_devices, axes, lambda x: JC.allgather(
            x, axis="sp"), "ar"),
    }
    for r, out in enumerate(gang):
        for key, w in want.items():
            np.testing.assert_allclose(out[key], w[r], rtol=1e-6, atol=1e-6,
                                       err_msg=key)


def test_ragged_alltoall_and_unordered_axes_raise():
    hvd.init(device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ragged"):
            C.alltoall(torch.zeros(2), splits=[1, 1])
        with pytest.raises(ValueError, match="divisible"):
            C.reduce_scatter(torch.zeros(3), axis=M.Axis(("x",), 2, 0,
                                                         (0, 1), None))
        with pytest.raises(ValueError, match="mesh's order"):
            C.allgather(torch.zeros(2), axis=M.Axis(("b", "a"), 2, 0,
                                                    (1, 0), None))
        with pytest.raises(ValueError, match="hierarchical"):
            allreduce_gradients([torch.zeros(2)], hierarchical=True)
    finally:
        hvd.shutdown()


def test_datatype_matches_jax():
    """The port's DataType has the JAX package's members, values, item sizes
    and numpy names, and maps to the torch dtype of the same name."""
    from horovod_tpu.common import types as JT

    assert [(m.name, int(m)) for m in T.DataType] == \
        [(m.name, int(m)) for m in JT.DataType]
    for m in T.DataType:
        jm = JT.DataType(int(m))
        assert m.itemsize == jm.itemsize
        assert T.dtype_to_numpy_name(m) == JT.dtype_to_numpy_name(jm)
        assert T.dtype_from_numpy(JT.dtype_to_numpy_name(jm)) == m
        assert T.dtype_from_torch(T.dtype_to_torch(m)) == m
    with pytest.raises(ValueError, match="dtype"):
        T.dtype_from_torch(torch.complex64)
