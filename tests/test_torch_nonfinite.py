"""The port's non-finite gradient guard against the JAX package's, on the
CPU.

Unit: policy resolution and its errors, as ``tests/test_integrity.py``
holds the JAX package's (``HVD_NONFINITE_POLICY``, ``HVD_NONFINITE_LIMIT``,
the explicit argument first), each case against the JAX package's own
answer.

One four-process gloo gang (two ranks per host, so
``make_hierarchical_mesh()`` is dcn 2 x dp 2) runs every scenario with
``DistributedOptimizer(AdamW)`` on the same gradients, given per rank and
step (numpy), with non-finite entries planted on one rank:

* ``skip``: the bad step leaves every parameter and the AdamW state bit
  for bit as they were, on every rank, and the guard counts one skip; the
  three steps end at JAX's in-graph guard's (``shard_map`` over
  ``{"dp": 4}``) at 1e-6;
* ``zero``: the non-finite entries reduce as zeros; three steps against
  JAX's in-graph ``zero`` at 1e-6;
* ``raise`` (limit 2): every rank raises ``NonFiniteGradientError`` at the
  same step, the second bad one in a row (the port is eager, so ``raise``
  runs with any axis);
* ``hierarchical=True`` over ``mesh.axis("dcn", "dp")``: a NaN on one rank
  of one dcn slice skips the step on all four ranks (the JAX counterpart is
  ``tests/test_integrity.py::test_guarded_hierarchical_agreement_spans_dcn``);
* ``off`` issues exactly the gradient allreduce (one collective per dtype)
  and ``skip`` exactly one more, the agreement.

fp32; AdamW(0.05, weight decay 0.1).  The worker imports only torch and
the port at module level; JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.integrity import nonfinite as nf
from horovod_tpu_torch.parallel.mesh import make_hierarchical_mesh

from test_torch_train_tp import join_gang, start_gang

SIZE = 4
STEPS = 3
LR, WD = 0.05, 0.1
NAMES = ("w", "b")


def _data():
    """Initial weights, and the gradients of each scenario as
    ``{name: [rank, step, ...]}``."""
    rs = np.random.RandomState(7)
    params = {"w": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    g = {k: rs.randn(SIZE, STEPS, *v.shape).astype(np.float32)
         for k, v in params.items()}
    skip = {k: v.copy() for k, v in g.items()}
    skip["w"][1, 1, 0, 0] = np.nan                # rank 1, step 1
    zero = {k: v.copy() for k, v in g.items()}
    zero["w"][2, 0, 1] = [np.nan, np.inf, -np.inf]  # rank 2, step 0
    zero["b"][0, 2, 2] = np.nan                     # rank 0, step 2
    raise_ = {k: v.copy() for k, v in g.items()}
    raise_["b"][3, 1, 0] = np.inf                 # rank 3, steps 1 and 2
    raise_["w"][3, 2, 2, 1] = np.nan
    hier = {k: v.copy() for k, v in g.items()}
    hier["b"][0, 0, 1] = np.nan                   # rank 0 (dcn 0), step 0
    return params, {"skip": skip, "zero": zero, "raise": raise_,
                    "hier": hier, "clean": g}


def _steps(rank, params, grads, out, tag, steps=STEPS, **kw):
    """``steps`` steps of DistributedOptimizer(AdamW, **kw) on this rank's
    gradients; records the weights after each step, the AdamW state and
    the guard's counters under ``tag``; returns the step that raised, or
    -1."""
    ps = [torch.nn.Parameter(torch.tensor(params[k])) for k in NAMES]
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(ps, lr=LR, weight_decay=WD), **kw)
    raised = -1
    for step in range(steps):
        for p, k in zip(ps, NAMES):
            p.grad = torch.tensor(grads[k][rank, step])
        try:
            opt.step()
        except nf.NonFiniteGradientError:
            raised = step
            break
        for p, k in zip(ps, NAMES):
            out[f"{tag}.{k}.{step}"] = p.detach().numpy().copy()
            st = opt.inner.state.get(p, {})
            for s in ("exp_avg", "exp_avg_sq"):
                if s in st:
                    out[f"{tag}.{k}.{s}.{step}"] = st[s].numpy().copy()
    if opt.guard is not None:
        out[f"{tag}.skipped"] = np.array(opt.guard.skipped)
        out[f"{tag}.nonfinite_steps"] = np.array(opt.guard.nonfinite_steps)
    out[f"{tag}.raised"] = np.array(raised)
    return raised


def _count_allreduces(rank, params, grads, policy):
    """How many allreduces one guarded step issues."""
    calls = []
    real = dist.all_reduce

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    dist.all_reduce = spy
    try:
        _steps(rank, params, grads, {}, "count", steps=1,
               nonfinite_policy=policy)
    finally:
        dist.all_reduce = real
    return len(calls)


def _worker(rank, size, store, out_dir):
    hvd.init(rank=rank, size=size, local_rank=rank % 2, local_size=2,
             device="cpu", init_method=f"file://{store}")
    try:
        params, grads = _data()
        out = {}
        for policy in ("skip", "zero"):
            _steps(rank, params, grads[policy], out, policy,
                   nonfinite_policy=policy)
        _steps(rank, params, grads["raise"], out, "raise",
               nonfinite_guard=nf.NonFiniteGuard("raise", limit=2))
        mesh = make_hierarchical_mesh()
        _steps(rank, params, grads["hier"], out, "hier",
               axis=mesh.axis("dcn", "dp"), hierarchical=True,
               nonfinite_policy="skip")
        out["coords"] = np.array([mesh.coords["dcn"], mesh.coords["dp"]])
        for policy in ("off", "skip"):
            out[f"allreduces.{policy}"] = np.array(_count_allreduces(
                rank, params, grads["clean"], policy))
        out["counters"] = np.array([nf.counters()["agreed"],
                                    nf.counters()["skipped"]])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


def _jax_steps(eight_devices, params, grads, policy):
    """The same steps through the JAX package's in-graph guard on a
    {"dp": 4} mesh: the weights after each step."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import optimizer as jopt
    from horovod_tpu.parallel.shard import shard_map

    mesh = mesh_mod.make_mesh({"dp": SIZE}, devices=eight_devices[:SIZE])
    opt = jopt.DistributedOptimizer(
        optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD),
        axis="dp", nonfinite_policy=policy)

    def body(p, state, g):
        updates, state = opt.update({k: v[0] for k, v in g.items()}, state,
                                    p)
        return optax.apply_updates(p, updates), state

    step = jax.jit(shard_map(body, mesh, in_specs=(P(), P(), P("dp")),
                             out_specs=(P(), P())))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    after = []
    for s in range(STEPS):
        p, state = step(p, state, {k: jnp.asarray(v[:, s])
                                   for k, v in grads.items()})
        after.append({k: np.asarray(v) for k, v in p.items()})
    return after


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("nonfinite_gang")
    ctx = start_gang(_worker, SIZE, (SIZE, str(d / "store"), str(d)))
    join_gang(ctx, timeout=120.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SIZE)]


@pytest.mark.parametrize("policy, env, want", [
    (None, None, "off"), (None, "SKIP", "skip"), ("zero", "skip", "zero"),
    (None, " Raise ", "raise"), (None, "", "off"), ("bogus", None, None),
    (None, "bogus", None)])
def test_policy_resolution_matches_jax(monkeypatch, policy, env, want):
    from horovod_tpu.integrity import nonfinite as jnf

    if env is None:
        monkeypatch.delenv("HVD_NONFINITE_POLICY", raising=False)
    else:
        monkeypatch.setenv("HVD_NONFINITE_POLICY", env)
    if want is None:
        for mod in (nf, jnf):
            with pytest.raises(ValueError, match="unknown non-finite policy"):
                mod.resolve_policy(policy)
    else:
        assert nf.resolve_policy(policy) == jnf.resolve_policy(policy) == want


def test_limit_and_guard_errors(monkeypatch):
    from horovod_tpu.integrity import nonfinite as jnf

    monkeypatch.delenv("HVD_NONFINITE_LIMIT", raising=False)
    assert nf.consecutive_limit() == jnf.consecutive_limit() == 3
    monkeypatch.setenv("HVD_NONFINITE_LIMIT", "5")
    assert nf.consecutive_limit() == 5 and nf.consecutive_limit(2) == 2
    assert nf.NonFiniteGuard("raise").limit == 5
    with pytest.raises(ValueError):
        nf.consecutive_limit(0)
    with pytest.raises(ValueError, match="contradiction"):
        nf.NonFiniteGuard("off")
    err = nf.NonFiniteGradientError(3, 3)
    assert isinstance(err, RuntimeError) and "3 consecutive" in str(err)


def test_env_arms_a_users_optimizer_only(monkeypatch):
    """``HVD_NONFINITE_POLICY`` arms ``DistributedOptimizer`` (and
    ``make_resnet_train_step_hvd``, which builds one with the default);
    an explicit ``off`` (what the transformer, jit-ResNet and MNIST steps
    pass) keeps it unarmed."""
    monkeypatch.setenv("HVD_NONFINITE_POLICY", "zero")
    p = [torch.zeros(2, requires_grad=True)]
    assert hvd.DistributedOptimizer(torch.optim.SGD(p, lr=1.0)
                                    ).guard.policy == "zero"
    assert hvd.DistributedOptimizer(torch.optim.SGD(p, lr=1.0),
                                    nonfinite_policy="off").guard is None


@pytest.mark.timeout(240)
@pytest.mark.parametrize("policy", ["skip", "zero"])
def test_guard_matches_jax_in_graph_guard(eight_devices, gang, policy):
    params, grads = _data()
    want = _jax_steps(eight_devices, params, grads[policy], policy)
    for r, out in enumerate(gang):
        for s in range(STEPS):
            for k in NAMES:
                np.testing.assert_allclose(
                    out[f"{policy}.{k}.{s}"], want[s][k], rtol=1e-6,
                    atol=1e-6, err_msg=f"{policy} rank {r} step {s} {k}")
                np.testing.assert_array_equal(out[f"{policy}.{k}.{s}"],
                                              gang[0][f"{policy}.{k}.{s}"])
    assert all(np.isfinite(out[f"{policy}.w.{STEPS - 1}"]).all()
               for out in gang)


@pytest.mark.timeout(240)
def test_skip_leaves_params_and_state_bit_identical(gang):
    """Step 1 is bad on rank 1: after it every rank's weights and AdamW
    moments are those after step 0, bit for bit."""
    for r, out in enumerate(gang):
        for k in NAMES:
            for s in ("", ".exp_avg", ".exp_avg_sq"):
                np.testing.assert_array_equal(out[f"skip.{k}{s}.1"],
                                              out[f"skip.{k}{s}.0"],
                                              err_msg=f"rank {r} {k}{s}")
            assert not np.array_equal(out[f"skip.{k}.2"], out[f"skip.{k}.1"])
        assert int(out["skip.skipped"]) == 1
        assert int(out["skip.nonfinite_steps"]) == 1
        assert int(out["zero.skipped"]) == 0
        assert int(out["zero.nonfinite_steps"]) == 2


@pytest.mark.timeout(240)
def test_raise_fires_on_every_rank_after_the_limit(gang):
    for r, out in enumerate(gang):
        assert int(out["raise.raised"]) == 2, f"rank {r}"
        assert int(out["raise.skipped"]) == 2
        np.testing.assert_array_equal(out["raise.w.1"], out["raise.w.0"])


@pytest.mark.timeout(240)
def test_hierarchical_agreement_spans_dcn(gang):
    """A NaN on rank 0 (dcn 0, dp 0) skips step 0 on both slices: every
    rank's weights after it are the initial ones."""
    params, _ = _data()
    assert sorted(tuple(out["coords"]) for out in gang) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r, out in enumerate(gang):
        for k in NAMES:
            np.testing.assert_array_equal(out[f"hier.{k}.0"], params[k],
                                          err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(out[f"hier.{k}.2"],
                                          gang[0][f"hier.{k}.2"])
        assert int(out["hier.skipped"]) == 1


@pytest.mark.timeout(240)
def test_off_adds_no_collective(gang):
    """The zero-cost pin: ``off`` issues the gradient allreduce only (one
    fused buffer, one dtype); ``skip`` adds exactly the agreement.  The
    process-global counters saw every agreed step of the run."""
    for out in gang:
        assert int(out["allreduces.off"]) == 1
        assert int(out["allreduces.skip"]) == 2
        # skip 1 + zero 2 + raise 2 + hier 1 agreed; skip 1, raise 2,
        # hier 1 dropped.
        assert tuple(out["counters"]) == (6, 4)
