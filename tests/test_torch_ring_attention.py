"""The port's sequence-parallel attention against the JAX package's, on the
CPU.

A four-process gloo gang (``gang`` fixture, once per module) runs
``make_sharded_attention`` over ``make_mesh({"sp": 4})`` for ring and
Ulysses, causal and not, in fp32 and bf16, each rank on its sequence block
of the same global q/k/v (numpy, from a seed), with the backward of
sum(out * w).  The JAX package runs ``make_sharded_attention`` on a
four-device CPU mesh, its flash kernels in interpret mode (as
``tests/test_ring_attention.py`` runs them).

Tolerances: fp32 2e-5 on outputs and 1e-4 on gradients (the JAX package's
own ring-against-oracle tolerances: both sides sum in other orders); bf16
two bf16 ulps of (|want| + rms) on the outputs, where both round P, the
hops merge in fp32 and the output rounds once, and four on the gradients,
which also add each hop's bf16 dQ, dK and dV in autograd's order.  The
loopback (one process playing every rank, what ``chip_smoke.py`` runs on
the card) is held to the gang: outputs bit for bit, gradients at 1e-6 in
fp32 and two bf16 ulps in bf16, where a K/V block's gradient adds the
hops' bf16 contributions in another order (the gang as they travel home,
the loopback into the whole tensor's gradient).
The worker imports only torch and the port at module level.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.parallel import ring_attention as ra


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


SP = 4
B, S, H, D = 2, 32, 4, 16  # S global: 8 positions per rank
CASES = [(impl, causal, dtype) for impl in ("ring", "ulysses")
         for causal in (True, False) for dtype in ("float32", "bfloat16")]


def _case_id(case):
    impl, causal, dtype = case
    return f"{impl}-{'causal' if causal else 'full'}-{dtype}"


def _arrays(seed=0):
    """Global q, k, v and the loss weight w, [B, S, H, D] fp32."""
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _block(x, r):
    n = x.shape[1] // SP
    return x[:, r * n:(r + 1) * n]


def _attention_worker(rank, size, store, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        mesh = M.make_mesh({"sp": size})
        q, k, v, w = _arrays()
        out = {}
        for case in CASES:
            impl, causal, dtype = case
            dt = getattr(torch, dtype)
            ts = [torch.tensor(_block(a, rank)).to(dt).requires_grad_()
                  for a in (q, k, v)]
            fn = ra.make_sharded_attention(mesh, impl=impl, causal=causal)
            o = fn(*ts)
            (o.float() * torch.tensor(_block(w, rank))).sum().backward()
            key = _case_id(case)
            out[f"{key}.o"] = o.detach().float().numpy()
            for name, t in zip("qkv", ts):
                assert t.grad.dtype == dt
                out[f"{key}.d{name}"] = t.grad.float().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_gang")
    _spawn_gang(_attention_worker, SP, (SP, str(d / "store"), str(d)),
                timeout=150.0)
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(SP)]
    # Each result as the global [B, S, H, D] array, rank r's block at r.
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}


def _jax(eight_devices, case):
    """(out, dq, dk, dv) of the JAX package's make_sharded_attention at
    sp 4, as fp32 numpy."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import ring_attention as jra

    impl, causal, dtype = case
    mesh = jmesh.make_mesh({"sp": SP}, devices=eight_devices[:SP])
    fn = jra.make_sharded_attention(mesh, impl=impl, causal=causal)
    q, k, v, w = _arrays()
    args = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]

    def run(*a):  # out, and the vjp of sum(out * w): cotangent w
        out, vjp = jax.vjp(fn, *a)
        return (out,) + vjp(jnp.asarray(w).astype(out.dtype))

    return [np.asarray(t, np.float32) for t in jax.jit(run)(*args)]


def _ulps_close(got, want, ulps, what):
    """Each element within ``ulps`` bf16 ulps (2⁻⁷) of (|want| + rms)."""
    rms = float(np.sqrt(np.mean(want ** 2)))
    bad = np.abs(got - want) > ulps * 2.0 ** -7 * (np.abs(want) + rms)
    assert not bad.any(), (f"{what}: {bad.sum()} elements beyond {ulps} "
                           f"ulps, worst {np.max(np.abs(got - want))}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_attention_and_grads_match_jax(eight_devices, gang, case):
    want = _jax(eight_devices, case)
    key = _case_id(case)
    got = [gang[f"{key}.{t}"] for t in ("o", "dq", "dk", "dv")]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        if case[2] == "float32":
            tol = 2e-5 if name == "o" else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{key} {name}")
        else:
            _ulps_close(g, w, 2 if name == "o" else 4, f"{key} {name}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_loopback_runs_the_gangs_schedule(gang, impl):
    """One process playing the four ranks gives the gang's outputs and
    gradients on the same inputs."""
    q, k, v, w = _arrays()
    for causal in (True, False):
        for dtype in ("float32", "bfloat16"):
            key = _case_id((impl, causal, dtype))
            ts = [torch.tensor(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v)]
            o = ra.loopback_attention(*ts, SP, impl, causal)
            (o.float() * torch.tensor(w)).sum().backward()
            np.testing.assert_array_equal(o.detach().float().numpy(),
                                          gang[f"{key}.o"], err_msg=key)
            for name, t in zip("qkv", ts):
                got = t.grad.float().numpy()
                if dtype == "float32":
                    np.testing.assert_allclose(got, gang[f"{key}.d{name}"],
                                               rtol=1e-6, atol=1e-6,
                                               err_msg=f"{key} d{name}")
                else:
                    _ulps_close(got, gang[f"{key}.d{name}"], 2,
                                f"{key} d{name}")


def test_combine_partials_guards_empty_rows():
    """Rows where one or both partials are empty (lse -inf): the port's
    merge and its gradients against the JAX package's, no NaN anywhere."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import ring_attention as jra

    rs = np.random.RandomState(3)
    o1, o2 = (rs.randn(1, 4, 2, 8).astype(np.float32) for _ in range(2))
    l1, l2 = (rs.randn(1, 4, 2).astype(np.float32) for _ in range(2))
    l1[0, 0], l2[0, 1] = -np.inf, -np.inf
    l1[0, 2], l2[0, 2] = -np.inf, -np.inf
    wo = rs.randn(*o1.shape).astype(np.float32)
    wl = np.where(np.isfinite(l1 + l2), rs.randn(*l1.shape), 0.0).astype(
        np.float32)

    ts = [torch.tensor(a, requires_grad=True) for a in (o1, l1, o2, l2)]
    o, lse = ra._combine_partials(*ts)
    ((o * torch.tensor(wo)).sum()
     + (torch.where(torch.isfinite(lse), lse, 0.0) * torch.tensor(wl)).sum()
     ).backward()

    def loss(*a):
        jo, jl = jra._combine_partials(*a)
        return jnp.sum(jo * wo) + jnp.sum(jnp.where(jnp.isfinite(jl), jl, 0.0)
                                          * wl)

    jo, jl = jra._combine_partials(o1, l1, o2, l2)
    jg = jax.grad(loss, argnums=(0, 1, 2, 3))(o1, l1, o2, l2)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(lse.detach().numpy(), np.asarray(jl))
    assert np.all(o.detach().numpy()[0, 2] == 0.0)
    assert np.isneginf(lse.detach().numpy()[0, 2]).all()
    for t, g in zip(ts, jg):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6,
                                   atol=1e-6)


def test_ulysses_needs_heads_divisible_by_the_axis():
    q = torch.zeros(1, 16, 4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ra.loopback_attention(q, q, q, 8, "ulysses")


def test_make_sharded_attention_rejects_unknown_impl():
    hvd.init(device="cpu")
    try:
        mesh = M.make_mesh({"sp": 1})
        with pytest.raises(ValueError, match="impl"):
            ra.make_sharded_attention(mesh, impl="flash")
        with pytest.raises(ValueError, match="impl"):
            ra.loopback_attention(torch.zeros(1, 4, 1, 8),
                                  torch.zeros(1, 4, 1, 8),
                                  torch.zeros(1, 4, 1, 8), 2, "flash")
    finally:
        hvd.shutdown()
