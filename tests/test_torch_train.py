"""The port's training step against the JAX package's, on the CPU.

Three AdamW steps of ``make_transformer_train_step`` from the same weights
(the JAX package's ``init``, converted) and the same tokens (numpy):

* one process against JAX on a ``{"dp": 1}`` mesh;
* a two-process gloo gang, two sequences per rank, against JAX on a
  ``{"dp": 2}`` mesh with the same four sequences.  Every parameter must be
  identical across the ranks.

fp32 compute; losses and parameters at 1e-4 (Adam divides by the gradient's
own size, so the gradients' 5e-4 agreement shrinks to the update's).  The
worker runs in spawned processes and imports only torch and the port at
module level; JAX is imported inside the tests.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import train


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


SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq_len=64, attn_impl="flash")
STEPS = 3


def _port_cfg():
    return tfm.TransformerConfig(compute_dtype=torch.float32, **SMALL)


def _run_port(params, toks, tgts):
    """STEPS steps from ``params`` on this rank's batch; returns (losses,
    final state_dict)."""
    step_fn, init_fn = train.make_transformer_train_step(_port_cfg(),
                                                         device="cpu")
    state = init_fn(0)
    with torch.no_grad():
        state.model.load_state_dict(convert.params_from_jax(params))
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, torch.tensor(toks), torch.tensor(tgts))
        losses.append(float(loss))
    assert state.step == STEPS
    return losses, state.model.state_dict()


def _gang_worker(rank, size, store, data_path, out_dir):
    hvd.init(rank=rank, size=size, device="cpu", init_method=f"file://{store}")
    try:
        d = dict(np.load(data_path))
        params = {"embed": d["embed"], "ln_f": d["ln_f"],
                  "layers": {k: d[f"layers.{k}"] for k in convert.LAYER_KEYS}}
        per = d["toks"].shape[0] // size
        sl = slice(rank * per, (rank + 1) * per)
        losses, sd = _run_port(params, d["toks"][sl], d["tgts"][sl])
        np.savez(f"{out_dir}/rank{rank}.npz", losses=np.array(losses),
                 **{k: v.numpy() for k, v in sd.items()})
    finally:
        hvd.shutdown()


def _jax_run(eight_devices, dp, toks, tgts):
    """JAX's make_transformer_train_step on a {"dp": dp} mesh: (initial
    params as numpy, losses, final params as numpy)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import train as jtrain

    cfg = jtfm.TransformerConfig(compute_dtype=jnp.float32, **SMALL)
    mesh = mesh_mod.make_mesh({"dp": dp}, devices=eight_devices[:dp])
    step, init = jtrain.make_transformer_train_step(cfg, mesh)
    state = init(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.array, state.params)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, state.params)


def _assert_params_close(state_dict, jax_params):
    got = convert.params_to_jax(state_dict)
    np.testing.assert_allclose(got["embed"], jax_params["embed"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["ln_f"], jax_params["ln_f"], rtol=1e-4,
                               atol=1e-4)
    for k, v in jax_params["layers"].items():
        np.testing.assert_allclose(got["layers"][k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _batch(B):
    rs = np.random.RandomState(0)
    return rs.randint(0, 64, (B, 64)), rs.randint(0, 64, (B, 64))


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_three_steps_match_jax_single_process(eight_devices, one_rank):
    toks, tgts = _batch(2)
    params0, jlosses, jparams = _jax_run(eight_devices, 1, toks, tgts)
    losses, sd = _run_port(params0, toks, tgts)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0]
    _assert_params_close(sd, jparams)


@pytest.mark.timeout(240)
def test_two_rank_gloo_gang_matches_jax_dp2(eight_devices, tmp_path):
    toks, tgts = _batch(4)
    params0, jlosses, jparams = _jax_run(eight_devices, 2, toks, tgts)
    data = tmp_path / "data.npz"
    np.savez(data, toks=toks, tgts=tgts, embed=params0["embed"],
             ln_f=params0["ln_f"],
             **{f"layers.{k}": v for k, v in params0["layers"].items()})
    _spawn_gang(_gang_worker, 2, (2, str(tmp_path / "store"), str(data),
                                  str(tmp_path)), timeout=180.0)
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in outs[0]:
        if k != "losses":
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    # Each rank's loss is the mean over its own half of the batch.
    np.testing.assert_allclose((outs[0]["losses"] + outs[1]["losses"]) / 2,
                               jlosses, rtol=1e-4, atol=1e-4)
    _assert_params_close(
        {k: torch.from_numpy(v) for k, v in outs[0].items()
         if k != "losses"}, jparams)


def test_backward_passes_per_step_applies_the_mean(one_rank):
    """Two accumulating calls equal one step on the mean gradient; the
    first call leaves parameters and optimizer state untouched."""
    torch.manual_seed(0)
    a = torch.nn.Linear(4, 3)
    b = torch.nn.Linear(4, 3)
    b.load_state_dict(a.state_dict())
    x1, x2 = torch.randn(5, 4), torch.randn(5, 4)
    opt_a = hvd.DistributedOptimizer(torch.optim.AdamW(a.parameters()),
                                     backward_passes_per_step=2)
    opt_b = hvd.DistributedOptimizer(torch.optim.AdamW(b.parameters()))
    before = [p.detach().clone() for p in a.parameters()]
    for x in (x1, x2):
        opt_a.zero_grad()
        a(x).square().sum().backward()
        opt_a.step()
        if x is x1:
            assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                          before))
            assert not opt_a.inner.state
    opt_b.zero_grad()
    ((b(x1).square().sum() + b(x2).square().sum()) / 2).backward()
    opt_b.step()
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-6)


def test_nonfinite_guard_is_not_ported(one_rank):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hvd.DistributedOptimizer(torch.optim.SGD([torch.zeros(1)], lr=1.0),
                                 nonfinite_policy="skip")
