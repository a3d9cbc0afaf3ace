"""The port's MNIST convnet against the JAX package's, on the CPU.

The JAX package's ``init`` weights, converted, and a batch of 8 images made
with numpy.  fp32 (``apply(..., dtype=float32)`` on both sides): logits,
loss and every gradient at 1e-4 (of the gradient's largest element).  bf16,
the models' default: the port rounds where the JAX code does (the conv
biases added in bf16, ``fc1`` in bf16, ``fc2`` in fp32 on an fp32 cast), and
its logits agree with the JAX forward run op by op to ``BF16_ULPS`` bf16
ulps of the largest logit (measured: 6.1e-8 on logits up to 0.29, the fp32
head's summation order).  The jitted JAX gradient sums bf16 cotangents in
XLA's own order and precision (the bias gradients are sums over every
pixel: ``b1`` differs by 5.4e-2 in relative norm, the weights by at most
3.7e-3), so each port gradient is held to accuracy: within
``BF16_GRAD_RATIO`` times JAX's own bf16 distance from the fp32 gradient
(measured: 0.53-1.00).  JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.parallel import train

BF16_ULPS = 2
BF16_GRAD_RATIO = 2.0
STEP_LOSS_TOL = 2e-4
STEP_TOL = 5e-2


def _jax_params():
    import jax

    from horovod_tpu.models import mnist as jm

    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _batch(B=8):
    rs = np.random.RandomState(0)
    return (rs.rand(B, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, (B,)))


def _port_model(params):
    model = tm.MNIST()
    model.load_state_dict(convert.mnist_params_from_jax(params))
    return model


def _jax_grads(params, imgs, labels, dtype):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import mnist as jm

    def loss(p):
        logits = jm.apply(p, jnp.asarray(imgs), getattr(jnp, dtype))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1)), \
            logits

    (val, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(val), np.asarray(logits), jax.tree.map(np.asarray, g)


def _port_grads(model, imgs, labels, dtype):
    logits = tm.apply(model, torch.tensor(imgs), getattr(torch, dtype))
    loss = tm.softmax_xent(logits, torch.tensor(labels))
    loss.backward()
    return loss.item(), logits.detach().numpy(), convert.mnist_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()})


def test_converter_round_trips_jax_weights():
    params = _jax_params()
    model = _port_model(params)
    assert model.conv2.shape == (64, 32, 3, 3)
    assert model.fc1.shape == (3136, 128)
    back = convert.mnist_params_to_jax(model.state_dict())
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_fp32_logits_loss_and_grads_match_jax():
    params = _jax_params()
    imgs, labels = _batch()
    jloss, jl, jg = _jax_grads(params, imgs, labels, "float32")
    ploss, pl, pg = _port_grads(_port_model(params), imgs, labels, "float32")
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-4, atol=1e-4)
    for k, want in jg.items():
        np.testing.assert_allclose(pg[k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_bf16_matches_jax():
    import jax.numpy as jnp

    from horovod_tpu.models import mnist as jm

    params = _jax_params()
    imgs, labels = _batch()
    want = np.asarray(jm.apply(params, jnp.asarray(imgs)))  # op by op, bf16
    _, _, jg = _jax_grads(params, imgs, labels, "bfloat16")
    _, _, jg32 = _jax_grads(params, imgs, labels, "float32")
    model = _port_model(params)
    logits = model(torch.tensor(imgs))
    assert logits.dtype == torch.float32
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_array_less(np.abs(logits.detach().numpy() - want),
                                 BF16_ULPS * ulp)
    _, _, pg = _port_grads(model, imgs, labels, "bfloat16")
    ratio = {k: _rel(pg[k], v) / _rel(jg[k], v) for k, v in jg32.items()}
    print(f"port's error / JAX's error against fp32: "
          f"{min(ratio.values()):.3f}-{max(ratio.values()):.3f}; "
          f"gaps {({k: round(_rel(pg[k], v), 5) for k, v in jg.items()})}")
    assert max(ratio.values()) < BF16_GRAD_RATIO, ratio


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_loss_fn_is_bf16_softmax_xent():
    params = _jax_params()
    imgs, labels = _batch()
    model = _port_model(params)
    got = tm.loss_fn(model, torch.tensor(imgs), torch.tensor(labels))
    want = tm.softmax_xent(tm.apply(model, torch.tensor(imgs),
                                    torch.bfloat16), torch.tensor(labels))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_init_follows_the_jax_recipe(seed):
    model = tm.init(seed, device="cpu")
    sd = convert.mnist_params_to_jax(model.state_dict())
    shapes = {k: v.shape for k, v in _jax_params().items()}
    assert {k: v.shape for k, v in sd.items()} == shapes
    for b in ("b1", "b2", "fb1", "fb2"):
        assert np.abs(sd[b]).max() == 0.0
    assert abs(sd["fc1"].std() - np.sqrt(2 / 3136)) < 1e-3
    assert abs(sd["conv2"].std() - np.sqrt(2 / (9 * 64))) < 5e-3
    other = tm.init(1 - seed, device="cpu")
    assert not torch.equal(other.fc1, model.fc1)


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_three_adam_steps_match_jax_single_process(eight_devices, one_rank):
    """``make_mnist_train_step`` (default Adam(1e-3), bf16) against JAX's on
    a ``{"dp": 1}`` mesh, from the same weights, on 16 images.  Adam's
    first steps move each weight by about the learning rate whatever the
    size of its gradient, so a tiny gradient that the two sides round to
    opposite signs moves its weight the other way: parameters are held to
    ``STEP_TOL`` of their movement in relative norm (measured: at most
    2.6e-2, ``b1``), losses to ``STEP_LOSS_TOL`` (measured: 4.9e-5)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import mesh as mesh_mod
    from horovod_tpu.parallel import train as jtrain

    imgs, labels = _batch(16)
    mesh = mesh_mod.make_mesh({"dp": 1}, devices=eight_devices[:1])
    jstep, jinit = jtrain.make_mnist_train_step(mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.array, jstate.params)
    step_fn, init_fn = train.make_mnist_train_step(device="cpu")
    state = init_fn(0)
    state.model.load_state_dict(convert.mnist_params_from_jax(params0))
    jlosses, losses = [], []
    for _ in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels))
        state, loss = step_fn(state, torch.tensor(imgs), torch.tensor(labels))
        jlosses.append(float(jloss))
        losses.append(loss.item())
    assert state.step == 3 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_LOSS_TOL)
    got = convert.mnist_params_to_jax(state.model.state_dict())
    gaps = {k: _rel(got[k] - params0[k], np.asarray(v) - params0[k])
            for k, v in jstate.params.items()}
    print(f"parameter gaps / movement: {gaps}")
    assert max(gaps.values()) < STEP_TOL, gaps
