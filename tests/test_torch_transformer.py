"""The port's transformer against the JAX package's, on the CPU.

Weights come from the JAX package's ``init`` and go through the converter;
tokens are made with numpy.  fp32 compute on both sides.  Tolerances: 2e-4
on the logits and the loss, 5e-4 on the gradients -- both sides sum in
other orders, and the flash path adds the blockwise softmax's own rounding
(the JAX package holds its flash transformer to dense at 5e-4).  JAX is
imported inside the tests only.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq_len=64)


def _jax_cfg(**kw):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    return jtfm.TransformerConfig(compute_dtype=jnp.float32,
                                  **{**SMALL, **kw})


def _port_cfg(**kw):
    return tfm.TransformerConfig(compute_dtype=torch.float32,
                                 **{**SMALL, **kw})


def _jax_params(seed=0):
    import jax

    from horovod_tpu.models import transformer as jtfm

    params = jtfm.init(jax.random.PRNGKey(seed), _jax_cfg())
    return jax.tree.map(np.asarray, params)


def _port_model(params, **kw):
    model = tfm.Transformer(_port_cfg(**kw))
    model.load_state_dict(convert.params_from_jax(params))
    return model


def _tokens(seed=0, B=2, S=64):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 64, (B, S)), rs.randint(0, 64, (B, S))


def test_converter_round_trips_jax_weights():
    params = _jax_params()
    model = _port_model(params)
    assert model.layers[1].wq.shape == (32, 4, 8)
    assert model.layers[0].wo.shape == (4, 8, 32)
    back = convert.params_to_jax(model.state_dict())
    assert sorted(back["layers"]) == sorted(params["layers"])
    for k in ("embed", "ln_f"):
        np.testing.assert_array_equal(back[k], params[k])
    for k, v in params["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], v)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_loss_and_grads_match_jax(attn_impl, remat):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    params = _jax_params()
    toks, tgts = _tokens()
    jcfg = _jax_cfg(attn_impl=attn_impl, remat=remat)
    jparams = jax.tree.map(jnp.asarray, params)
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jparams, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    jlogits, _ = jtfm.apply(jparams, jnp.asarray(toks), jcfg)

    model = _port_model(params, attn_impl=attn_impl, remat=remat)
    t_toks, t_tgts = torch.tensor(toks), torch.tensor(tgts)
    loss = tfm.loss_fn(model, t_toks, t_tgts)
    loss.backward()
    with torch.no_grad():
        logits, _ = tfm.apply(model, t_toks)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4,
                               atol=2e-4)
    grads = convert.params_to_jax(
        {k: p.grad for k, p in model.named_parameters()})
    flat_j = jax.tree.leaves_with_path(jgrads)
    flat_p = dict(jax.tree.leaves_with_path(grads))
    assert len(flat_j) == len(flat_p) == 11
    for path, gj in flat_j:
        np.testing.assert_allclose(flat_p[path], np.asarray(gj), rtol=5e-4,
                                   atol=5e-4, err_msg=str(path))


def test_flash_matches_dense_in_the_port():
    params = _jax_params(seed=1)
    toks, _ = _tokens(seed=1)
    with torch.no_grad():
        ld, _ = tfm.apply(_port_model(params, attn_impl="dense"),
                          torch.tensor(toks))
        lf, _ = tfm.apply(_port_model(params, attn_impl="flash"),
                          torch.tensor(toks))
    np.testing.assert_allclose(lf.numpy(), ld.numpy(), rtol=5e-4, atol=5e-4)


def test_bf16_logits_are_fp32():
    model = tfm.init(0, tfm.TransformerConfig(**SMALL, attn_impl="flash"),
                     device="cpu")
    toks, _ = _tokens(S=32)
    with torch.no_grad():
        logits, aux = tfm.apply(model, torch.tensor(toks))
    assert logits.dtype == torch.float32 and logits.shape == (2, 32, 64)
    assert torch.isfinite(logits).all() and float(aux) == 0.0


def test_bf16_vocab_projection_grads_match_jax():
    """bf16 activations against an fp32 embedding, fp32 logits weighted by a
    fixed fp32 tensor.  The reference forms dx and d embed from the fp32
    cotangent; the port rounds the cotangent to bf16 first, then sums in
    fp32 and rounds once, as the reference does.  That is one bf16 rounding
    apart, held at two bf16 ulps of (|want| + rms)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    rs = np.random.RandomState(0)
    B, S, D, V = 2, 64, 128, 512
    x = rs.randn(B, S, D).astype(np.float32)
    embed = (rs.randn(V, D) / np.sqrt(D)).astype(np.float32)
    w = rs.randn(B, S, V).astype(np.float32)

    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    te = torch.tensor(embed, requires_grad=True)
    logits = tfm.vocab_projection(tx, te)
    assert logits.dtype == torch.float32
    (logits * torch.tensor(w)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and te.grad.dtype == torch.float32

    jlogits, vjp = jax.vjp(jtfm.vocab_projection,
                           jnp.asarray(x, jnp.bfloat16), jnp.asarray(embed))
    jdx, jde = vjp(jnp.asarray(w))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    for got, want in ((tx.grad, jdx), (te.grad, jde)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        rms = float(np.sqrt(np.mean(want ** 2)))
        np.testing.assert_array_less(np.abs(got - want),
                                     2 * 2.0 ** -7 * (np.abs(want) + rms))


def test_init_is_seeded():
    cfg = _port_cfg()
    a = tfm.init(3, cfg, device="cpu").state_dict()
    b = tfm.init(3, cfg, device="cpu").state_dict()
    c = tfm.init(4, cfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("kw", [dict(n_experts=4)])
def test_unported_configurations_raise(kw):
    """The Switch MoE FFN is ported (``tests/test_torch_moe.py``): the
    model builds.  A pipeline (``pp``) mesh axis is ported too
    (``tests/test_torch_pipeline.py``): over it the model holds every
    layer, a replica, as the JAX package's ``param_specs`` name no
    ``pp``.  What still raises is a mesh whose axes do not divide the
    model: experts over an ``ep`` that does not divide them."""
    model = tfm.Transformer(_port_cfg(**kw))
    assert tuple(model.layers[0].router.shape) == (32, 4)
    replica = tfm.Transformer(_port_cfg(**kw), mesh=SimpleNamespace(
        shape={"dp": 2, "pp": 2}))
    assert len(replica.layers) == len(model.layers)
    with pytest.raises(ValueError, match="n_experts 4 is not divisible"):
        tfm.Transformer(_port_cfg(**kw), mesh=SimpleNamespace(
            shape={"ep": 3}))


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_without_sp_are_dense(attn_impl):
    """The JAX package's rule: ring and Ulysses attention run only where the
    mesh shards the sequence; without it they are dense attention.  So the
    same logits as ``"dense"`` in the port (bit for bit: the same code),
    and as the JAX package's ``attn_impl`` without a mesh."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    params = _jax_params(seed=2)
    toks, _ = _tokens(seed=2)
    with torch.no_grad():
        got, _ = tfm.apply(_port_model(params, attn_impl=attn_impl),
                           torch.tensor(toks))
        dense, _ = tfm.apply(_port_model(params, attn_impl="dense"),
                             torch.tensor(toks))
    torch.testing.assert_close(got, dense, rtol=0, atol=0)
    want, _ = jtfm.apply(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(toks), _jax_cfg(attn_impl=attn_impl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_unknown_attn_impl_raises():
    with pytest.raises(ValueError, match="attn_impl"):
        tfm.Transformer(_port_cfg(attn_impl="sparse"))
