"""The port's ResNet against the JAX package's, on the CPU.

A small ResNet (blocks (1, 1, 1, 1), width 8, 10 classes, 32x32 images,
batch 4 with the first two images scaled by 3) with the JAX package's
``init`` weights, converted.  The JAX side runs its default space-to-depth
stem; the port runs the plain 7x7 stride-2 conv.  JAX is imported inside
the tests only.

Tolerances:

* fp32: logits, loss and new statistics at 1e-4; each gradient at 1e-4 of
  its largest element (measured: 4e-5; both sides sum in other orders).
* bf16: the forward follows the JAX package's rounding points (statistics
  in fp32, ``inv`` and ``shift`` cast once, ``x * inv + shift`` in bf16):
  logits and new statistics agree with the JAX forward run op by op to
  ``BF16_ULPS`` bf16 ulps of the largest value (measured: 2.7e-7 on logits
  up to 1.2, i.e. bit for bit but for the fp32 head).  Under ``jax.jit``
  XLA fuses bf16 operations and keeps fp32 between them, which moves the
  logits by 7% of their largest value at this width, and its backward sums
  bf16 cotangents in its own order; the batch-norm backward subtracts
  nearly equal bf16 terms, which amplifies all of that (bf16 and fp32 JAX
  gradients differ by 0.2-0.95 in relative norm here).  So the gradients are
  held to accuracy rather than to bits: for each parameter, the port's bf16
  gradient is within ``BF16_GRAD_RATIO`` times JAX's own bf16 distance from
  the fp32 gradient (measured: 0.76-1.31 in training, 0.95-1.02 in
  inference), and in inference, where there is no statistics path, within
  ``BF16_EVAL_GRAD`` of JAX's bf16 gradient in relative norm (measured:
  0.055).
"""

import functools

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tr

SMALL = dict(blocks=(1, 1, 1, 1), width=8, num_classes=10)
BF16_ULPS = 2
BF16_GRAD_RATIO = 2.0
BF16_EVAL_GRAD = 0.1


def _jax_cfg(dtype="float32", **kw):
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jr

    return jr.ResNetConfig(compute_dtype=getattr(jnp, dtype),
                           **{**SMALL, **kw})


def _port_cfg(dtype="float32", **kw):
    return tr.ResNetConfig(compute_dtype=getattr(torch, dtype),
                           **{**SMALL, **kw})


@functools.lru_cache(maxsize=None)
def _jax_init(basic=False):
    """The JAX package's weights (params, batch_stats) as numpy; the tests
    only read them."""
    import jax

    from horovod_tpu.models import resnet as jr

    init = jax.jit(jr.init, static_argnums=1)
    return jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(0), _jax_cfg(basic=basic)))


def _batch(B=4, hw=32):
    rs = np.random.RandomState(0)
    imgs = rs.rand(B, hw, hw, 3).astype(np.float32)
    imgs[:B // 2] *= 3
    return imgs, rs.randint(0, 10, (B,))


def _port_model(params, stats, **kw):
    model = tr.ResNet(_port_cfg(**kw))
    model.load_state_dict(convert.resnet_params_from_jax(params, stats))
    return model


def _flat(tree):
    return dict(convert._flatten(tree))


def _jax_forward(params, stats, imgs, labels, train, **kw):
    """(logits, loss, new stats, grads) of the JAX package's model, all
    numpy (flat dicts for the trees)."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jr

    cfg = _jax_cfg(**kw)

    def loss(p):
        logits, new = jr.apply(p, stats, jnp.asarray(imgs), cfg, train=train)
        logp = jax.nn.log_softmax(logits)
        return (-jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1)),
                (logits, new))

    (val, (logits, new)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return (np.asarray(logits), float(val),
            _flat(jax.tree.map(np.asarray, new)),
            _flat(jax.tree.map(np.asarray, grads)))


def _port_forward(model, imgs, labels, train):
    logits, new = tr.apply(model, torch.tensor(imgs), train=train)
    loss = tr.softmax_xent(logits, torch.tensor(labels))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    new_stats = _flat(convert.resnet_params_to_jax(new)[1]) if train else {}
    return (logits.detach().numpy(), loss.item(), new_stats,
            _flat(convert.resnet_params_to_jax(grads)[0]))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ulp_close(got, want, n):
    """|got - want| within n bf16 ulps of max |want| (an ulp at x is
    2^-7 of x's power of two)."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_array_less(np.abs(np.asarray(got) - want),
                                 n * ulp + 1e-30)


def test_converter_round_trips_params_and_stats():
    params, stats = _jax_init()
    model = _port_model(params, stats)
    assert model.stem_conv.shape == (8, 3, 7, 7)
    assert model.stage1_block0.conv2.shape == (16, 16, 3, 3)
    assert model.stage0_block0.proj_conv.shape == (32, 8, 1, 1)
    assert model.head_w.shape == (256, 10)
    assert isinstance(model.get_buffer("stem_bn.var"), torch.Tensor)
    back_p, back_s = convert.resnet_params_to_jax(model.state_dict())
    for got, want in ((back_p, params), (back_s, stats)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("basic", [False, True])
def test_fp32_forward_grads_and_stats_match_jax(basic, train):
    params, stats = _jax_init(basic)
    imgs, labels = _batch()
    if not train:  # running statistics of one training forward
        stats = convert.resnet_params_to_jax(
            tr.apply(_port_model(params, stats, basic=basic),
                     torch.tensor(imgs), train=True)[1])[1]
    jl, jloss, jst, jg = _jax_forward(params, stats, imgs, labels, train,
                                      basic=basic)
    model = _port_model(params, stats, basic=basic)
    pl, ploss, pst, pg = _port_forward(model, imgs, labels, train)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-4, atol=1e-4)
    assert sorted(pg) == sorted(jg)
    for k, want in jg.items():
        np.testing.assert_allclose(pg[k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    if train:
        assert sorted(pst) == sorted(jst)
        assert len(jst) == len(list(model.buffers()))
        for k, want in jst.items():
            np.testing.assert_allclose(pst[k], want, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("stem_s2d", [True, False])
def test_plain_stem_matches_both_jax_stems(stem_s2d):
    params, stats = _jax_init()
    imgs, labels = _batch()
    jl, jloss, _, jg = _jax_forward(params, stats, imgs, labels, True,
                                    stem_s2d=stem_s2d)
    pl, ploss, _, pg = _port_forward(_port_model(params, stats), imgs, labels,
                                     True)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pg["stem_conv"], jg["stem_conv"], rtol=1e-4,
                               atol=1e-4 * np.abs(jg["stem_conv"]).max())


@pytest.mark.parametrize("train", [True, False])
def test_bf16_matches_jax(train):
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jr

    params, stats = _jax_init()
    imgs, labels = _batch()
    if not train:
        stats = convert.resnet_params_to_jax(
            tr.apply(_port_model(params, stats), torch.tensor(imgs),
                     train=True)[1])[1]
    # The forward op by op: each bf16 operation rounds where the code says.
    jl, jst = jr.apply(params, stats, jnp.asarray(imgs),
                       _jax_cfg(dtype="bfloat16"), train=train)
    _, _, _, jg = _jax_forward(params, stats, imgs, labels, train,
                               dtype="bfloat16")
    _, _, _, jg32 = _jax_forward(params, stats, imgs, labels, train)
    model = _port_model(params, stats, dtype="bfloat16")
    pl, _, pst, pg = _port_forward(model, imgs, labels, train)
    _ulp_close(pl, np.asarray(jl), BF16_ULPS)
    for k, want in _flat(jax_np(jst)).items() if train else ():
        _ulp_close(pst[k], want, BF16_ULPS)
    gaps = {k: _rel(pg[k], want) for k, want in jg.items()}
    ratio = {k: _rel(pg[k], want) / _rel(jg[k], want)
             for k, want in jg32.items()}
    print(f"bf16 gradient gaps (train={train}): max "
          f"{max(gaps.values()):.3e}; port's error / JAX's error against "
          f"fp32: {min(ratio.values()):.3f}-{max(ratio.values()):.3f}")
    assert max(ratio.values()) < BF16_GRAD_RATIO, ratio
    if not train:
        assert max(gaps.values()) < BF16_EVAL_GRAD, gaps


def jax_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_remat_changes_neither_grads_nor_stats():
    """A remat block runs its forward again in the backward pass; the
    statistics come from the first run only, and the buffers stay as they
    were until the caller writes them."""
    params, stats = _jax_init()
    imgs, labels = _batch()
    out = {}
    for remat in (False, True):
        model = _port_model(params, stats, remat=remat)
        loss, new = tr.loss_fn(model, torch.tensor(imgs),
                               torch.tensor(labels))
        loss.backward()
        for name, buf in model.named_buffers():
            np.testing.assert_array_equal(
                buf.numpy(), _flat(stats)[name], err_msg=name)
        out[remat] = ({n: p.grad for n, p in model.named_parameters()}, new)
    (g0, s0), (g1, s1) = out[False], out[True]
    assert sorted(s0) == sorted(s1) and len(s0) == 2 * 17
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0)


def test_running_var_is_the_biased_batch_variance():
    """momentum 0.9 on the old value, 0.1 on the ddof-0 variance -- not the
    unbiased variance that ``nn.BatchNorm2d`` puts in its running var."""
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(2, 3, 2, 2).astype(np.float32) * 2 + 1)
    bn = tr.BatchNorm(3)
    with torch.no_grad():
        bn.var.fill_(0.5)
        bn.mean.fill_(0.25)
    y, (mean, var) = tr._bn(x, bn, True, None)
    xn = x.numpy()
    want_var = 0.9 * 0.5 + 0.1 * xn.var(axis=(0, 2, 3), ddof=0)
    want_mean = 0.9 * 0.25 + 0.1 * xn.mean(axis=(0, 2, 3))
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-6)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6)
    torch_bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    with torch.no_grad():
        torch_bn.running_var.fill_(0.5)
    torch_bn(x)
    assert not np.allclose(torch_bn.running_var.numpy(), want_var,
                           rtol=1e-3)
    # and the normalization uses the same biased variance
    xhat = (xn - xn.mean(axis=(0, 2, 3), keepdims=True)) / np.sqrt(
        xn.var(axis=(0, 2, 3), keepdims=True) + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), xhat, atol=1e-5)
    assert bn.var.tolist() == [0.5] * 3  # the buffer is not touched


def test_write_stats_copies_into_the_buffers():
    params, stats = _jax_init()
    imgs, _ = _batch()
    model = _port_model(params, stats)
    _, new = tr.apply(model, torch.tensor(imgs), train=True)
    tr.write_stats(model, new)
    for name, value in new.items():
        torch.testing.assert_close(model.get_buffer(name), value, rtol=0,
                                   atol=0)
    assert len(new) == len(list(model.buffers()))


def test_init_follows_the_jax_recipe():
    model = tr.init(0, tr.resnet50_config(), device="cpu")
    n = sum(p.numel() for p in model.parameters())
    params, stats = convert.resnet_params_to_jax(model.state_dict())
    assert n == 25557032  # ResNet-50 v1.5, 1000 classes
    assert params["stage3_block2"]["bn3"]["scale"].min() == 1.0
    assert params["stage3_block2"]["bn3"]["bias"].max() == 0.0
    assert stats["stage3_block2"]["bn3"]["var"].min() == 1.0
    assert stats["stage3_block2"]["bn3"]["mean"].max() == 0.0
    assert np.abs(params["head_b"]).max() == 0.0
    assert np.abs(params["head_w"]).max() <= 1 / np.sqrt(2048)
    # 3x3, 128 -> 128: He-normal fan-out std sqrt(2 / (9 * 128))
    w = params["stage1_block1"]["conv2"]
    assert w.shape == (3, 3, 128, 128)
    assert abs(w.std() - np.sqrt(2 / (9 * 128))) < 2e-3
    assert sorted(params) == sorted(_flat_keys_of_jax_resnet50())
    same = tr.init(0, tr.resnet50_config(), device="cpu")
    torch.testing.assert_close(same.stem_conv, model.stem_conv, rtol=0,
                               atol=0)


def _flat_keys_of_jax_resnet50():
    """The top-level keys of the JAX package's ResNet-50 params, from its
    own ``init`` traced for shapes only."""
    import jax

    from horovod_tpu.models import resnet as jr

    shapes = jax.eval_shape(lambda k: jr.init(k, jr.resnet50_config()),
                            jax.random.PRNGKey(0))
    return list(shapes[0])
