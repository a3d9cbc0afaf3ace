"""The port's flash attention against the JAX package's.

On the CPU the port takes its plain PyTorch versions (no kernel launches);
the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` does.  Inputs are made with numpy from
a seed and handed to both.  Tolerances: 2e-5 on the forward and 2e-4 on the
gradients in fp32 (the JAX package's own flash-vs-dense tolerances: both
sides sum in other orders), bf16 against an fp32 oracle at bf16's
resolution.

The ``cuda`` cases hold each CUDA kernel against its plain version on the
card and skip where torch finds no CUDA device.  JAX is imported inside the
tests only.
"""

import math

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa


def _np_qkv(seed=0, B=2, S=128, H=4, D=32):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _jax_flash(arrs, causal=True, lse=False):
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import (flash_attention,
                                                  flash_attention_lse)

    q, k, v = (jnp.asarray(a) for a in arrs)
    fn = flash_attention_lse if lse else flash_attention
    return fn(q, k, v, causal=causal, block_q=64, block_k=64)


def _jax_dense(arrs, causal=True):
    import jax
    import jax.numpy as jnp

    q, k, v = (jnp.asarray(a, jnp.float32) for a in arrs)
    S, D = q.shape[1], q.shape[3]
    logits = jnp.einsum("bshk,bthk->bhst", q, k) / math.sqrt(D)
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None],
                           logits, -1e30)
    return jnp.einsum("bhst,bthk->bshk", jax.nn.softmax(logits, -1), v)


def _torch(arrs, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrs]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _counts():
    fa.reset_launch_counts()
    yield
    fa.reset_launch_counts()


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    arrs = _np_qkv()
    out = fa.flash_attention(*_torch(arrs), causal=causal)
    _close(out.detach(), _jax_flash(arrs, causal), 2e-5)


@pytest.mark.parametrize("S", [128, 96])
def test_grads_match_jax(S):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import flash_attention

    arrs = _np_qkv(seed=1, S=S)
    ts = _torch(arrs)
    (fa.flash_attention(*ts) ** 2).sum().backward()

    def loss(q, k, v):
        return jnp.sum(flash_attention(q, k, v, block_q=64, block_k=64) ** 2)

    g = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    for t, gj in zip(ts, g):
        _close(t.grad, gj, 2e-4)


def test_uneven_seq_forward_matches_jax():
    arrs = _np_qkv(seed=2, S=96)
    out = fa.flash_attention(*_torch(arrs))
    _close(out.detach(), _jax_flash(arrs), 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_variant_with_dlse_matches_jax(causal):
    """fp32 partial output and lse, with a nonzero cotangent on both."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import flash_attention_lse

    arrs = _np_qkv(seed=3)
    rs = np.random.RandomState(4)
    wo = rs.randn(*arrs[0].shape).astype(np.float32)
    wl = rs.randn(*arrs[0].shape[:3]).astype(np.float32)

    ts = _torch(arrs)
    o, lse = fa.flash_attention_lse(*ts, causal=causal)
    assert o.dtype == torch.float32 and lse.shape == (2, 128, 4)
    ((o * torch.tensor(wo)).sum() + (lse * torch.tensor(wl)).sum()).backward()

    def loss(q, k, v):
        oj, lj = flash_attention_lse(q, k, v, causal=causal, block_q=64,
                                     block_k=64)
        return jnp.sum(oj * wo) + jnp.sum(lj * wl)

    jo, jl = _jax_flash(arrs, causal, lse=True)
    _close(o.detach(), jo, 2e-5)
    _close(lse.detach(), jl, 2e-5)
    g = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    for t, gj in zip(ts, g):
        _close(t.grad, gj, 2e-4)


def test_bf16_inputs_against_f32_oracle():
    """bf16 in, bf16 out; the oracle is JAX's dense fp32 attention on the
    same (bf16-rounded) values.  2e-2 is a few bf16 ulps of values of
    order one."""
    import jax
    import jax.numpy as jnp

    arrs = _np_qkv(seed=5)
    ts = _torch(arrs, torch.bfloat16)
    out = fa.flash_attention(*ts)
    assert out.dtype == torch.bfloat16
    (out.float() ** 2).sum().backward()
    rounded = [t.detach().float().numpy() for t in ts]
    _close(out.detach().float(), _jax_dense(rounded), 2e-2)
    g = jax.grad(lambda q, k, v: jnp.sum(_jax_dense((q, k, v)) ** 2),
                 argnums=(0, 1, 2))(*(jnp.asarray(a) for a in rounded))
    for t, gj in zip(ts, g):
        assert t.grad.dtype == torch.bfloat16
        scale = float(np.max(np.abs(np.asarray(gj))))
        _close(t.grad.float() / scale, np.asarray(gj) / scale, 2e-2)


def test_cpu_path_launches_no_kernel():
    arrs = _np_qkv(S=64)
    ts = _torch(arrs)
    o, lse = fa.flash_attention_lse(*ts)
    (o.sum() + lse.sum()).backward()
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0}


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_versions_match_autograd(causal):
    """Each backward plain version against autograd through the plain
    forward, with a nonzero dlse."""
    arrs = _np_qkv(seed=6, S=48, D=16)
    q, k, v = _torch(arrs)
    scale = 0.3
    o, lse = fa._flash_fwd_plain(q, k, v, scale, causal, out_f32=True)
    rs = np.random.RandomState(7)
    do = torch.tensor(rs.randn(*o.shape).astype(np.float32))
    dlse = torch.tensor(rs.randn(*lse.shape).astype(np.float32))
    ((o * do).sum() + (lse * dlse).sum()).backward()
    delta = (do * o.detach()).sum(-1)
    args = (q.detach(), k.detach(), v.detach(), do, lse.detach(), delta,
            dlse, scale, causal)
    dq = fa._flash_dq_plain(*args)
    dk, dv = fa._flash_dkv_plain(*args)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        _close(got, want, 1e-5)


def test_kernel_wrappers_reject_cpu_tensors():
    q, k, v = (torch.zeros(1, 64, 1, 32) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_fwd_cuda(q, k, v, 1.0, True)
    assert fa.launches["fwd"] == 0


def test_mixed_devices_raise():
    q = torch.zeros(1, 8, 1, 16)
    k = torch.zeros(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        fa.flash_attention(q, k, q)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_kernel_close(got, want, dtype):
    """Each element of a kernel output within rtol·|want| + atol·rms(want)
    of its plain version computed in fp32.  bf16 outputs: rtol two bf16
    ulps (2^-7), as the kernel rounds its fp32 result once (at most half an
    ulp), and atol 1e-3·rms for the fp32 sums' order.  fp32 outputs: 1e-4
    and 1e-4·rms (summation order only)."""
    rtol, atol = (2.0 ** -7, 1e-3) if dtype == torch.bfloat16 else \
        (1e-4, 1e-4)
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=atol * float(want.pow(2).mean().sqrt()))


def _check_kernels(q, k, v, causal):
    """Forward, dQ and dK/dV kernels against the plain versions computed in
    fp32 on the same inputs, with a nonzero dlse."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    gen = torch.Generator(device=q.device).manual_seed(11)
    qf, kf, vf = (t.float() for t in (q, k, v))
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    po, plse = fa._flash_fwd_plain(qf, kf, vf, scale, causal)
    _assert_kernel_close(o, po, dt)
    _assert_kernel_close(lse, plse, torch.float32)
    do = torch.randn(q.shape, device=q.device, generator=gen).to(dt)
    dlse = torch.randn(plse.shape, device=q.device, generator=gen)
    delta = (do.float() * po).sum(-1)
    args = (q, k, v, do, plse, delta, dlse, scale, causal)
    pargs = (qf, kf, vf, do.float(), plse, delta, dlse, scale, causal)
    _assert_kernel_close(fa.flash_dq_cuda(*args), fa._flash_dq_plain(*pargs),
                         dt)
    dk, dv = fa.flash_dkv_cuda(*args)
    pdk, pdv = fa._flash_dkv_plain(*pargs)
    _assert_kernel_close(dk, pdk, dt)
    _assert_kernel_close(dv, pdv, dt)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 96, 1000, 1024])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_kernels_match_plain(cuda_device, D, S, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(D * 7919 + S)
    q, k, v = (torch.randn(2, S, 3, D, device=cuda_device,
                           generator=gen).to(dt) for _ in range(3))
    _check_kernels(q, k, v, causal=S % 2 == 0)
    _check_kernels(q, k, v, causal=S % 2 == 1)


@pytest.mark.cuda
def test_cuda_kernels_read_strided_inputs(cuda_device):
    """q/k/v as views into one packed [B, S, 3, H, D] tensor."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(2, 200, 3, 4, 64, device=cuda_device, generator=gen)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _check_kernels(q, k, v, causal=True)


@pytest.mark.cuda
def test_cuda_autograd_runs_kernels(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ts = [torch.randn(2, 128, 4, 32, device=cuda_device, generator=gen)
          .requires_grad_() for _ in range(3)]
    o, lse = fa.flash_attention_lse(*ts)
    (o.sum() + lse.sum()).backward()
    assert fa.launches == {"fwd": 1, "dq": 1, "dkv": 1}
    o = fa.flash_attention(*ts)
    o.sum().backward()  # the lse gets no gradient: dlse is None
    assert fa.launches == {"fwd": 2, "dq": 2, "dkv": 2}


def _lse_variant_bf16_against_fp32_oracle(device, causal):
    """bf16 q/k/v through the lse variant: its fp32 output sends an fp32 dO
    to the backward, beside a nonzero dlse.  The oracle is the plain
    versions in fp32 on the same (bf16) values."""
    gen = torch.Generator(device=device).manual_seed(17)
    q, k, v = (torch.randn(2, 200, 4, 64, device=device, generator=gen)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    wo = torch.randn(q.shape, device=device, generator=gen)
    wl = torch.randn(q.shape[:3], device=device, generator=gen)
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert o.dtype == torch.float32
    ((o * wo).sum() + (lse * wl).sum()).backward()

    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    po, plse = fa._flash_fwd_plain(qf, kf, vf, scale, causal, out_f32=True)
    _assert_kernel_close(o.detach(), po, torch.float32)
    _assert_kernel_close(lse.detach(), plse, torch.float32)
    pargs = (qf, kf, vf, wo, plse, (wo * po).sum(-1), wl, scale, causal)
    pdk, pdv = fa._flash_dkv_plain(*pargs)
    for t, want in ((q, fa._flash_dq_plain(*pargs)), (k, pdk), (v, pdv)):
        assert t.grad.dtype == torch.bfloat16
        _assert_kernel_close(t.grad, want, torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_variant_bf16_backward_takes_fp32_cotangent(causal):
    _lse_variant_bf16_against_fp32_oracle(torch.device("cpu"), causal)
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_lse_variant_backward_in_bf16(cuda_device, causal):
    _lse_variant_bf16_against_fp32_oracle(cuda_device, causal)
    assert fa.launches == {"fwd": 1, "dq": 1, "dkv": 1}


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 64, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    h = torch.zeros(1, 64, 2, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(h, h, h)
    assert fa.launches["fwd"] == 0
