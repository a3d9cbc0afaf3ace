"""The port's flash attention against the JAX package's.

On the CPU the port takes its plain PyTorch versions (no kernel launches);
the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` does.  Inputs are made with numpy from
a seed and handed to both.  Tolerances: 2e-5 on the forward and 2e-4 on the
gradients in fp32 (the JAX package's own flash-vs-dense tolerances: both
sides sum in other orders), bf16 against an fp32 oracle at bf16's
resolution, and bf16 against JAX's bf16 flash, which rounds at the same
points, at two bf16 ulps.

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


def _ulps_close(got, want, ulps):
    """Each element within ``ulps`` bf16 ulps of its value (2⁻⁷ each, the
    ulp at the bottom of a binade), plus as many ulps of the output's rms
    for elements near zero."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_array_less(np.abs(got - want),
                                 ulps * 2.0 ** -7 * (np.abs(want) + rms))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_versions_match_jax_flash(causal):
    """bf16 through the port's plain versions and JAX's Pallas kernels
    (interpret mode) on the same numpy inputs.  Both round P before P·V and
    Pᵀ·dO and dS before dS·K and dSᵀ·Q, and the forward walks key blocks of
    ``FWD_BLOCK_K`` on both sides, so they agree to two bf16 ulps: the sums
    run in other orders, so an intermediate that lies on a rounding
    boundary may round the other way, and each output rounds once."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import flash_attention

    arrs = _np_qkv(seed=8, S=2 * fa.FWD_BLOCK_K)
    w = np.random.RandomState(9).randn(*arrs[0].shape).astype(np.float32)
    ts = _torch(arrs, torch.bfloat16)
    out = fa.flash_attention(*ts, causal=causal)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.tensor(w)).sum().backward()

    def run(q, k, v):
        return flash_attention(q, k, v, causal=causal,
                               block_q=fa.FWD_BLOCK_K,
                               block_k=fa.FWD_BLOCK_K)

    def loss(q, k, v):
        return jnp.sum(run(q, k, v).astype(jnp.float32) * w)

    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    _ulps_close(out.detach().float(), run(*jargs).astype(jnp.float32), 2)
    g = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    for t, gj in zip(ts, g):
        assert t.grad.dtype == torch.bfloat16
        _ulps_close(t.grad.float(), gj.astype(jnp.float32), 2)


def _fwd_fp32_formula(q, k, v, scale, causal):
    """The plain forward before the rounding points: one dense softmax."""
    s = fa._scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", torch.exp(s - lse.unsqueeze(-1)), v)
    return o, lse.transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_unchanged_for_fp32(causal):
    """With fp32 inputs the rounding casts do nothing: the plain versions
    give the dense fp32 formulas' values, up to fp32 summation order (the
    forward's key blocks)."""
    q, k, v = (torch.tensor(a) for a in _np_qkv(seed=10, S=300, D=16))
    do = torch.tensor(_np_qkv(seed=11, S=300, D=16)[0])
    scale = 0.25
    o, lse = fa._flash_fwd_plain(q, k, v, scale, causal)
    wo, wlse = _fwd_fp32_formula(q, k, v, scale, causal)
    _close(o, wo, 1e-6)
    _close(lse, wlse, 1e-6)
    delta = (do * o).sum(-1)
    dlse = torch.tensor(np.random.RandomState(12).randn(*lse.shape),
                        dtype=torch.float32)
    args = (q, k, v, do, lse, delta, dlse, scale, causal)
    p, ds = fa._probs_and_dscores(*args)
    torch.testing.assert_close(
        fa._flash_dq_plain(*args),
        torch.einsum("bhst,bthd->bshd", ds, k) * scale, rtol=0, atol=0)
    dk, dv = fa._flash_dkv_plain(*args)
    torch.testing.assert_close(
        dk, torch.einsum("bhst,bshd->bthd", ds, q) * scale, rtol=0, atol=0)
    torch.testing.assert_close(
        dv, torch.einsum("bhst,bshd->bthd", p, do), rtol=0, atol=0)
    assert all(float(t.abs().max()) == 0
               for t in fa.rounding_slack(*args).values())


def test_impl_is_chosen_by_dtype():
    """Every kernel of either dtype runs on the tensor cores; the dtypes
    choose the instantiation."""
    bf, f32 = torch.bfloat16, torch.float32
    assert fa.variant("fwd", bf) == "fwd wgmma causal"
    assert fa.variant("dkv", bf, bf) == "dkv wgmma causal"
    # the lse variant's fp32 dO
    assert fa.variant("dkv", bf, f32) == "dkv wgmma f32do causal"
    assert fa.variant("dq", bf, bf) == "dq wgmma causal"
    assert fa.variant("dq", bf, f32) == "dq wgmma f32do causal"
    # fp32 q/k/v: all three as bf16 planes.
    assert fa.variant("fwd", f32) == "fwd wgmma fp32 causal"
    assert fa.variant("dkv", f32, f32) == "dkv wgmma fp32 causal"
    assert fa.variant("dq", f32, f32) == "dq wgmma fp32 causal"


def test_tma_check_rejects_unaligned_strides():
    """A head stride of 36 bf16 values (72 bytes) is no whole number of
    16-byte units, so the tensor map cannot describe it."""
    x = torch.zeros(1, 64, 2, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="TMA"):
        fa._check_tma(("q", x))
    fa._check_tma(("q", torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16)))


def test_cpu_path_launches_no_kernel():
    arrs = _np_qkv(S=64)
    ts = _torch(arrs)
    o, lse = fa.flash_attention_lse(*ts)
    (o.sum() + lse.sum()).backward()
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0, "split": 0}


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


def _assert_kernel_close(got, want, dtype, slack=0.0):
    """Each element of a kernel output within rtol·|want| + atol·rms(want)
    + slack of its plain version on the same inputs (``chip_smoke.TOL``).
    bf16 outputs: rtol one bf16 ulp at the bottom of a binade (2^-7), as
    both sides round their fp32 result once, and atol 1e-3·rms for the fp32
    sums' order.  fp32 outputs: 1e-4 and 1e-4·rms (the sums' order and the
    three-plane products).
    ``slack`` (``fa.rounding_slack``) covers bf16 intermediates that both
    sides round."""
    rtol, atol = (2.0 ** -7, 1e-3) if dtype == torch.bfloat16 else \
        (1e-4, 1e-4)
    got, want = got.float(), want.float()
    allowed = (rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
               + slack)
    worst = float(((got - want).abs() / allowed).max())
    assert worst <= 1.0, f"worst element at {worst:.3f} of its tolerance"


def _check_kernels(q, k, v, causal):
    """Forward, dQ and dK/dV kernels against the plain versions (fp32 sums,
    the kernels' rounding points) on the same inputs, with a nonzero
    dlse."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    gen = torch.Generator(device=q.device).manual_seed(11)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, causal)
    do = torch.randn(q.shape, device=q.device, generator=gen).to(dt)
    dlse = torch.randn(plse.shape, device=q.device, generator=gen)
    delta = (do.float() * po.float()).sum(-1)
    args = (q, k, v, do, plse, delta, dlse, scale, causal)
    slack = fa.rounding_slack(*args)
    _assert_kernel_close(o, po, dt, slack["o"])
    _assert_kernel_close(lse, plse, torch.float32)
    _assert_kernel_close(fa.flash_dq_cuda(*args), fa._flash_dq_plain(*args),
                         dt, slack["dq"])
    dk, dv = fa.flash_dkv_cuda(*args)
    pdk, pdv = fa._flash_dkv_plain(*args)
    _assert_kernel_close(dk, pdk, dt, slack["dk"])
    _assert_kernel_close(dv, pdv, dt, slack["dv"])
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
    """q/k/v as views into one packed [B, S, 3, H, D] tensor, in fp32 (the
    split's strided reads) and bf16 (the kernels' tensor maps)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(2, 200, 3, 4, 64, device=cuda_device,
                          generator=gen).to(dt)
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
    # fp32 q/k/v are split once in the forward, dO once in the backward.
    assert fa.launches == {"fwd": 1, "dq": 1, "dkv": 1, "split": 2}
    o = fa.flash_attention(*ts)
    o.sum().backward()  # the lse gets no gradient: dlse is None
    assert fa.launches == {"fwd": 2, "dq": 2, "dkv": 2, "split": 4}


def _lse_variant_bf16_against_fp32_oracle(device, causal):
    """bf16 q/k/v through the lse variant: its fp32 output sends an fp32 dO
    to the backward, beside a nonzero dlse.  The oracle is the plain
    versions, with fp32 sums, on the same bf16 tensors: they round P before
    P·V and dS before the dK and dQ products as the kernels do, and keep
    P in fp32 before Pᵀ·dO, since dO is fp32."""
    gen = torch.Generator(device=device).manual_seed(17)
    q, k, v = (torch.randn(2, 200, 4, 64, device=device, generator=gen)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    wo = torch.randn(q.shape, device=device, generator=gen)
    wl = torch.randn(q.shape[:3], device=device, generator=gen)
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert o.dtype == torch.float32
    ((o * wo).sum() + (lse * wl).sum()).backward()

    scale = 1.0 / math.sqrt(q.shape[-1])
    qb, kb, vb = (t.detach() for t in (q, k, v))
    po, plse = fa._flash_fwd_plain(qb, kb, vb, scale, causal, out_f32=True)
    pargs = (qb, kb, vb, wo, plse, (wo * po).sum(-1), wl, scale, causal)
    slack = fa.rounding_slack(*pargs)
    _assert_kernel_close(o.detach(), po, torch.float32, slack["o"])
    _assert_kernel_close(lse.detach(), plse, torch.float32)
    pdk, pdv = fa._flash_dkv_plain(*pargs)
    for t, want, sl in ((q, fa._flash_dq_plain(*pargs), slack["dq"]),
                        (k, pdk, slack["dk"]), (v, pdv, slack["dv"])):
        assert t.grad.dtype == torch.bfloat16
        _assert_kernel_close(t.grad, want, torch.bfloat16, sl)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_variant_bf16_backward_takes_fp32_cotangent(causal):
    _lse_variant_bf16_against_fp32_oracle(torch.device("cpu"), causal)
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0, "split": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_lse_variant_backward_in_bf16(cuda_device, causal):
    _lse_variant_bf16_against_fp32_oracle(cuda_device, causal)
    # One split of the fp32 dO serves both backward kernels.
    assert fa.launches == {"fwd": 1, "dq": 1, "dkv": 1, "split": 1}


@pytest.mark.cuda
def test_cuda_bf16_autograd_runs_wgmma_kernels(cuda_device):
    """A bf16 forward and backward count one launch of each kernel, all
    three on the tensor cores."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    ts = [torch.randn(2, 256, 4, 64, device=cuda_device, generator=gen)
          .to(torch.bfloat16).requires_grad_() for _ in range(3)]
    fa.flash_attention(*ts).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.launches == {"fwd": 1, "dq": 1, "dkv": 1, "split": 0}
    assert fa.variant_launches == {"fwd wgmma causal": 1,
                                   "dq wgmma causal": 1,
                                   "dkv wgmma causal": 1}
    assert all(t.grad is not None and bool(t.grad.isfinite().all())
               for t in ts)


@pytest.mark.cuda
def test_cuda_wgmma_wrappers_raise_on_strides_tma_cannot_take(cuda_device):
    x = torch.zeros(1, 64, 2, 36, device=cuda_device,
                    dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd_cuda(x, x, x, 1.0, True)
    st = torch.zeros(1, 64, 2, device=cuda_device)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_dq_cuda(x, x, x, x, st, st, None, 1.0, True)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_dkv_cuda(x, x, x, x, st, st, None, 1.0, True)
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0, "split": 0}


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    for D in (20, 264):
        q = torch.zeros(1, 64, 2, D, device=cuda_device)
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            fa.flash_attention(q, q, q)
    h = torch.zeros(1, 64, 2, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(h, h, h)
    assert fa.launches["fwd"] == 0
