"""The port's flash attention at head dims other than a power of two, and
the route of the lse variant's fp32 dO.

The kernels are instantiated at widths 16, 32, 64, 128 and 256 and serve
any head dim that is a multiple of 8 up to 256 (``kernel_head_dim``).  On
the CPU the port takes its plain versions, held here against the JAX
package's Pallas kernels (interpret mode) at D 96 and 80 with the
tolerances of ``test_torch_flash_attention.py``: 2e-5 on outputs and 2e-4
on gradients in fp32.  The ``cuda`` cases hold the kernels at those widths,
and the wgmma dQ and dK/dV kernels with an fp32 dO (split into bf16 planes),
against their plain versions on the card, and skip where torch finds no
CUDA device.  JAX is imported inside the tests only.
"""

import math

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa


def _np_qkv(seed, B=2, S=128, H=2, D=96):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


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


@pytest.mark.parametrize("D", [96, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax(D, causal):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import flash_attention

    arrs = _np_qkv(seed=D, S=96)
    w = np.random.RandomState(D + 1).randn(*arrs[0].shape).astype(np.float32)
    ts = _torch(arrs)
    out = fa.flash_attention(*ts, causal=causal)
    (out * torch.tensor(w)).sum().backward()

    def run(q, k, v):
        return flash_attention(q, k, v, causal=causal, block_q=64,
                               block_k=64)

    jargs = [jnp.asarray(a) for a in arrs]
    _close(out.detach(), run(*jargs), 2e-5)
    g = jax.grad(lambda *a: jnp.sum(run(*a) * w), argnums=(0, 1, 2))(*jargs)
    for t, gj in zip(ts, g):
        _close(t.grad, gj, 2e-4)


@pytest.mark.parametrize("D", [96, 80])
def test_lse_variant_with_dlse_matches_jax(D):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import flash_attention_lse

    arrs = _np_qkv(seed=D + 2)
    rs = np.random.RandomState(D + 3)
    wo = rs.randn(*arrs[0].shape).astype(np.float32)
    wl = rs.randn(*arrs[0].shape[:3]).astype(np.float32)
    ts = _torch(arrs)
    o, lse = fa.flash_attention_lse(*ts, causal=False)
    ((o * torch.tensor(wo)).sum() + (lse * torch.tensor(wl)).sum()).backward()

    def run(q, k, v):
        return flash_attention_lse(q, k, v, causal=False, block_q=64,
                                   block_k=64)

    def loss(q, k, v):
        oj, lj = run(q, k, v)
        return jnp.sum(oj * wo) + jnp.sum(lj * wl)

    jargs = [jnp.asarray(a) for a in arrs]
    jo, jl = run(*jargs)
    _close(o.detach(), jo, 2e-5)
    _close(lse.detach(), jl, 2e-5)
    g = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    for t, gj in zip(ts, g):
        _close(t.grad, gj, 2e-4)


def test_kernel_head_dim_is_the_least_width_not_below():
    for D in range(8, 257, 8):
        w = fa.kernel_head_dim(D)
        assert w in fa.KERNEL_HEAD_DIMS and w >= D
        assert all(x < D for x in fa.KERNEL_HEAD_DIMS if x < w)
    assert [fa.kernel_head_dim(D) for D in (8, 16, 24, 80, 96, 136, 256)] \
        == [16, 16, 32, 128, 128, 256, 256]


@pytest.mark.parametrize("D", [20, 264, 0, -8, 4])
def test_kernel_head_dim_names_the_limit(D):
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        fa.kernel_head_dim(D)


def test_fwd_block_k_follows_the_kernel():
    assert [fa.fwd_block_k(D) for D in (16, 96, 128, 136, 256)] == \
        [128, 128, 128, 64, 64]


def test_impl_and_variant_of_the_fp32_do_route():
    bf, f32 = torch.bfloat16, torch.float32
    for k in ("dq", "dkv"):
        assert fa.variant(k, bf, f32, True) == f"{k} wgmma f32do causal"
        assert fa.variant(k, bf, f32, False) == f"{k} wgmma f32do"
        assert fa.variant(k, bf, bf, True) == f"{k} wgmma causal"
    # fp32 q/k/v: dQ and dK/dV run on wgmma as bf16 planes.
    assert fa.variant("dq", f32, f32, False) == "dq wgmma fp32"
    assert fa.variant("dkv", f32, f32, False) == "dkv wgmma fp32"
    assert fa.variant("fwd", bf, causal=False, out_f32=True) == \
        "fwd wgmma f32out"


def test_split_plain_holds_do():
    """hi is bf16(x) exactly, and hi + lo is within 2⁻¹⁶·|x| of x (each
    rounding to bf16 keeps 8 bits; two keep about 16)."""
    rs = np.random.RandomState(30)
    x = torch.tensor(rs.randn(3, 50, 2, 24).astype(np.float32)
                     * np.exp(rs.uniform(-20, 20, (3, 50, 2, 24)))
                     .astype(np.float32))
    hi, lo = fa._split_plain(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())


def test_plain_forward_walks_the_kernels_blocks_at_d_over_128():
    """bf16 at D 136 (the width-256 kernels): the plain forward rounds P
    against the running max of blocks of 64 keys, as the kernel does, and
    so matches JAX's Pallas forward run with blocks of 64 to two bf16 ulps
    (``test_bf16_plain_versions_match_jax_flash``'s bound)."""
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import flash_attention

    arrs = _np_qkv(seed=31, S=192, H=1, D=136)
    out = fa.flash_attention(*_torch(arrs, torch.bfloat16), causal=False)
    want = flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                           causal=False, block_q=64, block_k=64)
    got = out.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_array_less(np.abs(got - want),
                                 2 * 2.0 ** -7 * (np.abs(want) + rms))


def test_cpu_split_is_not_launched():
    ts = _torch(_np_qkv(seed=32, S=64), torch.bfloat16)
    o, lse = fa.flash_attention_lse(*ts)
    (o.sum() + lse.sum()).backward()
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0, "split": 0}


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_kernel_close(got, want, slack=0.0):
    """``chip_smoke.TOL``: rtol·|want| + atol·rms(want) + slack, (2⁻⁷,
    1e-3) for bf16 outputs and (1e-4, 1e-4) for fp32."""
    rtol, atol = (2.0 ** -7, 1e-3) if got.dtype == torch.bfloat16 else \
        (1e-4, 1e-4)
    got, want = got.float(), want.float()
    allowed = (rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
               + slack)
    worst = float(((got - want).abs() / allowed).max())
    assert worst <= 1.0, f"worst element at {worst:.3f} of its tolerance"


def _check_all(q, k, v, causal, lse_route):
    """The forward, dQ and dK/dV kernels against the plain versions on the
    same inputs, with a nonzero dlse; ``lse_route``: fp32 output and dO."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    gen = torch.Generator(device=q.device).manual_seed(q.shape[-1])
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, lse_route)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, causal, lse_route)
    do = torch.randn(q.shape, device=q.device, generator=gen)
    do = do if lse_route else do.to(q.dtype)
    dlse = torch.randn(plse.shape, device=q.device, generator=gen)
    args = (q, k, v, do, plse, (do.float() * po.float()).sum(-1), dlse,
            scale, causal)
    slack = fa.rounding_slack(*args)
    _assert_kernel_close(o, po, slack["o"])
    _assert_kernel_close(lse, plse)
    _assert_kernel_close(fa.flash_dq_cuda(*args), fa._flash_dq_plain(*args),
                         slack["dq"])
    dk, dv = fa.flash_dkv_cuda(*args)
    pdk, pdv = fa._flash_dkv_plain(*args)
    _assert_kernel_close(dk, pdk, slack["dk"])
    _assert_kernel_close(dv, pdv, slack["dv"])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 80, 96, 136, 200, 256])
def test_cuda_kernels_at_any_head_dim(cuda_device, D, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    q, k, v = (torch.randn(2, 300, 3, D, device=cuda_device, generator=gen)
               .to(dt) for _ in range(3))
    for causal in (True, False):
        _check_all(q, k, v, causal, lse_route=False)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_fp32_do_kernels_match_plain(cuda_device, D, causal):
    """bf16 q/k/v with the lse variant's fp32 output and dO, a dlse and a
    ragged S: the wgmma f32do instantiations."""
    gen = torch.Generator(device=cuda_device).manual_seed(D + 1)
    q, k, v = (torch.randn(2, 200, 3, D, device=cuda_device, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    _check_all(q, k, v, causal, lse_route=True)
    assert fa.launches["split"] == 2  # the dQ and the dK/dV wrapper's own


@pytest.mark.cuda
def test_cuda_split_matches_plain_bit_for_bit(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    x = torch.randn(2, 130, 3, 40, device=cuda_device, generator=gen)
    x = x * torch.exp(torch.randn(x.shape, device=cuda_device,
                                  generator=gen) * 10)
    for do in (x, x[:, 1:]):  # contiguous, and a view the wrapper copies
        planes = fa.split_do_cuda(do)
        hi, lo = fa._split_plain(do)
        assert torch.equal(planes[0], hi) and torch.equal(planes[1], lo)
