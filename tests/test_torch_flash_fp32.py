"""The port's flash attention for float32 q/k/v.

Float32 q/k/v run the tensor-core (wgmma) forward, dQ and dK/dV as three
bf16 planes each (hi, mid, lo: each the bf16 rounding of what the planes
before it leave), made by one split pass, and every product as six bf16
products, the plane pairs whose magnitudes multiply to at least 2⁻¹⁶ of the
term.  On the CPU:

* the split's plain version, and a plain emulation of that arithmetic
  (defined here) held against the plain versions at ``chip_smoke.py``'s
  float32 shapes and head dims 32, 64 and 256: every element must land
  within ``chip_smoke.TOL["float32"]``, at most a quarter of it, over all
  outputs and over dQ alone.  Without any one mid plane the emulation
  fails that tolerance, without any one lo plane it exceeds the quarter,
  and with two planes (hi, lo; three products, the scheme of the lse
  variant's fp32 dO) it fails the tolerance too.  This is the design's
  precision budget, shown without a card;
* ``impl`` and ``variant`` for float32;
* the port's float32 forward and gradients through ``flash_attention`` and
  ``flash_attention_lse`` (with a dlse) against the JAX package's Pallas
  kernels in interpret mode, at 2e-5 on outputs and 2e-4 on gradients (the
  JAX package's own flash-vs-dense tolerances: sums in other orders).

The ``cuda`` cases hold the kernels against their plain versions on the
card at head dims 8-256 on both routes, and skip where torch finds no CUDA
device.  JAX is imported inside the tests only.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa

F32 = torch.float32


@pytest.fixture(autouse=True)
def _counts():
    fa.reset_launch_counts()
    yield
    fa.reset_launch_counts()


def _worst(got, want):
    """The worst element's share of ``chip_smoke.TOL["float32"]``:
    |got - want| over rtol·|want| + atol·rms(want); at most 1 passes."""
    rtol, atol = chip_smoke.TOL["float32"]
    got, want = got.double(), want.double()
    allowed = rtol * want.abs() + atol * float(want.pow(2).mean().sqrt())
    return float(((got - want).abs() / allowed).max())


# ---------------------------------------------------------------------------
# the split and the precision budget
# ---------------------------------------------------------------------------


def test_split_plain_holds_x():
    """hi is bf16(x) exactly, and the three planes sum to x exactly (24
    bits, fp32's own), for q, k and v split as the kernel lays them out."""
    rs = np.random.RandomState(40)
    q, k, v = (torch.tensor(rs.randn(2, 30, 3, 24).astype(np.float32)
                            * np.exp(rs.uniform(-20, 20, (2, 30, 3, 24)))
                            .astype(np.float32)) for _ in range(3))
    planes = fa._split_qkv_plain(q, k, v)
    assert planes.shape == (3, 3, 2, 30, 3, 24)
    assert planes.dtype == torch.bfloat16
    for x, (hi, mid, lo) in zip((q, k, v), planes):
        assert torch.equal(hi, x.to(torch.bfloat16))
        assert torch.equal(hi.double() + mid.double() + lo.double(),
                           x.double())


# The kernels' plane pairs (plane of a, plane of b; hi 0, mid 1, lo 2):
# pair_a and pair_b in csrc/flash_wgmma.cu.
PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))


def _prod(eq, a, b, drop_a=None, drop_b=None, planes=3):
    """The kernels' product of fp32 ``a`` and ``b``: the einsum ``eq`` of
    each plane pair, each product of two bf16 values exact in fp32 and the
    sums in fp32.  ``drop_a``/``drop_b``: a plane of a or b left out.
    ``planes`` 2: hi and lo with three products, hi·hi + lo·hi + hi·lo."""
    pa = [t.float() for t in fa._split_plain(a, planes)]
    pb = [t.float() for t in fa._split_plain(b, planes)]
    pairs = PAIRS if planes == 3 else ((0, 0), (1, 0), (0, 1))
    out = 0
    for i, j in pairs:
        if i != drop_a and j != drop_b:
            out = out + torch.einsum(eq, pa[i], pb[j])
    return out


def _masked(s, causal):
    if causal:
        S = s.shape[-1]
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _emulated(args, drop=None, planes=3):
    """The fp32 forward's o and lse, dQ and dK/dV's dk and dv as the
    kernels compute them, by name: every product over the plane pairs,
    P = exp(S - m) and dS unrounded (P masked to zero before it splits).
    ``drop``: (operand, plane) left out of every product it enters."""
    q, k, v, do, lse, delta, dlse, scale, causal = args

    def prod(eq, a, an, b, bn):
        def gone(name):
            return drop[1] if drop and drop[0] == name else None
        return _prod(eq, a, b, gone(an), gone(bn), planes)

    s = _masked(prod("bshd,bthd->bhst", q, "q", k, "k") * scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = {"o": (prod("bhst,bthd->bhsd", p, "p", v, "v") / l).transpose(1, 2),
           "lse": (m + torch.log(l)).squeeze(-1).transpose(1, 2)}
    p = torch.exp(s - fa._bhs1(lse))
    dp = prod("bshd,bthd->bhst", do, "do", v, "v")
    ds = p * (dp - fa._bhs1(delta - dlse))
    out["dq"] = prod("bhst,bthd->bshd", ds, "ds", k, "k") * scale
    out["dv"] = prod("bhst,bshd->bthd", p, "p", do, "do")
    out["dk"] = prod("bhst,bshd->bthd", ds, "ds", q, "q") * scale
    return out


# chip_smoke.py's float32 shapes (S, D, causal, with dlse) and width 256.
# B and H are cut to 1 and 2: an element's error depends on the lengths of
# its sums (S and D), and B and H only add rows.
BUDGET_SHAPES = [(1000, 32, False, True), (1024, 64, True, False),
                 (1000, 256, False, True)]


def _budget(S, D, causal, with_dlse, drop=None, planes=3, outputs=None):
    """The worst share of the tolerance over ``outputs`` (all of o, lse,
    dq, dk and dv by default) of the emulation against the plain versions
    on inputs from a numpy seed."""
    rs = np.random.RandomState(S + D)
    q, k, v, do = (torch.tensor(rs.randn(1, S, 2, D).astype(np.float32))
                   for _ in range(4))
    dlse = torch.tensor(rs.randn(1, S, 2).astype(np.float32) if with_dlse
                        else np.zeros((1, S, 2), np.float32))
    scale = 1.0 / math.sqrt(D)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, causal)
    args = (q, k, v, do, plse, (do * po).sum(-1), dlse, scale, causal)
    want = dict(zip(("o", "lse", "dq", "dk", "dv"),
                    (po, plse, fa._flash_dq_plain(*args))
                    + fa._flash_dkv_plain(*args)))
    got = _emulated(args, drop, planes)
    return max(_worst(got[name], want[name]) for name in outputs or want)


@pytest.mark.parametrize("S,D,causal,with_dlse", BUDGET_SHAPES)
def test_three_plane_products_fit_the_fp32_tolerance(S, D, causal,
                                                     with_dlse):
    worst = _budget(S, D, causal, with_dlse)
    assert worst <= 0.25, f"worst element at {worst:.3f} of TOL"


OPERANDS = ["q", "k", "v", "do", "p", "ds"]


@pytest.mark.parametrize("operand", OPERANDS)
def test_dropping_a_mid_plane_fails_the_fp32_tolerance(operand):
    worst = _budget(*BUDGET_SHAPES[0], drop=(operand, 1))
    assert worst > 1.0, f"without {operand}'s mid plane: {worst:.3f} of TOL"


@pytest.mark.parametrize("operand", OPERANDS)
def test_dropping_a_lo_plane_exceeds_the_budget(operand):
    """At the flagship's width (causal, S 1024, D 64) each lo plane is
    needed for the quarter of the tolerance."""
    worst = _budget(*BUDGET_SHAPES[1], drop=(operand, 2))
    assert worst > 0.25, f"without {operand}'s lo plane: {worst:.3f} of TOL"


def test_two_planes_fail_the_fp32_tolerance():
    """hi and lo alone (about 2⁻¹⁶ of each term off) put an element of
    dK past the tolerance at the flagship's width."""
    worst = _budget(*BUDGET_SHAPES[1], planes=2)
    assert worst > 1.0, f"two planes: {worst:.3f} of TOL"


# dQ's products: S = Q·Kᵀ, dP = dO·Vᵀ and dQ = dS·K.
DQ_OPERANDS = ["q", "k", "v", "do", "ds"]


@pytest.mark.parametrize("S,D,causal,with_dlse", BUDGET_SHAPES)
def test_dq_three_plane_products_fit_the_fp32_tolerance(S, D, causal,
                                                        with_dlse):
    worst = _budget(S, D, causal, with_dlse, outputs=("dq",))
    assert worst <= 0.25, f"dq's worst element at {worst:.3f} of TOL"


@pytest.mark.parametrize("operand", DQ_OPERANDS)
@pytest.mark.parametrize("shape", BUDGET_SHAPES)
def test_dq_without_a_mid_plane_fails_the_fp32_tolerance(shape, operand):
    worst = _budget(*shape, drop=(operand, 1), outputs=("dq",))
    assert worst > 1.0, (f"dq without {operand}'s mid plane: {worst:.3f} "
                         "of TOL")


@pytest.mark.parametrize("operand", DQ_OPERANDS)
def test_dq_without_a_lo_plane_exceeds_the_budget(operand):
    """At the flagship's width each lo plane is needed for dQ's quarter of
    the tolerance too."""
    worst = _budget(*BUDGET_SHAPES[1], drop=(operand, 2), outputs=("dq",))
    assert worst > 0.25, (f"dq without {operand}'s lo plane: {worst:.3f} "
                          "of TOL")


def test_dq_two_planes_fail_the_fp32_tolerance():
    worst = _budget(*BUDGET_SHAPES[1], planes=2, outputs=("dq",))
    assert worst > 1.0, f"dq with two planes: {worst:.3f} of TOL"


def test_impl_and_variant_for_fp32():
    """Every fp32 kernel runs on the tensor cores as bf16 planes."""
    assert fa.variant("fwd", F32, causal=True) == "fwd wgmma fp32 causal"
    # The lse variant's fp32 output is the same instantiation.
    assert fa.variant("fwd", F32, causal=False, out_f32=True) == \
        "fwd wgmma fp32"
    assert fa.variant("dkv", F32, F32, True) == "dkv wgmma fp32 causal"
    assert fa.variant("dq", F32, F32, True) == "dq wgmma fp32 causal"


def test_split_wrappers_reject_cpu_tensors():
    x = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.split_qkv_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA float32"):
        fa.split_do_cuda(x)
    assert fa.launches["split"] == 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("lse_route", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 96])
def test_fp32_forward_and_grads_match_jax(D, causal, lse_route):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas_attention import (flash_attention,
                                                  flash_attention_lse)

    rs = np.random.RandomState(D + 2 * causal + lse_route)
    arrs = [rs.randn(1, 96, 2, D).astype(np.float32) for _ in range(3)]
    wo = rs.randn(*arrs[0].shape).astype(np.float32)
    wl = rs.randn(*arrs[0].shape[:3]).astype(np.float32)
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]

    def run(q, k, v):
        fn = flash_attention_lse if lse_route else flash_attention
        return fn(q, k, v, causal=causal, block_q=64, block_k=64)

    def loss(q, k, v):
        if lse_route:
            oj, lj = run(q, k, v)
            return jnp.sum(oj * wo) + jnp.sum(lj * wl)
        return jnp.sum(run(q, k, v) * wo)

    jargs = [jnp.asarray(a) for a in arrs]
    if lse_route:
        o, lse = fa.flash_attention_lse(*ts, causal=causal)
        ((o * torch.tensor(wo)).sum()
         + (lse * torch.tensor(wl)).sum()).backward()
        jo, jl = run(*jargs)
        _close(lse.detach(), jl, 2e-5)
    else:
        o = fa.flash_attention(*ts, causal=causal)
        (o * torch.tensor(wo)).sum().backward()
        jo = run(*jargs)
    assert o.dtype == F32
    _close(o.detach(), jo, 2e-5)
    g = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    for t, gj in zip(ts, g):
        _close(t.grad, gj, 2e-4)
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


def _check_fp32(q, k, v, causal, lse_route, seed):
    """The forward, dQ and dK/dV kernels against the plain versions on the
    same fp32 inputs, with a nonzero dlse; ``lse_route`` draws the inputs
    as ``flash_attention_lse`` is called (the kernels are the same)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    gen = torch.Generator(device=q.device).manual_seed(seed)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, lse_route)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, causal, lse_route)
    do = torch.randn(q.shape, device=q.device, generator=gen)
    dlse = torch.randn(plse.shape, device=q.device, generator=gen)
    args = (q, k, v, do, plse, (do * po).sum(-1), dlse, scale, causal)
    got = {"o": o, "lse": lse, "dq": fa.flash_dq_cuda(*args)}
    got["dk"], got["dv"] = fa.flash_dkv_cuda(*args)
    want = {"o": po, "lse": plse, "dq": fa._flash_dq_plain(*args)}
    want["dk"], want["dv"] = fa._flash_dkv_plain(*args)
    torch.cuda.synchronize()
    for name, t in got.items():
        assert t.dtype == F32
        worst = _worst(t, want[name])
        assert worst <= 1.0, f"{name}: worst element at {worst:.3f} of TOL"


@pytest.mark.cuda
@pytest.mark.parametrize("lse_route", [False, True])
@pytest.mark.parametrize("D", [8, 16, 24, 32, 64, 96, 128, 136, 200, 256])
def test_cuda_fp32_kernels_match_plain(cuda_device, D, lse_route):
    gen = torch.Generator(device=cuda_device).manual_seed(D + 7 * lse_route)
    q, k, v = (torch.randn(2, 300, 3, D, device=cuda_device, generator=gen)
               for _ in range(3))
    for causal in (True, False):
        _check_fp32(q, k, v, causal, lse_route, seed=D)
    # Each wrapper split q/k/v, and dQ and dK/dV each their dO.
    assert fa.variant_launches["split qkv"] == 6
    assert fa.variant_launches["split"] == 4


@pytest.mark.cuda
def test_cuda_fp32_autograd_splits_once(cuda_device):
    """A forward and backward split q/k/v once (the forward's planes serve
    dQ and dK/dV) and dO once (for both)."""
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    ts = [torch.randn(2, 256, 4, 64, device=cuda_device, generator=gen)
          .requires_grad_() for _ in range(3)]
    o, lse = fa.flash_attention_lse(*ts)
    (o.sum() + lse.sum()).backward()
    torch.cuda.synchronize()
    assert fa.variant_launches == {
        "split qkv": 1, "fwd wgmma fp32 causal": 1, "split": 1,
        "dq wgmma fp32 causal": 1, "dkv wgmma fp32 causal": 1}
    assert all(bool(t.grad.isfinite().all()) for t in ts)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 256])
def test_cuda_fp32_dq_takes_the_planes_it_is_given(cuda_device, D):
    """dQ from fp32 q/k/v and dO as they are (the wrapper splits them) and
    from their planes split beforehand, as the backward passes them: the
    same dQ bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(43 + D)
    q, k, v, do = (torch.randn(2, 200, 3, D, device=cuda_device,
                               generator=gen) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    po, plse = fa._flash_fwd_plain(q, k, v, scale, True)
    dlse = torch.randn(plse.shape, device=cuda_device, generator=gen)
    args = (q, k, v, do, plse, (do * po).sum(-1), dlse, scale, True)
    alone = fa.flash_dq_cuda(*args)
    assert fa.variant_launches == {"split qkv": 1, "split": 1,
                                   "dq wgmma fp32 causal": 1}
    given = fa.flash_dq_cuda(*args, do_planes=fa.split_do_cuda(do, 3),
                             qkv_planes=fa.split_qkv_cuda(q, k, v))
    torch.cuda.synchronize()
    assert torch.equal(alone, given)
    assert fa.variant_launches == {"split qkv": 2, "split": 2,
                                   "dq wgmma fp32 causal": 2}


@pytest.mark.cuda
def test_cuda_qkv_split_matches_plain_bit_for_bit(cuda_device):
    """One launch splits q, k and v, here strided views into one packed
    [B, S, 3, H, D] tensor."""
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    x = torch.randn(2, 130, 3, 2, 40, device=cuda_device, generator=gen)
    x = x * torch.exp(torch.randn(x.shape, device=cuda_device,
                                  generator=gen) * 10)
    q, k, v = x.unbind(2)
    planes = fa.split_qkv_cuda(q, k, v)
    assert torch.equal(planes, fa._split_qkv_plain(q, k, v))
    assert fa.variant_launches == {"split qkv": 1}


@pytest.mark.cuda
def test_cuda_fp32_raises_on_strides_the_split_cannot_take(cuda_device):
    """A head stride of 34 fp32 values (136 bytes) is no whole number of
    16-byte units."""
    x = torch.zeros(1, 64, 2, 34, device=cuda_device)[..., :32]
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(x, x, x)
    assert fa.launches == {"fwd": 0, "dq": 0, "dkv": 0, "split": 0}
