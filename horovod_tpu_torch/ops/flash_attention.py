"""Flash attention: the port of ``horovod_tpu/ops/pallas_attention.py``.

Three hand-written CUDA kernels for Hopper (``csrc/flash_attention.cu``)
replace the three Pallas kernels of the JAX package: the forward
(``_fwd_kernel``), the dQ kernel (``_dq_kernel``) and the dK/dV kernel
(``_dkv_kernel``).  Beside each stands its plain PyTorch version, written as
the explicit formulas, in fp32:

* forward:  S = Q Kᵀ·scale, causal key j visible to query i iff j <= i,
  O = softmax(S) V, lse = logsumexp(S);
* dQ:   P = exp(S - lse), dP = dO Vᵀ, dS = P ⊙ (dP - delta + dlse),
  dQ = dS K·scale, with delta = rowsum(dO ⊙ O);
* dK/dV:  dV = Pᵀ dO, dK = dSᵀ Q·scale.

Which one runs depends only on where the tensors lie: CPU tensors take the
plain versions, CUDA tensors launch the kernels, and a kernel that cannot
take its input, fails to build or fails to launch raises.  There is no
fallback from the card to the plain versions.

Layout at the public functions is the JAX package's: q/k/v ``[B, S, H, D]``
and lse ``[B, S, H]``.  The kernels read ``[B, S, H, D]`` through strides,
so no head-major copy is made.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel, counted where the wrapper launches it.
launches = {"fwd": 0, "dq": 0, "dkv": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain versions (fp32 math; they serve CPU tensors and are the oracle)
# ---------------------------------------------------------------------------


def _scores(q, k, scale, causal):
    """fp32 S = Q Kᵀ·scale as ``[B, H, Sq, Sk]``, masked keys at -inf."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _bsh(x):
    """``[B, H, S]`` statistics as contiguous ``[B, S, H]``."""
    return x.transpose(1, 2).contiguous()


def _bhs1(x):
    """``[B, S, H]`` statistics as ``[B, H, S, 1]`` for broadcasting."""
    return x.transpose(1, 2).unsqueeze(-1)


def _flash_fwd_plain(q, k, v, scale: float, causal: bool,
                     out_f32: bool = False):
    """Dense masked softmax with its lse: ``(o [B,S,H,D], lse [B,S,H])``."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    o = torch.einsum("bhst,bthd->bshd", p, v.float())
    return o.to(torch.float32 if out_f32 else q.dtype), _bsh(lse)


def _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal):
    p = torch.exp(_scores(q, k, scale, causal) - _bhs1(lse))
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    c = delta if dlse is None else delta - dlse
    return p, p * (dp - _bhs1(c))


def _flash_dq_plain(q, k, v, do, lse, delta, dlse, scale: float,
                    causal: bool):
    """dQ = Σ_k dS·K·scale with dS = P ⊙ (dO Vᵀ - delta + dlse)."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal)
    dq = torch.einsum("bhst,bthd->bshd", ds, k.float()) * scale
    return dq.to(q.dtype)


def _flash_dkv_plain(q, k, v, do, lse, delta, dlse, scale: float,
                     causal: bool):
    """dV = Σ_q Pᵀ·dO and dK = Σ_q dSᵀ·Q·scale."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal)
    dv = torch.einsum("bhst,bshd->bthd", p, do.float())
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_qkv(q, k, v, do=None):
    """Raise on anything the kernels do not take.  ``dO`` may be float32
    where q is bfloat16: the gradient of the lse variant's fp32 output."""
    named = (("q", q), ("k", k), ("v", v)) + (() if do is None
                                              else (("dO", do),))
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype and not (name == "dO"
                                       and t.dtype == torch.float32):
            raise ValueError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"q has {tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim "
                             f"(strides {t.stride()})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernels take float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if B * S * H == 0:
        raise ValueError(f"empty input {tuple(q.shape)}")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"input of {q.numel()} elements exceeds the "
                         "kernels' 32-bit row indexing")
    return B, S, H, D


def _check_stat(name, t, like):
    B, S, H, _ = like.shape
    if t.dtype != torch.float32 or t.shape != (B, S, H) or \
            not t.is_contiguous() or t.device != like.device:
        raise ValueError(f"{name} must be contiguous float32 [B, S, H] on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _strides(*ts):
    vals = [x for t in ts for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash {name} kernel launch failed: CUDA error "
                           f"{err}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_fwd_cuda(q, k, v, scale: float, causal: bool,
                   out_f32: bool = False):
    """Forward kernel: ``(o [B,S,H,D], lse [B,S,H] fp32)``."""
    from horovod_tpu_torch.ops import _build

    B, S, H, D = _check_qkv(q, k, v)
    lib = _build.lib()
    o = torch.empty((B, S, H, D), device=q.device,
                    dtype=torch.float32 if out_f32 else q.dtype)
    lse = torch.empty((B, S, H), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _strides(q, k, v), B, S, H, D, float(scale),
            int(causal), _DTYPE_CODE[q.dtype], int(out_f32),
            _stream(q.device))
    launches["fwd"] += 1
    _raise_on(err, "forward")
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, dlse):
    B, S, H, D = _check_qkv(q, k, v, do)
    _check_stat("lse", lse, q)
    _check_stat("delta", delta, q)
    if dlse is not None:
        _check_stat("dlse", dlse, q)
    return B, S, H, D


def flash_dq_cuda(q, k, v, do, lse, delta, dlse, scale: float,
                  causal: bool):
    """dQ kernel.  ``dlse`` may be None (the lse received no gradient)."""
    from horovod_tpu_torch.ops import _build

    B, S, H, D = _bwd_args(q, k, v, do, lse, delta, dlse)
    lib = _build.lib()
    dq = torch.empty((B, S, H, D), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if dlse is None else dlse.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do), B, S, H, D, float(scale), int(causal),
            _DTYPE_CODE[q.dtype], int(do.dtype != q.dtype),
            _stream(q.device))
    launches["dq"] += 1
    _raise_on(err, "dQ")
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, dlse, scale: float,
                   causal: bool):
    """dK/dV kernel: ``(dk, dv)``.  ``dlse`` may be None."""
    from horovod_tpu_torch.ops import _build

    B, S, H, D = _bwd_args(q, k, v, do, lse, delta, dlse)
    lib = _build.lib()
    dk = torch.empty((B, S, H, D), device=q.device, dtype=k.dtype)
    dv = torch.empty((B, S, H, D), device=q.device, dtype=v.dtype)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if dlse is None else dlse.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, do), B, S, H, D, float(scale),
            int(causal), _DTYPE_CODE[q.dtype], int(do.dtype != q.dtype),
            _stream(q.device))
    launches["dkv"] += 1
    _raise_on(err, "dK/dV")
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"flash attention inputs on mixed devices: {devs}")


class _FlashAttention(torch.autograd.Function):
    """Custom backward running the two backward kernels (the port of the
    JAX package's ``_flash`` custom VJP).  Both outputs carry gradients:
    an lse cotangent adds the ``P·dlse`` term."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, out_f32):
        if _on_cpu(q, k, v):
            o, lse = _flash_fwd_plain(q, k, v, scale, causal, out_f32)
        else:
            o, lse = flash_fwd_cuda(q, k, v, scale, causal, out_f32)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        # An output that received no gradient arrives as None, not zeros.
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            dlse = dlse.float().contiguous()
        args = (q, k, v, do, lse, delta, dlse, ctx.scale, ctx.causal)
        if _on_cpu(q, k, v, do):
            dq = _flash_dq_plain(*args)
            dk, dv = _flash_dkv_plain(*args)
        else:
            dq = flash_dq_cuda(*args)
            dk, dv = flash_dkv_cuda(*args)
        return dq, dk, dv, None, None, None


def _run(q, k, v, causal, scale, out_f32):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 bool(out_f32))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise flash attention.  ``q/k/v``: [B, S, H, D].

    Returns the [B, S, H, D] context in q's dtype.  Differentiable; the
    backward runs the dQ and dK/dV kernels on the card."""
    o, _ = _run(q, k, v, causal, scale, out_f32=False)
    return o


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but returns the fp32 context and the
    per-query logsumexp ``[B, S, H]`` (fp32).  Both outputs carry
    gradients."""
    return _run(q, k, v, causal, scale, out_f32=True)
