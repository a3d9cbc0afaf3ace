"""Decoder-only Transformer LM: the port of
``horovod_tpu/models/transformer.py`` (training path).

Pre-RMSNorm blocks with RoPE, a SiLU-gated dense FFN, tied input embedding
and vocabulary projection, fp32 parameters and norms, and compute in
``cfg.compute_dtype`` (bf16 by default).  Parameter layouts are the JAX
package's, one layer at a time: ``wq/wk/wv`` ``[D, H, HD]``, ``wo``
``[H, HD, D]``, ``w_in/w_gate`` ``[D, F]``, ``w_out`` ``[F, D]``, ``embed``
``[V, D]``.  ``attn_impl="flash"`` runs the flash kernels of
:mod:`horovod_tpu_torch.ops.flash_attention`; ``"dense"`` is masked softmax
in PyTorch.  ``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``).

Not ported yet (see ROADMAP.md): the Switch MoE FFN (``n_experts > 0``),
sequence-parallel attention (``ring``, ``ulysses``), tensor-parallel
sharding, and the decode path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.basics import resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    n_experts: int = 0          # 0 → dense FFN; >0 → Switch MoE (not ported)
    capacity_factor: float = 1.25
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16
    # "dense": masked softmax in PyTorch; "flash": the flash kernels;
    # "ring" / "ulysses": sequence parallel (not ported).
    attn_impl: str = "dense"
    # Recompute each layer in the backward pass.
    remat: bool = True

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "the Switch MoE FFN (n_experts > 0) is not ported yet; see "
            "ROADMAP.md, Queue 1")
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (sequence parallelism) is not "
            "ported yet; see ROADMAP.md, Queue 1")
    if cfg.attn_impl not in ("dense", "flash"):
        raise ValueError(f"attn_impl must be dense/ring/ulysses/flash, got "
                         f"{cfg.attn_impl!r}")


class Block(nn.Module):
    """One pre-norm decoder layer's parameters (fp32)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        D, H, HD, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        e = dict(dtype=torch.float32)
        self.ln1 = nn.Parameter(torch.ones(D, **e))
        self.ln2 = nn.Parameter(torch.ones(D, **e))
        self.wq = nn.Parameter(torch.empty(D, H, HD, **e))
        self.wk = nn.Parameter(torch.empty(D, H, HD, **e))
        self.wv = nn.Parameter(torch.empty(D, H, HD, **e))
        self.wo = nn.Parameter(torch.empty(H, HD, D, **e))
        self.w_in = nn.Parameter(torch.empty(D, Fd, **e))
        self.w_gate = nn.Parameter(torch.empty(D, Fd, **e))
        self.w_out = nn.Parameter(torch.empty(Fd, D, **e))


class Transformer(nn.Module):
    """The model: ``embed``, ``layers[i]`` and ``ln_f``.  ``forward(tokens)``
    returns ``(logits_fp32 [B, S, V], aux_loss)``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=torch.float32))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32))

    def forward(self, tokens: torch.Tensor, *, remat: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply(self, tokens, remat=remat)


def init(seed: int, cfg: TransformerConfig, *, device=None) -> Transformer:
    """A model with random weights from ``seed``: normal with std 0.02, the
    output projections scaled by 1/sqrt(2 L), norms at one (the JAX
    package's recipe; its random numbers differ).  The weights are drawn on
    the CPU, so every device and rank gets the same ones."""
    dev = resolve_device(device, "transformer.init()")
    model = Transformer(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    with torch.no_grad():
        for blk in model.layers:
            for name in ("wq", "wk", "wv"):
                getattr(blk, name).normal_(0.0, std, generator=gen)
            blk.wo.normal_(0.0, out_std, generator=gen)
            blk.w_in.normal_(0.0, std, generator=gen)
            blk.w_gate.normal_(0.0, std, generator=gen)
            blk.w_out.normal_(0.0, out_std, generator=gen)
        model.embed.normal_(0.0, std, generator=gen)
    return model.to(dev)


def _rmsnorm(x, g):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * g).to(x.dtype)


def _rope(x, theta: float):
    """Rotary embedding over head_dim halves; x: [B, S, H, HD], fp32 math,
    cast back to x's dtype."""
    B, S, H, HD = x.shape
    half = HD // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(x, blk: Block, cfg: TransformerConfig):
    dtype = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, blk.wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, blk.wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, blk.wv.to(dtype))
    q = _rope(q, cfg.rope_theta)
    k = _rope(k, cfg.rope_theta)
    if cfg.attn_impl == "flash":
        from horovod_tpu_torch.ops.flash_attention import flash_attention

        ctx = flash_attention(q, k, v, causal=True)
    else:  # "dense"; the constructor rejected every other value
        S = x.shape[1]
        scale = 1.0 / math.sqrt(cfg.head_dim)
        logits = torch.einsum("bshk,bthk->bhst", q, k).float() * scale
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        ctx = torch.einsum("bhst,bthk->bshk", probs, v)
    return torch.einsum("bshk,hkd->bsd", ctx, blk.wo.to(dtype))


def _dense_ffn(x, blk: Block, dtype):
    h = x @ blk.w_in.to(dtype)
    g = x @ blk.w_gate.to(dtype)
    return (h * F.silu(g)) @ blk.w_out.to(dtype)


def _layer(x, blk: Block, cfg: TransformerConfig):
    x = x + _attention(_rmsnorm(x, blk.ln1), blk, cfg)
    return x + _dense_ffn(_rmsnorm(x, blk.ln2), blk, cfg.compute_dtype)


def apply(model: Transformer, tokens: torch.Tensor, *,
          remat: Optional[bool] = None):
    """Forward pass.  ``tokens``: [B, S] integer.  Returns
    ``(logits_fp32, aux_loss)``; ``remat`` defaults to ``cfg.remat``."""
    cfg = model.cfg
    if remat is None:
        remat = cfg.remat
    x = model.embed[tokens].to(cfg.compute_dtype)
    for blk in model.layers:
        if remat:
            x = checkpoint(_layer, x, blk, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(x, blk, cfg)
    x = _rmsnorm(x, model.ln_f)
    return vocab_projection(x, model.embed), x.new_zeros((), dtype=torch.float32)


class _VocabProjection(torch.autograd.Function):
    """[N, D] x [V, D]ᵀ → fp32 [N, V] logits from compute-dtype inputs with
    fp32 accumulation (the JAX package's ``preferred_element_type``).  On
    the card one ``torch.mm(..., out_dtype=torch.float32)``; on the CPU,
    where that overload does not exist, the same products in fp32 (the
    bf16 → fp32 cast is exact).  The backward takes the logits' gradient in
    the compute dtype."""

    @staticmethod
    def forward(ctx, x2, emb):
        ctx.save_for_backward(x2, emb)
        if x2.is_cuda:
            return torch.mm(x2, emb.t(), out_dtype=torch.float32)
        return x2.float() @ emb.float().t()

    @staticmethod
    def backward(ctx, g):
        x2, emb = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ emb, g.t() @ x2


def vocab_projection(x, embed):
    """Final [B, S, D] → [B, S, V] projection, fp32 logits."""
    B, S, D = x.shape
    e = embed.to(x.dtype)
    return _VocabProjection.apply(x.reshape(B * S, D), e).view(B, S, -1)


def softmax_xent(logits, targets):
    """Mean softmax cross-entropy in logsumexp form."""
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - target_logit)


def loss_fn(model: Transformer, tokens, targets, *, aux_weight: float = 0.01):
    logits, aux = apply(model, tokens)
    return softmax_xent(logits, targets) + aux_weight * aux
