"""Decoder-only Transformer LM: the port of
``horovod_tpu/models/transformer.py`` (training path).

Pre-RMSNorm blocks with RoPE, a SiLU-gated dense FFN, tied input embedding
and vocabulary projection, fp32 parameters and norms, and compute in
``cfg.compute_dtype`` (bf16 by default).  Parameter layouts are the JAX
package's, one layer at a time: ``wq/wk/wv`` ``[D, H, HD]``, ``wo``
``[H, HD, D]``, ``w_in/w_gate`` ``[D, F]``, ``w_out`` ``[F, D]``, ``embed``
``[V, D]``.  ``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``).

Attention follows the JAX package's rules.  ``attn_impl="flash"`` runs the
flash kernels of :mod:`horovod_tpu_torch.ops.flash_attention` where the
mesh shards neither heads (``tp``) nor the sequence (``sp``);
``"ring"`` and ``"ulysses"`` run sequence-parallel attention
(:mod:`horovod_tpu_torch.parallel.ring_attention`) where ``sp > 1``;
everything else is dense masked softmax in PyTorch, so ``"ring"`` without
a sequence axis is dense attention.  With a mesh, ``tokens`` are this
rank's ``[B, S_local]`` slice of a ``P('dp', 'sp')`` batch and RoPE rotates
each position at its place in the whole sequence.  Dense and flash
attention over a sequence-sharded batch (which GSPMD gathers in the JAX
package) raise.

Not ported yet (see ROADMAP.md): the Switch MoE FFN (``n_experts > 0``),
tensor-parallel sharding, and the decode path.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import ring_attention as ra
from horovod_tpu_torch.parallel.mesh import Mesh, mesh_axis_size


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
    # "ring" / "ulysses": sequence parallel where the mesh has sp > 1.
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
    if cfg.attn_impl not in ("dense", "ring", "ulysses", "flash"):
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

    def forward(self, tokens: torch.Tensor, *, mesh: Optional[Mesh] = None,
                remat: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply(self, tokens, mesh=mesh, remat=remat)


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


def _rope(x, theta: float, offset: int = 0):
    """Rotary embedding over head_dim halves; x: [B, S, H, HD] at positions
    ``offset + arange(S)``, fp32 math, cast back to x's dtype."""
    B, S, H, HD = x.shape
    half = HD // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(offset, offset + S, dtype=torch.float32,
                       device=x.device)
    ang = pos[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention_fn(cfg: TransformerConfig, mesh: Optional[Mesh]):
    """The JAX package's dispatch: flash where neither tp nor sp shards,
    ring or Ulysses where sp > 1, dense otherwise."""
    sp = 1 if mesh is None else mesh_axis_size(mesh, "sp")
    tp = 1 if mesh is None else mesh_axis_size(mesh, "tp")
    if cfg.attn_impl in ("ring", "ulysses") and sp > 1:
        return ra.make_sharded_attention(mesh, impl=cfg.attn_impl,
                                         causal=True, head_axis="tp")
    if sp > 1:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} over a sequence-sharded batch "
            "(sp > 1) needs the whole sequence's keys; use 'ring' or "
            "'ulysses' (see ROADMAP.md, Queue 1)")
    if cfg.attn_impl == "flash" and tp == 1:
        return functools.partial(flash_attention, causal=True)
    return functools.partial(ra.full_attention, causal=True)


def _attention(x, blk: Block, cfg: TransformerConfig, attend, offset: int):
    dtype = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, blk.wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, blk.wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, blk.wv.to(dtype))
    q = _rope(q, cfg.rope_theta, offset)
    k = _rope(k, cfg.rope_theta, offset)
    ctx = attend(q, k, v)
    return torch.einsum("bshk,hkd->bsd", ctx, blk.wo.to(dtype))


def _dense_ffn(x, blk: Block, dtype):
    h = x @ blk.w_in.to(dtype)
    g = x @ blk.w_gate.to(dtype)
    return (h * F.silu(g)) @ blk.w_out.to(dtype)


def _layer(x, blk: Block, cfg: TransformerConfig, attend, offset: int):
    x = x + _attention(_rmsnorm(x, blk.ln1), blk, cfg, attend, offset)
    return x + _dense_ffn(_rmsnorm(x, blk.ln2), blk, cfg.compute_dtype)


def apply(model: Transformer, tokens: torch.Tensor, *,
          mesh: Optional[Mesh] = None, remat: Optional[bool] = None):
    """Forward pass.  ``tokens``: [B, S] integer, this rank's slice of a
    ``P('dp', 'sp')`` batch when ``mesh`` is given (the rank at sp index
    ``i`` holds positions ``i*S .. (i+1)*S - 1``).  Returns
    ``(logits_fp32, aux_loss)`` for those tokens; ``remat`` defaults to
    ``cfg.remat``."""
    cfg = model.cfg
    if remat is None:
        remat = cfg.remat
    attend = _attention_fn(cfg, mesh)
    offset = 0 if mesh is None else \
        mesh.coords.get("sp", 0) * tokens.shape[1]
    x = model.embed[tokens].to(cfg.compute_dtype)
    for blk in model.layers:
        if remat:
            x = checkpoint(_layer, x, blk, cfg, attend, offset,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(x, blk, cfg, attend, offset)
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


def loss_fn(model: Transformer, tokens, targets, *,
            mesh: Optional[Mesh] = None, aux_weight: float = 0.01):
    """Mean cross-entropy over this rank's tokens (see :func:`apply`)."""
    logits, aux = apply(model, tokens, mesh=mesh)
    return softmax_xent(logits, targets) + aux_weight * aux
