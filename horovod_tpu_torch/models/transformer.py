"""Decoder-only Transformer LM: the port of
``horovod_tpu/models/transformer.py`` (training path).

Pre-RMSNorm blocks with RoPE, a SiLU-gated FFN (dense, or Switch-style
top-1 mixture of experts with ``n_experts > 0``), tied input embedding and
vocabulary projection, fp32 parameters and norms, and compute in
``cfg.compute_dtype`` (bf16 by default).  Parameter layouts are the JAX
package's, one layer at a time: ``wq/wk/wv`` ``[D, H, HD]``, ``wo``
``[H, HD, D]``, ``w_in/w_gate`` ``[D, F]`` and ``w_out`` ``[F, D]`` (MoE:
``router`` ``[D, E]``, ``w_in/w_gate`` ``[E, D, F]``, ``w_out``
``[E, F, D]``), ``embed`` ``[V, D]``.  ``remat`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``).

**Over a mesh** every rank holds its shard of the parameters, cut by
:func:`param_specs` (the JAX package's, without the stacked layer axis),
and ``tokens`` are its ``[B/dp, S/sp]`` slice of a ``P('dp', 'sp')`` batch,
replicated over ``tp`` and ``ep``.  Where the JAX package let GSPMD insert
collectives, the port calls them:

* ``tp`` (Megatron): each rank's block holds its ``H/tp`` heads and
  ``F/tp`` FFN columns of ``w_in/w_gate`` and rows of ``w_out``;
  :func:`~horovod_tpu_torch.ops.collective.copy_to_axis` (identity
  forward, allreduce backward) enters each column-parallel product and
  :func:`~horovod_tpu_torch.ops.collective.reduce_from_axis` (allreduce
  forward, identity backward) leaves each row-parallel one.  ``embed`` is
  split by vocabulary: the lookup masks the rows a rank does not hold and
  allreduces, the tied projection gives each rank its ``V/tp`` logits, and
  :func:`softmax_xent` reduces the row max, the exponent sums and the
  target logit over ``tp``.
* ``ep``: each rank holds ``E/ep`` experts (split over ``tp`` too) and runs
  them on its tokens; their outputs are summed over ``ep`` x ``tp``.
* ``sp``: RoPE rotates each position at its place in the whole sequence.
  Attention follows the JAX package's dispatch: ``"ring"`` and
  ``"ulysses"`` run sequence-parallel attention
  (:mod:`horovod_tpu_torch.parallel.ring_attention`) where ``sp > 1``;
  ``"flash"`` runs the flash kernels of
  :mod:`horovod_tpu_torch.ops.flash_attention` where the mesh shards
  neither heads nor the sequence; everything else is dense masked softmax
  in PyTorch, over K/V all-gathered along ``sp`` where the sequence is
  sharded (what GSPMD does there).

A ``pp`` axis holds whole replicas here, as the JAX package's
``param_specs`` name no ``pp``; :mod:`horovod_tpu_torch.parallel.pipeline`
splits the layers over it.

**Decoding** (:func:`generate`, :func:`prefill_request`, :func:`decode_step`,
the JAX package's KV-cache path) runs dense attention over a cache laid out
``[L, B, Smax, H, HD]`` (:data:`KV_CACHE_SPEC`: heads over ``tp``), under
``torch.inference_mode()``; :mod:`horovod_tpu_torch.serving` batches it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import ring_attention as ra
from horovod_tpu_torch.parallel.mesh import (Axis, Mesh, mesh_axis_size,
                                             present_axes, shard)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    n_experts: int = 0          # 0 → dense FFN; >0 → Switch-style MoE
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


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Which dimension of each parameter is split over which mesh axis: the
    JAX package's ``param_specs`` (Megatron tp layout, experts over ep) for
    one layer, as tuples of axis names or None per dimension."""
    layer = {"ln1": (None,), "ln2": (None,),
             "wq": (None, "tp", None), "wk": (None, "tp", None),
             "wv": (None, "tp", None), "wo": ("tp", None, None)}
    if cfg.n_experts:
        layer.update(router=(None, None), w_in=("ep", None, "tp"),
                     w_gate=("ep", None, "tp"), w_out=("ep", "tp", None))
    else:
        layer.update(w_in=(None, "tp"), w_gate=(None, "tp"),
                     w_out=("tp", None))
    return {"embed": ("tp", None), "layers": layer, "ln_f": (None,)}


def spec_of(specs: Dict[str, Any], key: str) -> Tuple:
    """The spec of a ``state_dict`` key (``layers.<i>.<name>`` or a
    top-level name)."""
    if key.startswith("layers."):
        return specs["layers"][key.split(".")[-1]]
    return specs[key]


def shard_state_dict(state_dict: Dict[str, torch.Tensor],
                     cfg: TransformerConfig, mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of a whole model's ``state_dict``."""
    specs = param_specs(cfg)
    return {k: shard(v, spec_of(specs, k), mesh).contiguous()
            for k, v in state_dict.items()}


def check_mesh(cfg: TransformerConfig, mesh) -> None:
    """Raise for what the model does not run over ``mesh``: sizes the
    split axes do not divide."""
    if cfg.attn_impl not in ("dense", "ring", "ulysses", "flash"):
        raise ValueError(f"attn_impl must be dense/ring/ulysses/flash, got "
                         f"{cfg.attn_impl!r}")
    if mesh is None:
        return
    tp, ep = mesh_axis_size(mesh, "tp"), mesh_axis_size(mesh, "ep")
    split = {"n_heads": (cfg.n_heads, tp), "d_ff": (cfg.d_ff, tp),
             "vocab_size": (cfg.vocab_size, tp)}
    if cfg.n_experts:
        split["n_experts"] = (cfg.n_experts, ep)
    for name, (n, k) in split.items():
        if n % k:
            raise ValueError(f"{name} {n} is not divisible by the mesh's "
                             f"axis size {k}")


class Block(nn.Module):
    """One pre-norm decoder layer's parameters (fp32): this rank's shard
    over ``tp`` heads and FFN width and ``ep`` experts."""

    def __init__(self, cfg: TransformerConfig, tp: int = 1, ep: int = 1):
        super().__init__()
        D, HD = cfg.d_model, cfg.head_dim
        H, Fd = cfg.n_heads // tp, cfg.d_ff // tp
        e = dict(dtype=torch.float32)
        self.ln1 = nn.Parameter(torch.ones(D, **e))
        self.ln2 = nn.Parameter(torch.ones(D, **e))
        self.wq = nn.Parameter(torch.empty(D, H, HD, **e))
        self.wk = nn.Parameter(torch.empty(D, H, HD, **e))
        self.wv = nn.Parameter(torch.empty(D, H, HD, **e))
        self.wo = nn.Parameter(torch.empty(H, HD, D, **e))
        if cfg.n_experts:
            El = cfg.n_experts // ep
            self.router = nn.Parameter(torch.empty(D, cfg.n_experts, **e))
            self.w_in = nn.Parameter(torch.empty(El, D, Fd, **e))
            self.w_gate = nn.Parameter(torch.empty(El, D, Fd, **e))
            self.w_out = nn.Parameter(torch.empty(El, Fd, D, **e))
        else:
            self.w_in = nn.Parameter(torch.empty(D, Fd, **e))
            self.w_gate = nn.Parameter(torch.empty(D, Fd, **e))
            self.w_out = nn.Parameter(torch.empty(Fd, D, **e))


class Transformer(nn.Module):
    """The model: ``embed``, ``layers[i]`` and ``ln_f``, this rank's shard
    of them over ``mesh`` (the whole model without one).
    ``forward(tokens)`` returns ``(logits_fp32, aux_loss)``."""

    def __init__(self, cfg: TransformerConfig, mesh: Optional[Mesh] = None):
        super().__init__()
        check_mesh(cfg, mesh)
        self.cfg = cfg
        tp = 1 if mesh is None else mesh_axis_size(mesh, "tp")
        ep = 1 if mesh is None else mesh_axis_size(mesh, "ep")
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size // tp, cfg.d_model, dtype=torch.float32))
        self.layers = nn.ModuleList(Block(cfg, tp, ep)
                                    for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32))

    def forward(self, tokens: torch.Tensor, *, mesh: Optional[Mesh] = None,
                remat: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply(self, tokens, mesh=mesh, remat=remat)


def init(seed: int, cfg: TransformerConfig, *, device=None,
         mesh: Optional[Mesh] = None) -> Transformer:
    """A model with random weights from ``seed``: normal with std 0.02, the
    output projections scaled by 1/sqrt(2 L), norms at one (the JAX
    package's recipe; its random numbers differ).  The whole model's
    weights are drawn on the CPU, so every device and rank gets the same
    ones; over ``mesh`` the rank keeps its shard (:func:`param_specs`)."""
    dev = resolve_device(device, "transformer.init()")
    check_mesh(cfg, mesh)
    model = Transformer(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    with torch.no_grad():
        for blk in model.layers:
            for name in ("wq", "wk", "wv"):
                getattr(blk, name).normal_(0.0, std, generator=gen)
            blk.wo.normal_(0.0, out_std, generator=gen)
            if cfg.n_experts:
                blk.router.normal_(0.0, std, generator=gen)
            blk.w_in.normal_(0.0, std, generator=gen)
            blk.w_gate.normal_(0.0, std, generator=gen)
            blk.w_out.normal_(0.0, out_std, generator=gen)
        model.embed.normal_(0.0, std, generator=gen)
    if mesh is not None and present_axes(mesh, ("tp", "ep")):
        whole = model.state_dict()
        model = Transformer(cfg, mesh)
        model.load_state_dict(shard_state_dict(whole, cfg, mesh))
    return model.to(dev)


@dataclass(frozen=True)
class _Layout:
    """The mesh as one forward pass sees it.  ``tp``: the axis of the
    Megatron regions (None where absent); ``experts``: ep x tp, over which
    the expert outputs are summed; ``data``: dp x sp, the axes that split
    the batch; ``dp``/``sp``: their sizes and this rank's coordinates;
    ``ep_index``: this rank's expert block."""

    tp: Optional[Axis] = None
    experts: Optional[Axis] = None
    data: Optional[Axis] = None
    data_names: Tuple[str, ...] = ()
    dp: Tuple[int, int] = (1, 0)
    sp: Tuple[int, int] = (1, 0)
    ep_index: int = 0


def _layout(mesh: Optional[Mesh], data=("dp", "sp")) -> _Layout:
    """The layout of a forward over ``mesh`` whose batch is split over the
    axes of ``data`` (the pipeline's cells: ``dp`` alone)."""
    if mesh is None:
        return _Layout()

    def axis(names):
        names = present_axes(mesh, names)
        return (mesh.axis(*names), names) if names else (None, ())

    def size_coord(name):
        if name not in data:
            return (1, 0)
        return (mesh_axis_size(mesh, name), mesh.coords.get(name, 0))

    data_axis, data_names = axis(data)
    return _Layout(
        tp=axis(("tp",))[0], experts=axis(("ep", "tp"))[0], data=data_axis,
        data_names=data_names, dp=size_coord("dp"), sp=size_coord("sp"),
        ep_index=mesh.coords.get("ep", 0))


def _rmsnorm(x, g):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * g).to(x.dtype)


def _rotate(x, theta: float, pos):
    """Rotary embedding over head_dim halves of x ``[B, S, H, HD]`` at the
    fp32 positions ``pos`` ``[B or 1, S]``: fp32 math, cast back to x's
    dtype."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None] * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _rope(x, theta: float, offset: int = 0):
    """RoPE of x ``[B, S, H, HD]`` at positions ``offset + arange(S)``."""
    S = x.shape[1]
    return _rotate(x, theta, torch.arange(
        offset, offset + S, dtype=torch.float32, device=x.device)[None])


def _attention_fn(cfg: TransformerConfig, mesh: Optional[Mesh]):
    """The JAX package's dispatch: ring or Ulysses where sp > 1, flash
    where neither tp nor sp shards, dense otherwise (over K/V gathered
    along sp where the sequence is sharded)."""
    sp = 1 if mesh is None else mesh_axis_size(mesh, "sp")
    tp = 1 if mesh is None else mesh_axis_size(mesh, "tp")
    if cfg.attn_impl in ("ring", "ulysses") and sp > 1:
        return ra.make_sharded_attention(mesh, impl=cfg.attn_impl,
                                         causal=True, head_axis="tp")
    if sp > 1:
        return functools.partial(ra.gathered_attention, axis=mesh.axis("sp"),
                                 causal=True)
    if cfg.attn_impl == "flash" and tp == 1:
        return functools.partial(flash_attention, causal=True)
    return functools.partial(ra.full_attention, causal=True)


def _project_qkv(x, blk: Block, dtype, tp: Optional[Axis]):
    """q, k, v ``[B, S, H, HD]`` in ``dtype`` (this rank's heads over
    ``tp``), before RoPE."""
    x = C.copy_to_axis(x, tp)
    return tuple(torch.einsum("bsd,dhk->bshk", x, w.to(dtype))
                 for w in (blk.wq, blk.wk, blk.wv))


def _project_out(ctx, blk: Block, dtype, tp: Optional[Axis]):
    return C.reduce_from_axis(
        torch.einsum("bshk,hkd->bsd", ctx, blk.wo.to(dtype)), tp)


def _attention(x, blk: Block, cfg: TransformerConfig, attend, offset: int,
               tp: Optional[Axis]):
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(x, blk, dtype, tp)
    q = _rope(q, cfg.rope_theta, offset)
    k = _rope(k, cfg.rope_theta, offset)
    return _project_out(attend(q, k, v), blk, dtype, tp)


def _dense_ffn(x, blk: Block, dtype, tp: Optional[Axis]):
    x = C.copy_to_axis(x, tp)
    h = x @ blk.w_in.to(dtype)
    g = x @ blk.w_gate.to(dtype)
    return C.reduce_from_axis((h * F.silu(g)) @ blk.w_out.to(dtype), tp)


def _expert_positions(expert, B: int, S: int, E: int, lay: _Layout):
    """Each token's place in its expert's buffer: the number of tokens
    before it in the global batch's flat order ``b * S_global + s`` that
    chose the same expert (the JAX package's cumsum over the whole batch).
    The ranks of ``dp`` x ``sp`` exchange their per-row counts by expert,
    so that each adds the tokens of earlier rows and of the row's earlier
    sequence blocks to its own running count."""
    onehot = F.one_hot(expert, E).view(B, S, E)
    counts = onehot.sum(1)                                     # [B, E]
    (dp, i), (sp, j) = lay.dp, lay.sp
    if lay.data is not None:
        g = C.allgather(counts[None], axis=lay.data)           # [n, B, E]
        g = g.view(*[{"dp": dp, "sp": sp}[a] for a in lay.data_names],
                   B, E)
        if lay.data_names == ("sp", "dp"):
            g = g.transpose(0, 1)
        counts = g.reshape(dp, sp, B, E)
    else:
        counts = counts.view(1, 1, B, E)
    # [dp * B rows, sp blocks, E] in the global flat order.
    flat = counts.transpose(1, 2).reshape(dp * B * sp, E)
    before = (flat.cumsum(0) - flat).view(dp * B, sp, E)[i * B:(i + 1) * B, j]
    pos = before[:, None, :] + onehot.cumsum(1) - 1            # [B, S, E]
    return pos.gather(-1, expert.view(B, S, 1)).view(B * S)


def _global_sum(t, lay: _Layout, differentiable: bool = False):
    """``t`` summed over the ranks that split the batch.  Differentiable:
    the backward sums the ranks' gradients too (see
    :func:`horovod_tpu_torch.parallel.train.make_transformer_train_step`
    for why the rank-averaged gradient is then the global loss's)."""
    if lay.data is None:
        return t
    if differentiable:
        return dist_nn.all_reduce(t, op=dist.ReduceOp.SUM,
                                  group=lay.data.group)
    return C.allreduce(t, op=ReduceOp.SUM, axis=lay.data)


def _route(gates):
    """Top-1 routing: each token's expert (the first of equal gates, as
    ``argmax`` picks) and its gate."""
    return torch.argmax(gates, dim=-1), torch.amax(gates, dim=-1)


def _moe_ffn(x, blk: Block, cfg: TransformerConfig, lay: _Layout,
             stats: Optional[List[Dict[str, torch.Tensor]]] = None):
    """Switch-style top-1 MoE with static capacity: the JAX package's
    ``_moe_ffn`` over the global batch.  The capacity ``C`` and each
    token's place in its expert's buffer (:func:`_expert_positions`) are
    the global batch's, so every rank drops exactly the tokens that the
    JAX package drops.  The dispatch gathers the kept tokens into each
    expert's ``[C, D]`` buffer (empty slots zero) and the combine gathers
    each token's row back, where the JAX package multiplies one-hot masks:
    the same values.  This rank runs its ``E/ep`` experts (their ``F/tp``
    columns); the router and gates are replicated, enter the experts'
    region through :func:`~horovod_tpu_torch.ops.collective.copy_to_axis`
    and leave it summed over ep x tp.  The aux loss (Switch eq. 4) takes
    ``density`` and ``density_proxy`` over the global batch.  With
    ``stats``, appends this layer's dropped tokens (global), aux loss and
    this rank's tokens' experts."""
    B, S, D = x.shape
    E = cfg.n_experts
    dtype = cfg.compute_dtype
    (dp, _), (sp, _) = lay.dp, lay.sp
    Bg, Sg = B * dp, S * sp
    T, Tg = B * S, Bg * Sg
    cap = max(1, int(cfg.capacity_factor * Sg * Bg / E))

    xf = x.reshape(T, D)
    gates = torch.softmax(xf.float() @ blk.router.float(), dim=-1)  # [T, E]
    expert, gate = _route(gates)
    pos = _expert_positions(expert, B, S, E, lay)
    keep = pos < cap

    El = blk.w_in.shape[0]
    local = expert - lay.ep_index * El
    mine = keep & (local >= 0) & (local < El)
    trash = El * cap
    slot = torch.where(mine, local * cap + pos, trash)          # [T]
    # src[s]: the token in slot s, or T (a zero row) where it is empty.
    src = torch.full((trash + 1,), T, dtype=torch.long, device=x.device)
    src.scatter_(0, slot, torch.arange(T, device=x.device))
    xin = C.copy_to_axis(xf, lay.experts)
    xin = torch.cat([xin, xin.new_zeros(1, D)])
    # index_select, whose backward adds rows (index_add), not the
    # indexing backward's sort: only the discarded zero row and trash slot
    # take more than one row.
    xe = xin.index_select(0, src[:trash]).view(El, cap, D)
    h = torch.bmm(xe, blk.w_in.to(dtype))
    g = torch.bmm(xe, blk.w_gate.to(dtype))
    ye = torch.bmm(h * F.silu(g), blk.w_out.to(dtype)).view(trash, D)
    ye = torch.cat([ye, ye.new_zeros(1, D)])
    gate_in = C.copy_to_axis(gate, lay.experts)
    y = C.reduce_from_axis(
        ye.index_select(0, slot) * gate_in.to(dtype)[:, None], lay.experts)

    density = _global_sum(F.one_hot(expert, E).sum(0).float(), lay) / Tg
    proxy = _global_sum(gates.sum(0), lay, differentiable=True) / Tg
    aux = E * torch.sum(density * proxy)
    if stats is not None:
        dropped = _global_sum((~keep).sum().reshape(1), lay)
        stats.append({"dropped": dropped[0], "tokens": Tg,
                      "aux": aux.detach(), "expert": expert})
    return y.view(B, S, D), aux


def _layer(x, blk: Block, cfg: TransformerConfig, attend, offset: int,
           lay: _Layout, stats=None):
    x = x + _attention(_rmsnorm(x, blk.ln1), blk, cfg, attend, offset, lay.tp)
    h = _rmsnorm(x, blk.ln2)
    if cfg.n_experts:
        y, aux = _moe_ffn(h, blk, cfg, lay, stats)
    else:
        y, aux = _dense_ffn(h, blk, cfg.compute_dtype, lay.tp), None
    return x + y, aux


def _embed(embed, tokens, tp: Optional[Axis]):
    """Vocabulary-parallel lookup: each rank of ``tp`` holds rows ``[i V_l,
    (i + 1) V_l)``, gives zeros for the tokens it does not hold, and the
    ranks' results are summed."""
    if tp is None:
        return embed[tokens]
    n = embed.shape[0]
    local = tokens - tp.index * n
    inside = (local >= 0) & (local < n)
    x = torch.where(inside[..., None], embed[local.clamp(0, n - 1)], 0.0)
    return C.reduce_from_axis(x, tp)


def apply(model: Transformer, tokens: torch.Tensor, *,
          mesh: Optional[Mesh] = None, remat: Optional[bool] = None,
          stats: Optional[List[Dict[str, torch.Tensor]]] = None):
    """Forward pass.  ``tokens``: [B, S] integer, this rank's slice of a
    ``P('dp', 'sp')`` batch when ``mesh`` is given (the rank at sp index
    ``i`` holds positions ``i*S .. (i+1)*S - 1``).  Returns
    ``(logits_fp32, aux_loss)`` for those tokens: over ``tp`` the rank's
    ``V/tp`` vocabulary columns (:func:`softmax_xent` takes them);
    ``aux_loss`` is the sum over the layers of the MoE load-balancing loss
    of the global batch (zero for the dense FFN).  ``remat`` defaults to
    ``cfg.remat``.  ``stats``: a list to which each MoE layer appends its
    routing (use it with remat off: a recomputed layer appends again)."""
    cfg = model.cfg
    if remat is None:
        remat = cfg.remat
    lay = _layout(mesh)
    attend = _attention_fn(cfg, mesh)
    offset = lay.sp[1] * tokens.shape[1]
    x = _embed(model.embed, tokens, lay.tp).to(cfg.compute_dtype)
    aux = x.new_zeros((), dtype=torch.float32)
    for blk in model.layers:
        if remat:
            x, a = checkpoint(_layer, x, blk, cfg, attend, offset, lay, stats,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _layer(x, blk, cfg, attend, offset, lay, stats)
        if a is not None:
            aux = aux + a
    x = _rmsnorm(x, model.ln_f)
    return vocab_projection(C.copy_to_axis(x, lay.tp), model.embed), aux


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
    """Final [B, S, D] → [B, S, V] projection, fp32 logits (over the rows
    of ``embed`` given: a tp rank's shard gives its vocabulary block)."""
    B, S, D = x.shape
    e = embed.to(x.dtype)
    return _VocabProjection.apply(x.reshape(B * S, D), e).view(B, S, -1)


def softmax_xent(logits, targets, axis: Optional[Axis] = None):
    """Mean softmax cross-entropy in logsumexp form.  With ``axis`` (tp),
    ``logits`` are this rank's block ``[i V_l, (i + 1) V_l)`` of the
    vocabulary: the row max is MAX-allreduced (a constant of the
    logsumexp, no gradient), and the exponent sums and the target logit
    (zero on the ranks that do not hold it) are summed over ``axis``."""
    if axis is None or axis.size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
        return torch.mean(lse - target_logit)
    n = logits.shape[-1]
    m = C.allreduce(logits.detach().amax(-1), op=ReduceOp.MAX, axis=axis)
    se = C.reduce_from_axis(torch.exp(logits - m[..., None]).sum(-1), axis)
    lse = m + torch.log(se)
    local = targets - axis.index * n
    inside = (local >= 0) & (local < n)
    tl = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    tl = C.reduce_from_axis(torch.where(inside, tl, 0.0), axis)
    return torch.mean(lse - tl)


def loss_fn(model: Transformer, tokens, targets, *,
            mesh: Optional[Mesh] = None, aux_weight: float = 0.01):
    """Mean cross-entropy over this rank's tokens plus ``aux_weight`` times
    the aux loss (see :func:`apply`)."""
    logits, aux = apply(model, tokens, mesh=mesh)
    tp = mesh.axis("tp") if mesh is not None and \
        mesh_axis_size(mesh, "tp") > 1 else None
    return softmax_xent(logits, targets, tp) + aux_weight * aux


# ---------------------------------------------------------------------------
# Autoregressive generation (KV cache)
# ---------------------------------------------------------------------------
#
# The JAX package's decode path, with its rounding points: q/k/v and the
# rotated K/V in the compute dtype, scores in the compute dtype then fp32,
# the -1e30 mask over the whole cache length (Smax shapes the softmax's
# reduction), fp32 softmax cast back to the compute dtype, and fp32
# vocabulary logits for the last position only.  Dense FFN and dense
# attention: no flash kernel runs here.  The entry points run under
# torch.inference_mode() and write the caches in place (the JAX package
# donates them).  Over a mesh with ``tp``, each rank holds its H/tp heads of
# the cache and the layers are the training path's Megatron regions; the
# vocabulary logits are gathered over ``tp``.

# [L, B, Smax, H, HD], heads over tp.
KV_CACHE_SPEC = (None, None, None, "tp", None)


def _rope_rows(x, theta: float, pos):
    """RoPE of one token per row, row ``b`` at position ``pos[b]``: x
    ``[B, 1, H, HD]``, pos ``[B]`` integer."""
    return _rotate(x, theta, pos.float()[:, None])


def _attend_cache(q, k_cache, v_cache, valid):
    """One query per row against the whole cache: q ``[B, 1, H, HD]``,
    caches ``[B, Smax, H, HD]``, ``valid`` ``[B or 1, Smax]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshk,bthk->bhst", q, k_cache).float() * scale
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v_cache)


def _attention_cached(x, blk: Block, cfg: TransformerConfig, k_cache,
                      v_cache, pos: int, tp: Optional[Axis] = None):
    """One token's attention against the cache: x ``[B, 1, D]``, caches
    ``[B, Smax, H, HD]`` (valid through ``pos``, written at ``pos`` in
    place), ``pos`` the token's position (one for every row)."""
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(x, blk, dtype, tp)
    q = _rope(q, cfg.rope_theta, pos)
    k = _rope(k, cfg.rope_theta, pos)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    valid = torch.arange(k_cache.shape[1], device=x.device)[None] <= pos
    return _project_out(_attend_cache(q, k_cache, v_cache, valid), blk,
                        dtype, tp)


def _attention_cached_slots(x, blk: Block, cfg: TransformerConfig, k_cache,
                            v_cache, pos, tp: Optional[Axis] = None):
    """:func:`_attention_cached` with a position per slot: ``pos`` ``[B]``,
    RoPE row by row, each row's cache written at its own position."""
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(x, blk, dtype, tp)
    q = _rope_rows(q, cfg.rope_theta, pos)
    k = _rope_rows(k, cfg.rope_theta, pos)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache.index_put_((rows, pos), k[:, 0])
    v_cache.index_put_((rows, pos), v[:, 0])
    valid = (torch.arange(k_cache.shape[1], device=x.device)[None, :]
             <= pos[:, None])                                   # [B, Smax]
    return _project_out(_attend_cache(q, k_cache, v_cache, valid), blk,
                        dtype, tp)


def _decode_tp(model, mesh: Optional[Mesh]) -> Optional[Axis]:
    """The ``tp`` axis a decode runs its Megatron regions over (None
    without one)."""
    if model.cfg.n_experts:
        raise NotImplementedError(
            "generate() supports dense-FFN configs; MoE decode needs "
            "per-step routing with capacity 1")
    return _layout(mesh).tp


def _head(model, x, tp: Optional[Axis]):
    """fp32 next-token logits ``[B, V]`` of the last position of ``x``,
    the whole vocabulary (gathered over ``tp``)."""
    x = _rmsnorm(x[:, -1:], model.ln_f)
    logits = vocab_projection(C.copy_to_axis(x, tp), model.embed)[:, 0]
    return logits if tp is None else C.allgather_dim(logits, -1, tp)


def _prefill(model, tokens, Smax: int, tp: Optional[Axis] = None):
    """Forward over the prompt ``tokens`` ``[B, S]``: the next-token
    logits of the last position (fp32, ``[B, V]``) and each layer's rotated
    K/V, zero past ``S``, as caches ``[L, B, Smax, H, HD]``."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    B, S = tokens.shape
    L, HD = len(model.layers), cfg.head_dim
    H = model.layers[0].wq.shape[1]
    ks = torch.zeros((L, B, Smax, H, HD), dtype=dtype, device=tokens.device)
    vs = torch.zeros_like(ks)
    x = _embed(model.embed, tokens, tp).to(dtype)
    for i, blk in enumerate(model.layers):
        q, k, v = _project_qkv(_rmsnorm(x, blk.ln1), blk, dtype, tp)
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
        ctx = ra.full_attention(q, k, v, causal=True)
        x = x + _project_out(ctx, blk, dtype, tp)
        x = x + _dense_ffn(_rmsnorm(x, blk.ln2), blk, dtype, tp)
    return _head(model, x, tp), ks, vs


def _sample(logits, temperature: float, generator):
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@torch.inference_mode()
def generate(model, prompt, *, max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             cache_len: Optional[int] = None, device=None) -> torch.Tensor:
    """Autoregressive decode.  ``prompt``: ``[B, S0]`` integer (a tensor or
    anything ``torch.as_tensor`` takes).  Returns ``[B, S0 +
    max_new_tokens]`` (prompt and generated tokens) on the model's device.
    ``temperature=0`` is greedy argmax; otherwise sampling from
    ``softmax(logits / temperature)`` with ``generator``, which the caller
    must pass (its stream is torch's, not the JAX package's).

    ``cache_len`` pins the KV cache's length (default: ``S0 +
    max_new_tokens``).  The positions past the tokens are masked, but the
    length still shapes the softmax's reduction, so a comparison with a
    serving cache (:class:`horovod_tpu_torch.serving.DecodeEngine`) passes
    the serving length.  Runs on ``device`` (default: the card), where the
    model must be.  Dense-FFN configs only."""
    tp = _decode_tp(model, None)
    cfg = model.cfg
    dev = resolve_device(device, "generate()")
    if model.embed.device != dev:
        raise ValueError(f"the model is on {model.embed.device}, not {dev}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs generator (a "
                         "torch.Generator)")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    prompt = torch.as_tensor(prompt, device=dev)
    B, S0 = prompt.shape
    Smax = S0 + max_new_tokens
    if Smax > cfg.max_seq_len:
        raise ValueError(
            f"prompt + new tokens ({Smax}) exceeds max_seq_len "
            f"({cfg.max_seq_len})")
    if cache_len is not None:
        if cache_len < Smax:
            raise ValueError(
                f"cache_len ({cache_len}) is shorter than prompt + new "
                f"tokens ({Smax})")
        Smax = cache_len
    dtype = cfg.compute_dtype
    logits, ks, vs = _prefill(model, prompt, Smax, tp)
    tok = _sample(logits, temperature, generator)
    out = [tok]
    for pos in range(S0, S0 + max_new_tokens - 1):
        x = _embed(model.embed, tok[:, None], tp).to(dtype)
        for i, blk in enumerate(model.layers):
            x = x + _attention_cached(_rmsnorm(x, blk.ln1), blk, cfg, ks[i],
                                      vs[i], pos, tp)
            x = x + _dense_ffn(_rmsnorm(x, blk.ln2), blk, dtype, tp)
        tok = _sample(_head(model, x, tp), temperature, generator)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, 1).to(prompt.dtype)], dim=1)


@torch.inference_mode()
def decode_step(model, tok, pos, ks, vs, *, mesh: Optional[Mesh] = None):
    """One continuous-batching step: embed ``tok`` ``[B]``, attend each
    slot at its own position ``pos`` ``[B]``, and return (next-token logits
    ``[B, V]`` fp32, ``ks``, ``vs``), the caches ``[L, B, Smax, H, HD]``
    written in place.  The layer is :func:`generate`'s with the per-slot
    attention.  ``model``: a :class:`Transformer` or its
    :func:`decode_weights`."""
    tp = _decode_tp(model, mesh)
    cfg = model.cfg
    dtype = cfg.compute_dtype
    x = _embed(model.embed, tok[:, None], tp).to(dtype)
    for i, blk in enumerate(model.layers):
        x = x + _attention_cached_slots(_rmsnorm(x, blk.ln1), blk, cfg,
                                        ks[i], vs[i], pos, tp)
        x = x + _dense_ffn(_rmsnorm(x, blk.ln2), blk, dtype, tp)
    return _head(model, x, tp), ks, vs


@torch.inference_mode()
def prefill_request(model, prompt, cache_len: int, *,
                    mesh: Optional[Mesh] = None):
    """Prefill one request, ``prompt`` ``[S0]`` integer on the model's
    device: (next-token logits ``[V]`` fp32, K/V caches ``[L, 1,
    cache_len, H, HD]``) to be written into a serving batch's slot."""
    logits, ks, vs = _prefill(model, prompt[None], cache_len,
                              _decode_tp(model, mesh))
    return logits[0], ks, vs


_NORMS = ("ln1", "ln2", "ln_f")


def decode_weights(model: Transformer, device) -> Any:
    """The model's parameters for decoding on ``device``: the matrices
    (``embed``, ``wq/wk/wv/wo``, ``w_in/w_gate/w_out``) cast once to the
    compute dtype, the norms fp32, with ``cfg``, ``embed``, ``layers`` and
    ``ln_f`` as the decode functions read them.  The decode path casts each
    matrix to the compute dtype where it uses it, so this gives the same
    values without a cast of every matrix every step."""
    dtype = model.cfg.compute_dtype

    def cast(name, p):
        p = p.detach()
        return p.to(device) if name in _NORMS else p.to(device, dtype)

    layers = [SimpleNamespace(**{n: cast(n, p)
                                 for n, p in blk.named_parameters()})
              for blk in model.layers]
    return SimpleNamespace(cfg=model.cfg, layers=layers,
                           embed=cast("embed", model.embed),
                           ln_f=cast("ln_f", model.ln_f))
