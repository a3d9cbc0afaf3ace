"""Sequence parallelism: the port of
``horovod_tpu/parallel/ring_attention.py``.

* **Ring attention** (:func:`ring_attention`): K/V blocks travel around the
  ``sp`` ring, one neighbour per hop (:func:`~horovod_tpu_torch.ops.
  collective.ppermute_ring`); each hop's local block runs the flash kernels
  through :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention_lse`
  (fp32 output and logsumexp), and the hops compose exactly through their
  logsumexps (:func:`_combine_partials`, fp32).  The backward runs each
  hop's dQ and dK/dV kernels with an fp32 dO and an lse cotangent, and
  ``ppermute_ring``'s backward carries each K/V gradient back, hop by hop,
  to the rank that owns the block.
* **Ulysses** (:func:`ulysses_attention`): one all-to-all turns sequence
  sharding into head sharding, dense attention runs locally on each head
  group (PyTorch, no kernel, as in the JAX package), and a second all-to-all
  turns it back.  Needs ``heads % sp == 0`` (under tensor parallelism, the
  heads of one tp rank).
* **Gathered dense attention** (:func:`gathered_attention`): K/V
  all-gathered over ``sp``, what GSPMD does for the JAX package's dense
  attention over a sequence-sharded batch.

There are no global arrays in torch: every function takes this rank's
``[B, S_local, H, D]`` shards, the rank at index ``i`` of the axis holding
sequence block ``i``.  :func:`make_sharded_attention` binds the mesh's
``sp`` axis.  The schedules are private functions that take their transport
as an argument; :func:`loopback_attention` binds them to one process that
plays every rank, which runs the gang's schedule on one device.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.flash_attention import flash_attention_lse
from horovod_tpu_torch.parallel.mesh import Axis, Mesh, mesh_axis_size


def _combine_partials(o1, lse1, o2, lse2):
    """Exactly merge two partial attentions over disjoint key sets.

    ``o_i`` are normalized partial outputs [B, S, H, D]; ``lse_i`` their
    per-query logsumexps [B, S, H] (``-inf`` marks an empty or discarded
    key set).  Standard logsumexp composition, fp32."""
    m = torch.maximum(lse1, lse2)
    # Rows where both are -inf would weigh 0/0: they keep -inf lse and a
    # zero output.
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    tot = w1 + w2
    norm = torch.where(tot > 0.0, tot, torch.ones_like(tot))
    o = (o1.float() * (w1 / norm)[..., None]
         + o2.float() * (w2 / norm)[..., None])
    return o, m + torch.log(norm)


# hop(kv, step) -> the [2, B, S, H, D] K/V block this rank holds after
# `step` hops, given the one it held after `step - 1`.
Hop = Callable[[torch.Tensor, int], torch.Tensor]


def _ring(q, k, v, my: int, n: int, hop: Hop, causal: bool):
    """The ring schedule of the rank at index ``my`` of ``n``.

    Hop 0 is the self-block (causal when ``causal``); after ``s`` hops the
    rank holds the block of rank ``(my - s) % n``.  With ``causal`` a block
    from a rank at or after ``my`` holds only future keys: its kernels run
    all the same, as the JAX package's do, and its lse is set to ``-inf``,
    which gives it no weight in the merge and a zero cotangent.  Per call,
    ``n`` forward launches and, in the backward, ``n`` dQ and ``n`` dK/dV."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = hop(kv, step)
        o_hop, lse_hop = flash_attention_lse(q, kv[0], kv[1], causal=False,
                                             scale=scale)
        if causal and not (my - step) % n < my:
            lse_hop = torch.full_like(lse_hop, float("-inf"))
        o, lse = _combine_partials(o, lse, o_hop, lse_hop)
    return o.to(q.dtype)


def ring_attention(q, k, v, axis: Axis, causal: bool = True):
    """Blockwise ring attention over the ``axis`` ring.

    q/k/v: this rank's ``[B, S_local, H, D]`` shards.  Returns its
    ``[B, S_local, H, D]`` output in q's dtype: full attention over the
    whole sequence up to the order of the fp32 sums."""
    return _ring(q, k, v, axis.index, axis.size,
                 lambda kv, step: C.ppermute_ring(kv, axis, 1), causal)


def full_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Dense softmax attention on one device (the oracle for tests, and
    Ulysses' local attention): scores in the inputs' dtype, softmax in
    fp32, probabilities cast back before P·V.  The queries sit at positions
    ``q_offset + arange(S_q)`` of the keys' sequence (for the causal
    mask)."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(D))
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= q_offset + torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def gathered_attention(q, k, v, axis: Axis, causal: bool = True):
    """Dense attention over a sequence sharded along ``axis``: K/V are
    all-gathered (the backward reduce-scatters their gradients) and this
    rank's queries, sequence block ``axis.index``, attend to the whole
    sequence at their own positions.  What GSPMD does for the JAX
    package's dense attention (and its flash attention, which falls back
    to dense) over a sequence-sharded batch.  q/k/v: this rank's ``[B,
    S_local, H, D]`` shards."""
    kv = C.allgather_dim(torch.stack([k, v]), 2, axis)
    return full_attention(q, kv[0], kv[1], causal,
                          q_offset=axis.index * q.shape[1])


# exchange(x) with x [R, n, ...] for the R ranks a process holds: chunk j of
# rank i arrives at rank j as chunk i.
Exchange = Callable[[torch.Tensor], torch.Tensor]


def _ulysses(q, k, v, n: int, exchange: Exchange, causal: bool):
    """The Ulysses schedule for ``R`` ranks of ``n`` at once.  q/k/v:
    ``[R, B, S_local, H, D]``, one shard per rank held here (R is 1 in a
    gang).  Sequence to heads is the JAX package's tiled
    ``all_to_all(split_axis=2, concat_axis=1)``: the rank at index ``j``
    gets head group ``j`` of every rank's shard, in rank (sequence) order."""
    R, B, S, H, D = q.shape
    if H % n != 0:
        raise ValueError(f"heads {H} not divisible by axis size {n}")
    G = H // n

    def seq_to_heads(x):  # -> [R, B, n*S, G, D]
        x = x.reshape(R, B, S, n, G, D).permute(0, 3, 1, 2, 4, 5)
        x = exchange(x.contiguous())  # [R, source rank, B, S, G, D]
        return x.permute(0, 2, 1, 3, 4, 5).reshape(R * B, n * S, G, D)

    def heads_to_seq(x):  # [R*B, n*S, G, D] -> [R, B, S, H, D]
        x = x.reshape(R, B, n, S, G, D).permute(0, 2, 1, 3, 4, 5)
        x = exchange(x.contiguous())  # [R, source head group, B, S, G, D]
        return x.permute(0, 2, 3, 1, 4, 5).reshape(R, B, S, H, D)

    out = full_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                         causal)
    return heads_to_seq(out)


def ulysses_attention(q, k, v, axis: Axis, causal: bool = True,
                      head_axis: Optional[Axis] = None):
    """Ulysses sequence parallelism over ``axis``: q/k/v are this rank's
    ``[B, S_local, H, D]`` shards with H divisible by the axis size;
    returns ``[B, S_local, H, D]``.  ``head_axis``: the tensor-parallel
    axis that already split the heads (H is then this rank's H/tp)."""
    n = axis.size
    if head_axis is not None and q.shape[2] % n:
        raise ValueError(
            f"Ulysses needs the heads of a tp rank (H/tp = {q.shape[2]}, "
            f"tp {head_axis.size}) divisible by sp ({n})")

    def exchange(x):
        return C.alltoall(x[0], axis=axis)[None]

    return _ulysses(q[None], k[None], v[None], axis.size, exchange,
                    causal)[0]


def make_sharded_attention(mesh: Mesh, impl: str = "ring", axis: str = "sp",
                           causal: bool = True,
                           head_axis: Optional[str] = None):
    """Bind ring or Ulysses attention to the mesh's ``axis``.  Returns
    ``fn(q, k, v) -> out`` on this rank's ``[B, S_local, H, D]`` shards.
    Heads sharded over ``head_axis`` (tensor parallelism) are this rank's
    heads already: the ring runs on them as on any heads, and Ulysses
    needs their number divisible by the axis size."""
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    if impl not in fns:
        raise ValueError(f"impl must be one of {sorted(fns)}")
    fn = functools.partial(fns[impl], axis=mesh.axis(axis), causal=causal)
    if impl == "ulysses" and head_axis is not None and \
            mesh_axis_size(mesh, head_axis) > 1:
        fn = functools.partial(fn, head_axis=mesh.axis(head_axis))
    return fn


def loopback_attention(q, k, v, n: int, impl: str = "ring",
                       causal: bool = True):
    """Run the ``n``-rank schedule of ``impl`` in this one process, every
    rank in turn, on the whole ``[B, n*S_local, H, D]`` q/k/v; returns the
    whole output.  Rank ``r`` holds sequence block ``r``.  A ring hop's send
    and receive gives rank ``r`` the block of rank ``(r - step) % n`` as a
    slice of the whole K/V, so autograd carries every K/V gradient home;
    Ulysses' all-to-all is a transpose of the ranks' chunks.  The kernels
    see the shapes they see in an ``n``-rank gang."""
    B, St, H, D = q.shape
    if St % n:
        raise ValueError(f"sequence {St} is not divisible by {n}")
    S = St // n
    if impl == "ulysses":
        def ranks(x):  # [B, n*S, H, D] -> [n, B, S, H, D]
            return x.reshape(B, n, S, H, D).transpose(0, 1)

        out = _ulysses(ranks(q), ranks(k), ranks(v), n,
                       lambda x: x.transpose(0, 1), causal)
        return out.transpose(0, 1).reshape(B, St, H, D)
    if impl != "ring":
        raise ValueError("impl must be one of ['ring', 'ulysses']")
    kv_all = torch.stack([k, v])

    def block(x, r):
        return x[..., r * S:(r + 1) * S, :, :]

    outs = []
    for r in range(n):
        def hop(kv, step, r=r):
            return block(kv_all, (r - step) % n)

        outs.append(_ring(block(q, r), block(k, r), block(v, r), r, n, hop,
                          causal))
    return torch.cat(outs, dim=1)
