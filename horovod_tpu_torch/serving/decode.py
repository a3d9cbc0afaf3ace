"""Per-rank continuous-batching decode state: the port of
``horovod_tpu/serving/decode.py``.

A :class:`DecodeEngine` holds the slot-batched KV caches ``[L, max_batch,
cache_len, H, HD]`` in the compute dtype on the device, the per-slot token
and position vectors, and steps
:func:`horovod_tpu_torch.models.transformer.decode_step`, which writes the
caches in place (the JAX package donates them).  Rows never mix, so a
slot's output does not depend on what its neighbours decode.

The engine casts the model's matrices to the compute dtype once
(:func:`~horovod_tpu_torch.models.transformer.decode_weights`): the values
the decode path would cast at every use, without a cast of every matrix at
every step.  That copy costs ``2 x`` the matrices' parameter count in bytes
beside the fp32 model (336 MB at the flagship's 168 M parameters, bf16).

Over a mesh with ``tp``, ``model`` is the rank's shard
(:func:`~horovod_tpu_torch.models.transformer.init` with ``mesh=``), each
rank holds its ``H/tp`` heads of the cache (``KV_CACHE_SPEC``), and every
rank of the ``tp`` group steps together and computes the same tokens.
Other mesh axes hold replicas.  Greedy decoding only: determinism is what
lets every rank step without exchanging tokens.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel.mesh import mesh_axis_size


class DecodeEngine:
    def __init__(self, model, cfg: T.TransformerConfig, *, max_batch: int,
                 cache_len: Optional[int] = None, mesh=None, device=None):
        if cfg.n_experts:
            raise NotImplementedError(
                "serving supports dense-FFN configs (same contract as "
                "models.transformer.generate)")
        self.device = resolve_device(device, "DecodeEngine")
        self.cfg = cfg
        self.max_batch = max_batch
        self.cache_len = cache_len or cfg.max_seq_len
        self.mesh = mesh
        self.model = T.decode_weights(model, self.device)
        tp = 1 if mesh is None else mesh_axis_size(mesh, "tp")
        shape = (cfg.n_layers, max_batch, self.cache_len, cfg.n_heads // tp,
                 cfg.head_dim)
        self.ks = torch.zeros(shape, dtype=cfg.compute_dtype,
                              device=self.device)
        self.vs = torch.zeros_like(self.ks)
        self.tok = torch.zeros(max_batch, dtype=torch.long,
                               device=self.device)
        self.pos = torch.zeros_like(self.tok)
        # The last step()'s next-token logits [max_batch, V], fp32.
        self.logits: Optional[torch.Tensor] = None

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: List[int]) -> int:
        """Run the prompt through the model, install its K/V in the slot's
        cache lane, and return the first (greedy) token.  The slot is live
        from the next :meth:`step` on."""
        logits, ks1, vs1 = T.prefill_request(
            self.model, torch.as_tensor(prompt, device=self.device),
            self.cache_len, mesh=self.mesh)
        self.ks[:, slot] = ks1[:, 0]
        self.vs[:, slot] = vs1[:, 0]
        first = int(torch.argmax(logits))
        self.tok[slot] = first
        self.pos[slot] = len(prompt)
        return first

    @torch.inference_mode()
    def clear(self, slot: int) -> None:
        """Retire a slot.  The cache lane is left as it is: the position
        mask hides it, and the next admission's prefill overwrites it."""
        self.tok[slot] = 0
        self.pos[slot] = 0

    @torch.inference_mode()
    def step(self) -> np.ndarray:
        """One decode step for the whole batch; returns the ``[max_batch]``
        greedy next tokens (free slots compute harmless garbage: rows are
        independent)."""
        self.logits, _, _ = T.decode_step(self.model, self.tok, self.pos,
                                          self.ks, self.vs, mesh=self.mesh)
        self.tok = torch.argmax(self.logits, dim=-1)
        # Clamp, so that an idle slot parked at the end never writes out of
        # bounds; an active slot retires before it gets there.
        self.pos = torch.clamp(self.pos + 1, max=self.cache_len - 1)
        return self.tok.cpu().numpy()
