"""Replica-divergence audit: the port of ``horovod_tpu/integrity/audit.py``.

Data-parallel training assumes the replicated parameters are identical on
every rank; one flipped bit (bad HBM, a non-deterministic kernel, a torn
host transfer) silently forks the model.  The audit checks it:

1. every ``HVD_AUDIT_INTERVAL`` steps each rank fingerprints its replicated
   tree: a sha256 digest per leaf (dtype name, shape, raw bytes), folded
   into one 64-bit digest;
2. the digest vectors are all-gathered (as int64 bit patterns) through
   :func:`horovod_tpu_torch.ops.collective.allgather`, on the rank's device;
3. every rank reaches the same verdict from the same gathered matrix: all
   folded digests equal is clean; otherwise the majority digest is
   canonical (a tie goes to the digest of the lowest rank) and every other
   rank is a deviant, named by :class:`ReplicaDivergenceError` with the
   first leaf that diverged.

A tree is a tensor, a ``state_dict``, or any nesting of dicts, lists and
tuples.  It is flattened as the JAX package's pytrees are: dict keys in
sorted order, lists and tuples in order, ``None`` holding no leaf.  So the
same leaves in the same tree give the JAX package's digests.  A leaf's
path joins its keys and indices with dots (``model.layers.0.wq``; the JAX
package writes ``['model']['layers'][0]['wq']``).  A tensor leaf is digested
as the numpy array of its values would be (bf16 by the name
``"bfloat16"``); any other leaf (a Python number, a string) as
``np.asarray`` of it, as the JAX package does.

A divergence records a ``DIVERGENCE_DETECTED`` instant on the engine's
timeline (``utils/timeline.py``) before the raise.  The ``state.bitflip``
fault site (a ``corrupt`` fault, in :func:`fingerprint`) flips one bit of
the first audited leaf's bytes, as bad memory would.

Left out until the flight recorder is ported (ROADMAP Queue 1, item 5.5):
its note and dump at a divergence.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common.types import ReplicaDivergenceError
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import timeline as timeline_mod


def _digest8(chunks) -> int:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest()[:8], "little")


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def _leaf_chunks(leaf):
    """The dtype name, the shape as int64 bytes, and the raw bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).split(".", 1)[1]
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return [name.encode(), np.asarray(t.shape, np.int64).tobytes(), raw]
    arr = np.asarray(leaf)
    return [str(arr.dtype).encode(), np.asarray(arr.shape, np.int64).tobytes(),
            arr.tobytes()]


def fingerprint(tree, _detail: str = "") -> Tuple[int, List[Tuple[str, int]]]:
    """``(folded, [(leaf_path, digest), ...])`` over a tree's leaves.

    Digests cover dtype, shape and raw bytes, so a dtype drift and a value
    drift are equally visible; the fold is a sha256 over the per-leaf
    digests, so any single-leaf change moves it."""
    flip = _fi.should_corrupt("state.bitflip", _detail)
    per_leaf = []
    for path, leaf in _leaves(tree):
        chunks = _leaf_chunks(leaf)
        if flip and len(chunks[2]):
            # The injected silent corruption: one bit of the first
            # audited leaf.
            raw = bytearray(chunks[2])
            raw[0] ^= 0x01
            chunks[2] = bytes(raw)
            flip = False
        per_leaf.append((path, _digest8(chunks)))
    folded = _digest8([d.to_bytes(8, "little") for _, d in per_leaf])
    return folded, per_leaf


def _verdict(mat: np.ndarray) -> Tuple[List[int], int]:
    """Deviant ranks and the canonical row, from the folded column.

    The majority digest wins; a tie goes to the digest of the lowest rank,
    so every rank (deviants included) agrees."""
    col = mat[:, 0].tolist()
    counts = Counter(col)
    maxc = max(counts.values())
    canonical = min((d for d, c in counts.items() if c == maxc),
                    key=col.index)
    deviants = [r for r, d in enumerate(col) if d != canonical]
    return deviants, col.index(canonical)


def audit_replicas(tree) -> int:
    """One collective audit round over ``tree`` (replicated state).

    Every rank calls it with its own copy of the same tree.  Returns the
    folded digest (equal on every rank), or raises
    :class:`ReplicaDivergenceError` naming the deviant ranks and the first
    leaf that diverged.  At one rank it is trivially clean."""
    folded, per_leaf = fingerprint(tree, _detail="integrity.audit")
    # The wire has no uint64: int64 bit patterns.
    local = np.array([folded] + [d for _, d in per_leaf],
                     dtype=np.uint64).view(np.int64)
    gathered = C.allgather(torch.from_numpy(local).to(basics.device()))
    size = basics.size()
    mat = np.ascontiguousarray(
        gathered.cpu().numpy().reshape(size, len(per_leaf) + 1)
    ).view(np.uint64)
    if len(set(mat[:, 0].tolist())) == 1:
        return folded
    deviants, canon = _verdict(mat)
    leaf_path = ""
    for j in range(1, mat.shape[1]):
        if any(mat[r, j] != mat[canon, j] for r in deviants):
            leaf_path = per_leaf[j - 1][0]
            break
    digests = {r: f"{int(mat[r, 0]):016x}" for r in range(size)}
    timeline_mod.engine_event(
        timeline_mod.DIVERGENCE_DETECTED, ranks=deviants,
        leaf=leaf_path, digests=digests)
    raise ReplicaDivergenceError(deviants, leaf_path, digests)


class ReplicaAuditor:
    """Paced audit for a training loop.

    Call :meth:`maybe_audit` once per step on every rank; every
    ``interval`` steps (``HVD_AUDIT_INTERVAL``; 0 turns it off) it runs
    :func:`audit_replicas`.  Pass the gang's step as ``step``: the audit
    fires when ``step % interval == 0``, so every rank paces off the same
    clock.  Without ``step`` it counts its own calls, which is safe only
    where every rank has made the same calls."""

    def __init__(self, interval: Optional[int] = None):
        self.interval = interval if interval is not None else \
            env_util.get_int(env_util.AUDIT_INTERVAL, 0)
        if self.interval < 0:
            raise ValueError("audit interval must be >= 0")
        self.audits = 0     # audit rounds completed clean
        self._step = 0

    def maybe_audit(self, tree, step: Optional[int] = None) -> bool:
        """Returns True when an audit ran (and passed) this step."""
        if self.interval <= 0:
            return False
        if step is None:
            self._step += 1
            step = self._step
        else:
            step = int(step)
            self._step = step
        if step % self.interval:
            return False
        audit_replicas(tree)
        self.audits += 1
        return True
