"""Process sets: eager collectives over subgroups of ranks; the port of
``horovod_tpu/process_sets.py``.

``ProcessSet([0, 2])`` scopes an eager collective to a subset of ranks:

    ps = hvd.ProcessSet([0, 2])
    if ps.included():
        out = hvd.allreduce(x, process_set=ps)

A set's id is a stable hash (FNV-1a) of its sorted member ranks, the JAX
package's, so that a port rank and a JAX rank give the same set the same
id.  Requests carry ``(id, size)`` and the coordinator waits for exactly
the members.  Construct the set on every rank, members and non-members
alike: non-members skip its responses, which reach every rank.  The
subgroup rings walk the member list over the engine's full mesh.  The
native engine keeps a registry of its own in the C++ core: a set
constructed while it runs is registered there at once, and the engine
copies the sets constructed before it started (:func:`snapshot`).  The
compiled regime expresses subgroups as mesh axes instead
(``parallel/mesh.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

_lock = threading.Lock()
_registry: Dict[int, List[int]] = {}

GLOBAL_ID = 0


def _set_id(ranks: Sequence[int]) -> int:
    """FNV-1a over the member ranks, folded to a positive int32 != 0."""
    h = 2166136261
    for r in ranks:
        for b in int(r).to_bytes(4, "little", signed=False):
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    h &= 0x7FFFFFFF
    return h or 1


class ProcessSet:
    """A fixed subgroup of global ranks (sorted, duplicates removed).

    Construct on every rank with the same member list, and pass it as the
    ``process_set=`` argument of eager collectives."""

    def __init__(self, ranks: Sequence[int]):
        members = sorted({int(r) for r in ranks})
        if not members:
            raise ValueError("a process set needs at least one rank")
        if members[0] < 0:
            raise ValueError(f"negative rank in process set: {members}")
        self.ranks: List[int] = members
        self.process_set_id = _set_id(members)
        with _lock:
            prev = _registry.get(self.process_set_id)
            if prev is not None and prev != members:
                raise ValueError(
                    f"process-set id collision: ranks {members} hash to "
                    f"id {self.process_set_id}, already registered for "
                    f"ranks {prev}.  Set ids are a 31-bit hash of the "
                    "member list, so distinct sets can (rarely) collide; "
                    "requests would be routed to the wrong subgroup.  "
                    "Re-partition one of the two subgroups (any change "
                    "to its member list picks a new id), or call "
                    "process_sets.reset() if the colliding set belongs "
                    "to a previous world that no longer exists.")
            _registry[self.process_set_id] = members
        # The native engine's own registry (its coordinator and its skip
        # path read it); NativeEngine copies the snapshot when it starts.
        from horovod_tpu_torch import basics

        eng = basics._engine_obj
        if eng is not None and hasattr(eng, "register_process_set"):
            eng.register_process_set(self.process_set_id, members)

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """This process's rank within the set, or -1 if not a member."""
        from horovod_tpu_torch import basics

        try:
            return self.ranks.index(basics.rank())
        except ValueError:
            return -1

    def included(self) -> bool:
        return self.rank() >= 0

    def validate(self, rank: int, world_size: int):
        """Enqueue-side validation shared by the engines; returns the
        request's (id, size) fields."""
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not a member of {self}")
        if self.ranks[-1] >= world_size:
            raise ValueError(
                f"{self} has ranks outside the world [0, {world_size})")
        return self.process_set_id, len(self.ranks)

    def __repr__(self) -> str:
        return f"ProcessSet(ranks={self.ranks}, id={self.process_set_id})"


def ranks_of(set_id: int) -> Optional[List[int]]:
    """Member ranks of a registered set (None if unknown here)."""
    if set_id == GLOBAL_ID:
        return None
    with _lock:
        return _registry.get(set_id)


def snapshot() -> Dict[int, List[int]]:
    """Every registered set, by id."""
    with _lock:
        return {k: list(v) for k, v in _registry.items()}


def reset() -> None:
    """Forget every registered set (a world that no longer exists)."""
    with _lock:
        _registry.clear()
