"""Response cache: the port of ``horovod_tpu/common/response_cache.py``,
the steady-state bypass of full request negotiation.

An LRU cache of negotiated single-tensor ALLREDUCE responses, kept the
same on every rank: in steady state a rank tells the coordinator "position
p is ready" (a hit event on the request frame) instead of the whole
Request, and the coordinator broadcasts the position instead of the
Response.  The coordinator rebuilds the Request from its own entry and
feeds it through the message table; when every contributor hit, it sends
just the position.  An entry evicted in flight degrades to the negotiated
path or a RESEND, never to corruption.

Every rank executes the same response stream in the same order, and every
cache mutation (insert, in-place update, LRU touch, eviction) happens at
execution from the response's own data (``Response.tensor_shapes`` holds
the negotiated dims), so positions, LRU order and evictions agree on every
rank, a JAX rank's included, with no extra traffic.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.common.types import (
    ReduceOp,
    Request,
    RequestType,
    Response,
    ResponseType,
    TensorShape,
)

# Classification results (parity: response_cache.h CacheState).
MISS = 0
HIT = 1
INVALID = 2  # name cached but parameters changed → renegotiate


def _params_of_request(req: Request) -> tuple:
    return (int(req.tensor_type), tuple(req.tensor_shape.dims),
            int(req.reduce_op), req.prescale_factor, req.postscale_factor,
            req.device)


class _Entry:
    __slots__ = ("name", "position", "response", "params")

    def __init__(self, name: str, position: int, response: Response,
                 params: tuple):
        self.name = name
        self.position = position
        self.response = response
        self.params = params


class ResponseCache:
    """LRU cache of single-tensor ALLREDUCE responses, position-addressed.

    Positions are dense small integers reused after eviction so the wire
    encoding stays compact (parity: the reference's fixed-width cache
    bitvector).  The entry dict doubles as the LRU order (front = least
    recently used), giving O(1) touch/evict via ``move_to_end``.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._by_pos: Dict[int, _Entry] = {}
        self._free_positions: list = []
        self._next_position = 0
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        return len(self._entries)

    # -- classification (background-thread pop path) ----------------------

    def classify(self, req: Request) -> Tuple[int, int]:
        """Returns (state, position).  Only ALLREDUCE is cacheable — the
        reference likewise caches only allreduce responses (allgather
        output sizes vary per step)."""
        if not self.enabled or req.request_type != RequestType.ALLREDUCE \
                or req.process_set_id:
            # Process-set ops bypass the cache: positions must stay
            # coherent on EVERY rank, and non-members never see the
            # set's traffic.
            return MISS, -1
        ent = self._entries.get(req.tensor_name)
        if ent is None:
            self.misses += 1
            return MISS, -1
        if ent.params != _params_of_request(req):
            return INVALID, ent.position
        self.hits += 1
        return HIT, ent.position

    # -- lookups ----------------------------------------------------------

    def get_by_position(self, pos: int) -> Optional[Response]:
        ent = self._by_pos.get(pos)
        return ent.response if ent is not None else None

    def name_at(self, pos: int) -> Optional[str]:
        ent = self._by_pos.get(pos)
        return ent.name if ent is not None else None

    def position_of(self, name: str) -> int:
        ent = self._entries.get(name)
        return ent.position if ent is not None else -1

    def synthesize_request(self, pos: int, rank: int) -> Optional[Request]:
        """Rebuild the full Request a hit event stands for, from the
        coordinator's own cache entry (coherent with the sender's)."""
        ent = self._by_pos.get(pos)
        if ent is None:
            return None
        (ttype, dims, rop, pre, post, device) = ent.params
        return Request(
            request_rank=rank,
            request_type=RequestType.ALLREDUCE,
            tensor_type=ent.response.tensor_type,
            tensor_name=ent.name,
            device=device,
            tensor_shape=TensorShape(list(dims)),
            reduce_op=ReduceOp(rop),
            prescale_factor=pre,
            postscale_factor=post,
        )

    def touch(self, pos: int) -> None:
        ent = self._by_pos.get(pos)
        if ent is not None:
            self._entries.move_to_end(ent.name)

    # -- population (response-execution path) -----------------------------

    def put(self, resp: Response) -> None:
        """Cache each tensor of an executed ALLREDUCE response as its own
        single-tensor response.  Exact dims come from the negotiated
        ``resp.tensor_shapes`` — response-carried, so identical on every
        rank regardless of local request state."""
        if not self.enabled or resp.response_type != ResponseType.ALLREDUCE \
                or resp.error_message or resp.process_set_id:
            return
        have_shapes = len(resp.tensor_shapes) == len(resp.tensor_names)
        for i, name in enumerate(resp.tensor_names):
            shape = resp.tensor_shapes[i] if have_shapes \
                else TensorShape([resp.tensor_sizes[i]])
            single = Response(
                response_type=ResponseType.ALLREDUCE,
                tensor_type=resp.tensor_type,
                tensor_names=[name],
                devices=list(resp.devices),
                tensor_sizes=[resp.tensor_sizes[i]],
                reduce_op=resp.reduce_op,
                prescale_factor=resp.prescale_factor,
                postscale_factor=resp.postscale_factor,
                tensor_shapes=[shape],
            )
            params = (int(resp.tensor_type), tuple(shape.dims),
                      int(resp.reduce_op), resp.prescale_factor,
                      resp.postscale_factor,
                      resp.devices[0] if resp.devices else "cpu")
            self._put_one(name, single, params)

    def _put_one(self, name: str, resp: Response, params: tuple) -> None:
        ent = self._entries.get(name)
        if ent is not None:
            # In-place update keeps the position stable (shape changes
            # re-cache under the same position).
            ent.response = resp
            ent.params = params
            self._entries.move_to_end(name)
            return
        if len(self._entries) >= self.capacity:
            _victim, vent = self._entries.popitem(last=False)
            del self._by_pos[vent.position]
            self._free_positions.append(vent.position)
            self.evictions += 1
        if self._free_positions:
            pos = self._free_positions.pop(0)
        else:
            pos = self._next_position
            self._next_position += 1
        ent = _Entry(name, pos, resp, params)
        self._entries[name] = ent
        self._by_pos[pos] = ent

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "capacity": self.capacity}
