"""Types the port shares across modules.

The port's copy of what it needs from ``horovod_tpu/common/types.py``
(``DataType`` and ``ReduceOp``, with the same values, the dtype
mappings, the errors of the audit and the rendezvous KV:
``RanksFailedError``, ``ReplicaDivergenceError`` and ``FencedError``, with
the same messages and attributes, and the eager engine's messages:
``RequestType``, ``ResponseType``, ``StatusType``, ``Status``,
``TensorShape``, ``Request`` and ``Response``, with the same enum values
and fields, which ``common/wire.py`` puts on the wire byte for byte as the
JAX package does); the port imports nothing of the JAX package.

Left out until their features are ported (ROADMAP Queue 1, item 5):
``CollectiveTimeoutError`` (deadlines and abort).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch


class DataType(enum.IntEnum):
    """Wire dtype tags, numbered as in the JAX package."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10
    FLOAT8_E4M3 = 11
    FLOAT8_E5M2 = 12

    @property
    def itemsize(self) -> int:
        return dtype_to_torch(self).itemsize


_TORCH = {
    DataType.UINT8: torch.uint8,
    DataType.INT8: torch.int8,
    DataType.UINT16: torch.uint16,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT16: torch.float16,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BOOL: torch.bool,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT8_E4M3: torch.float8_e4m3fn,
    DataType.FLOAT8_E5M2: torch.float8_e5m2,
}


def dtype_to_torch(dt: DataType) -> torch.dtype:
    return _TORCH[dt]


def dtype_from_torch(dtype: torch.dtype) -> DataType:
    for k, v in _TORCH.items():
        if v == dtype:
            return k
    raise ValueError(f"horovod_tpu_torch does not support dtype {dtype}")


def dtype_to_numpy_name(dt: DataType) -> str:
    """The numpy (and JAX) name of the type, e.g. ``"float8_e4m3fn"``."""
    return str(_TORCH[dt]).split(".", 1)[1]


def dtype_from_numpy(np_dtype) -> DataType:
    name = str(np_dtype)
    for k in _TORCH:
        if dtype_to_numpy_name(k) == name:
            return k
    raise ValueError(f"horovod_tpu_torch does not support dtype {name!r}")


class ReduceOp(enum.IntEnum):
    """Reduction semantics of an allreduce: Average / Sum / Adasum / Min /
    Max / Product, numbered as in the JAX package."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


class NotInitializedError(ValueError):
    """A collective or rank query ran before ``horovod_tpu_torch.init()``."""

    def __init__(self):
        super().__init__("horovod_tpu_torch has not been initialized; call "
                         "hvd.init() first.")


class NoCudaDeviceError(RuntimeError):
    """An entry point was asked to run on the card and there is none.

    The port runs on ``cuda:<local_rank>`` unless the caller passes
    ``device="cpu"``; it never moves to the CPU on its own."""

    def __init__(self, what: str):
        super().__init__(
            f"{what} runs on the CUDA device by default and torch finds no "
            "CUDA device; pass device='cpu' to run on the CPU")


class RanksFailedError(RuntimeError):
    """Raised by the enqueue API after the coordinator evicted dead ranks.

    In-flight collectives complete on the survivors (zero stand-ins via
    the Join machinery); the *next* submitted op raises this so the
    training loop can checkpoint and exit for a ``--max-restarts``
    relaunch."""

    def __init__(self, ranks):
        self.ranks = sorted(int(r) for r in ranks)
        super().__init__(
            f"rank(s) {self.ranks} stopped responding and were evicted; "
            f"surviving ranks completed in-flight collectives — "
            f"checkpoint and restart (hvdrun --max-restarts relaunches "
            f"automatically)")


class ReplicaDivergenceError(RanksFailedError):
    """The replica-divergence audit found rank(s) whose replicated state
    no longer bit-matches the gang's (silent corruption: a flipped bit,
    a non-deterministic kernel, bad HBM).

    Subclasses :class:`RanksFailedError` with ``.ranks`` = the deviant
    rank(s), so ``@hvd.elastic.run`` treats it exactly like a dead rank:
    the deviants are evicted, the survivors roll back to the last commit
    and re-form.  Every rank computes the identical verdict from the
    same allgathered digests, so the deviant evicts *itself* (it exits
    instead of re-joining) while the survivors agree on the new world.
    """

    def __init__(self, ranks, leaf_path: str = "",
                 digests=None):
        self.leaf_path = leaf_path
        self.digests = dict(digests or {})
        RuntimeError.__init__(self)  # skip RanksFailedError's message
        self.ranks = sorted(int(r) for r in ranks)
        detail = f" (first divergent leaf: {leaf_path})" if leaf_path \
            else ""
        self.args = (
            f"replica state diverged on rank(s) {self.ranks}{detail}; "
            f"the replicated parameters no longer bit-match across the "
            f"gang — evict the deviant rank(s) and restore survivors "
            f"from the last commit/checkpoint",)


class FencedError(RuntimeError):
    """A stale-epoch actor was rejected by the current gang incarnation.

    Raised on a **zombie** — a rank that was evicted (long GC pause,
    network blip, chaos stall) while the survivors re-formed at a newer
    membership epoch — when it wakes up and tries to write into the new
    gang: a control frame gets a ``TAG_FENCE`` reply from the
    coordinator, a KV write under ``elastic/*`` gets HTTP 409 from the
    rendezvous server.  Deliberately NOT a :class:`RanksFailedError`
    subclass: the elastic wrapper re-forms on those, but a fenced rank
    has no seat in the new world — it must exit, and the typed class is
    how the training loop tells "my peers died, re-form" apart from
    "I am the zombie, stop".
    """

    def __init__(self, what: str, stale_epoch: int, current_epoch: int):
        self.what = what
        self.stale_epoch = int(stale_epoch)
        self.current_epoch = int(current_epoch)
        super().__init__(
            f"fenced {what}: this rank is at membership epoch "
            f"{self.stale_epoch} but the gang re-formed at epoch "
            f"{self.current_epoch}; this process was evicted and has no "
            f"seat in the new world — exit instead of corrupting it")


class RequestType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ALLTOALL = 4
    BARRIER = 5
    REDUCESCATTER = 6


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ALLTOALL = 4
    BARRIER = 5
    REDUCESCATTER = 6
    ERROR = 7
    # The coordinator's eviction of dead ranks (heartbeats, which the port
    # does not run yet); numbered so that the codec decodes every value.
    EVICT = 8


class StatusType(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclass
class Status:
    """An operation's outcome, delivered to its handle.  ``exc``, when set,
    is raised by ``HandleManager.wait`` in place of a ``RuntimeError``
    carrying ``reason``; it is never serialized."""

    type: StatusType = StatusType.OK
    reason: str = ""
    exc: Optional[BaseException] = None

    @staticmethod
    def ok() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def aborted(reason: str) -> "Status":
        return Status(StatusType.ABORTED, reason)

    @staticmethod
    def precondition_error(reason: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, reason)

    @staticmethod
    def invalid_argument(reason: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, reason)

    @staticmethod
    def unknown_error(reason: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, reason)

    @staticmethod
    def in_progress() -> "Status":
        return Status(StatusType.IN_PROGRESS)

    def ok_(self) -> bool:
        return self.type == StatusType.OK

    def in_progress_(self) -> bool:
        return self.type == StatusType.IN_PROGRESS


@dataclass(frozen=True)
class TensorShape:
    """An immutable shape: its dims and their product."""

    dims: tuple

    def __init__(self, dims: Sequence[int] = ()):
        object.__setattr__(self, "dims", tuple(int(d) for d in dims))

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def rank(self) -> int:
        return len(self.dims)

    def __str__(self) -> str:
        return "[" + ", ".join(str(d) for d in self.dims) + "]"


@dataclass
class Request:
    """What one rank wants to do with one named tensor.  A process set is
    its id (0 = the global set) and its member count."""

    request_rank: int = 0
    request_type: RequestType = RequestType.ALLREDUCE
    tensor_type: DataType = DataType.FLOAT32
    tensor_name: str = ""
    root_rank: int = -1
    device: str = "cpu"
    tensor_shape: TensorShape = field(default_factory=TensorShape)
    reduce_op: ReduceOp = ReduceOp.SUM
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    process_set_id: int = 0
    process_set_size: int = 0


@dataclass
class Response:
    """What every rank must now execute, in the same order everywhere.
    More than one name means the entries were fused into one collective.

    ``tensor_sizes`` holds, for an allreduce, each fused tensor's element
    count; for an allgather, the first dimension of every rank's tensor in
    rank order; for a broadcast, the root rank.  ``tensor_shapes`` holds
    an allreduce's (and a reducescatter's) negotiated dims, so that every
    rank, a joined one included, caches the same parameters."""

    response_type: ResponseType = ResponseType.ERROR
    tensor_names: List[str] = field(default_factory=list)
    error_message: str = ""
    devices: List[str] = field(default_factory=list)
    tensor_type: DataType = DataType.FLOAT32
    tensor_sizes: List[int] = field(default_factory=list)
    reduce_op: ReduceOp = ReduceOp.SUM
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    tensor_shapes: List[TensorShape] = field(default_factory=list)
    process_set_id: int = 0

    def add_tensor_name(self, name: str) -> None:
        self.tensor_names.append(name)
