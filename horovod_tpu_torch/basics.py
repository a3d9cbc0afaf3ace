"""Process-group runtime: init / shutdown / rank / size / device.

The port of ``horovod_tpu/basics.py`` over ``torch.distributed``.  Rank
discovery, in order:

1. explicit ``init(rank=..., size=...)`` arguments;
2. ``HVD_RANK/HVD_SIZE/HVD_LOCAL_RANK/HVD_LOCAL_SIZE`` from the launcher;
3. torchrun's ``RANK/WORLD_SIZE/LOCAL_RANK/LOCAL_WORLD_SIZE``;
4. a single process (rank 0 of 1).

The device is ``cuda:<local_rank>`` with the NCCL backend unless the caller
passes ``device="cpu"``, which selects gloo.  A one-rank job still creates a
real one-rank process group (over an in-process ``HashStore``), so its
gradient allreduce is a real collective launch.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.types import NoCudaDeviceError, \
    NotInitializedError

_lock = threading.Lock()


@dataclass(frozen=True)
class _World:
    rank: int
    size: int
    local_rank: int
    local_size: int
    device: torch.device


_world: Optional[_World] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None or v == "" else int(v)


def _discover(rank, size, local_rank, local_size):
    if size is None:
        for r_var, s_var, lr_var, ls_var in (
                ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_LOCAL_SIZE"),
                ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")):
            if _env_int(s_var) is not None:
                size = _env_int(s_var)
                rank = _env_int(r_var) or 0
                if local_rank is None:
                    local_rank = _env_int(lr_var)
                if local_size is None:
                    local_size = _env_int(ls_var)
                break
    if size is None:
        rank, size = 0, 1
    if rank is None:
        rank = 0
    if local_rank is None:
        local_rank = rank
    if local_size is None:
        local_size = size
    return rank, size, local_rank, local_size


def _device(device, local_rank: int, what: str) -> torch.device:
    dev = torch.device("cuda", local_rank) if device is None \
        else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(what)
    return dev


def resolve_device(device: Union[str, torch.device, None],
                   what: str = "horovod_tpu_torch") -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: the initialized runtime's device, else
    ``cuda:<local_rank>``.  Raises :class:`NoCudaDeviceError` rather than
    run on the CPU when there is no card."""
    if device is None and _world is not None:
        return _world.device
    return _device(device, _discover(None, None, None, None)[2], what)


def init(rank: Optional[int] = None, size: Optional[int] = None,
         local_rank: Optional[int] = None, local_size: Optional[int] = None,
         *, device: Union[str, torch.device, None] = None,
         init_method: Optional[str] = None) -> None:
    """Initialize the runtime for this process.  Idempotent.

    ``init_method`` is passed to ``torch.distributed.init_process_group``
    for a multi-rank job (default ``env://``: ``MASTER_ADDR`` and
    ``MASTER_PORT``)."""
    global _world
    with _lock:
        if _world is not None:
            return
        r, s, lr, ls = _discover(rank, size, local_rank, local_size)
        dev = _device(device, lr, "hvd.init()")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if s == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group(backend,
                                    init_method=init_method or "env://",
                                    rank=r, world_size=s)
        _world = _World(r, s, lr, ls, dev)


def shutdown() -> None:
    """Tear down the process group."""
    global _world
    with _lock:
        if _world is not None:
            dist.destroy_process_group()
        _world = None


def is_initialized() -> bool:
    return _world is not None


def _w() -> _World:
    if _world is None:
        raise NotInitializedError()
    return _world


def rank() -> int:
    return _w().rank


def size() -> int:
    return _w().size


def local_rank() -> int:
    return _w().local_rank


def local_size() -> int:
    return _w().local_size


def device() -> torch.device:
    """The device this rank's collectives and entry points run on."""
    return _w().device
