"""Multi-host bootstrap from the launcher: the port of
``horovod_tpu/parallel/multihost.py``.

Where the JAX package joins every process's devices into one
``jax.distributed`` view, the port needs the address of one TCP store that
``torch.distributed.init_process_group`` meets at.  Under the launcher
(``python -m horovod_tpu.runner.run -np N -- python prog.py``), each process
calls :func:`init_torch_distributed` before ``hvd.init()``: rank 0 binds a
free port and publishes ``host:port`` on the launcher's rendezvous KV
(HMAC-signed with the job's secret), the other ranks wait for it, and every
rank sets ``MASTER_ADDR`` and ``MASTER_PORT``, which ``hvd.init()``'s
``env://`` reads::

    from horovod_tpu_torch.parallel.multihost import init_torch_distributed
    import horovod_tpu_torch as hvd

    init_torch_distributed()
    hvd.init()

The key is ``hvd/[<HVD_RDV_SCOPE>/]torch_coordinator``, not the JAX
package's ``jax_coordinator``, so that a TCP store is never handed the
address of a JAX coordinator.  A single process is a no-op, so the same
script runs under plain ``python``.
"""

from __future__ import annotations

import os
import socket

import torch

from horovod_tpu_torch import basics

_initialized = False


def init_torch_distributed(timeout: float = 120.0) -> None:
    """Publish or learn the process group's store address through the
    launcher's rendezvous KV and set ``MASTER_ADDR``/``MASTER_PORT``.

    Runs before ``hvd.init()``.  Rank and size come from the launcher's
    environment (``HVD_RANK``/``HVD_SIZE``, or torchrun's), as ``hvd.init()``
    finds them.  Idempotent; a no-op for one process."""
    global _initialized
    if _initialized:
        return
    rank, size = basics._discover(None, None, None, None)[:2]
    if size <= 1:
        return
    if basics.is_initialized():
        raise RuntimeError(
            "init_torch_distributed must run before hvd.init(): the "
            "process group reads MASTER_ADDR/MASTER_PORT when it starts")
    kv = _kv("init_torch_distributed")
    key = _key("torch_coordinator")
    if rank == 0:
        coord = f"{_my_addr(kv)}:{_free_port()}"
        kv.put(key, coord)
    else:
        try:
            coord = kv.wait_get(key, timeout=timeout)
        except TimeoutError as e:
            raise RuntimeError(
                "timed out waiting for the torch.distributed store address "
                "on the rendezvous KV (did rank 0 call "
                "init_torch_distributed?)") from e
    host, _, port = coord.rpartition(":")
    os.environ["MASTER_ADDR"] = host
    os.environ["MASTER_PORT"] = port
    _initialized = True


def ranks_share_a_card(device: torch.device,
                       timeout: float = 120.0) -> bool:
    """Whether two ranks of the gang drive one card (NCCL refuses them a
    group; gloo takes them).  Every rank publishes its card, host name and
    device index, on the rendezvous KV under ``HVD_RDV_SCOPE`` and reads
    every other rank's, so that all ranks reach the same answer.  False
    for one process."""
    rank, size = basics._discover(None, None, None, None)[:2]
    if size <= 1:
        return False
    kv = _kv("ranks_share_a_card")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    kv.put(_key(f"card/{rank}"), f"{socket.gethostname()}:{index}")
    cards = {kv.wait_get(_key(f"card/{r}"), timeout=timeout)
             for r in range(size)}
    return len(cards) < size


def _kv(what: str):
    rdv_addr = os.environ.get("HVD_RENDEZVOUS_ADDR")
    rdv_port = os.environ.get("HVD_RENDEZVOUS_PORT")
    if not rdv_addr or not rdv_port:
        raise RuntimeError(
            f"{what} needs the launcher rendezvous "
            "(HVD_RENDEZVOUS_ADDR/PORT); run under the launcher or export "
            "them manually")

    from horovod_tpu_torch.runner.http_client import KVClient

    return KVClient(rdv_addr, int(rdv_port))


def _key(name: str) -> str:
    scope = os.environ.get("HVD_RDV_SCOPE", "")
    return f"hvd/{scope}/{name}" if scope else f"hvd/{name}"


def reset() -> None:
    """Forget the store address, so that the next
    :func:`init_torch_distributed` publishes or reads one again: an
    elastic re-form (``elastic/run.py``) forms a new group over a fresh
    store at every incarnation, under that incarnation's
    ``HVD_RDV_SCOPE``."""
    global _initialized
    _initialized = False


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _my_addr(kv) -> str:
    """The address peers reach this host at: the launcher's NIC list
    (``HVD_NIC``) wins, else the route the rendezvous connection takes."""
    my_host = None
    nic = os.environ.get("HVD_NIC")
    if nic:
        from horovod_tpu_torch.runner.run import interface_address_any

        try:
            my_host = interface_address_any(nic)
        except ValueError:
            my_host = None  # NIC list from another host; fall back
    return my_host or kv.local_address() or "127.0.0.1"
