"""Process-group runtime: init / shutdown / rank / size / device.

The port of ``horovod_tpu/basics.py`` over ``torch.distributed``.  Rank
discovery, in order:

1. explicit ``init(rank=..., size=...)`` arguments;
2. ``HVD_RANK/HVD_SIZE/HVD_LOCAL_RANK/HVD_LOCAL_SIZE`` from the launcher;
3. torchrun's ``RANK/WORLD_SIZE/LOCAL_RANK/LOCAL_WORLD_SIZE``;
4. an MPI-style launcher's variables (``runner/discovery.py``: Open MPI,
   IBM JSM, PMIx, PMI, Slurm), as under ``hvdrun --launcher mpirun``;
5. a single process (rank 0 of 1).

The cross rank and size (which host, of how many) are
``HVD_CROSS_RANK/HVD_CROSS_SIZE`` where the launcher sets them, else
``rank // local_size`` and ``size // local_size``: ranks are numbered host
by host.  (The JAX package derives them the same way from explicit
arguments, but defaults them to 0 and 1 when only ``HVD_SIZE`` is set.)

The device is ``cuda:<local_rank>`` with the NCCL backend unless the caller
passes ``device="cpu"``, which selects gloo (``backend=`` overrides the
choice).  A one-rank job still creates a real one-rank process group (over
an in-process ``HashStore``), so its gradient allreduce is a real
collective launch.

Beside the process group, ``init`` starts the eager engine that the
classic API (``hvd.allreduce``, ``hvd.broadcast_parameters``, ...) runs
on: a ``SingleProcessEngine`` at size 1, and at size > 1 an engine that
bootstraps through the launcher's rendezvous
(``HVD_RENDEZVOUS_ADDR``/``HVD_RENDEZVOUS_PORT``), as the JAX package
chooses it:

* the native C++ core (``runtime_native.NativeEngine``, built at first
  use from ``csrc/``) by default;
* ``PyEngine`` (``runtime_py.py``) under ``HVD_TPU_CORE=py``, which
  elastic jobs and serving set, or when the core cannot be had before the
  bootstrap (no compiler, a failed build): ``native_fallback_reason`` on
  the engine says why, and a warning is logged.  A failure after the mesh
  is wired raises: the peers have already taken this rank's address;
* under ``HVD_ELASTIC_EPOCH`` the native core is refused
  (``NotImplementedError``) unless the Python engine is asked for: the
  core has no in-process re-form.

Without a rendezvous a multi-rank ``init`` starts no engine (the compiled
regime needs none), and an eager op then raises
:class:`EngineUnavailableError`.  ``shutdown`` stops the engine before it
destroys the process group.

``init`` after ``shutdown`` in one process builds a new runtime from the
environment as it stands then: an elastic re-form (``elastic/run.py``)
rewrites ``HVD_RANK``/``HVD_SIZE``/``HVD_RDV_SCOPE``/``HVD_ELASTIC_EPOCH``
and re-initializes with the first incarnation's device and backend: a rank
that formed a process group forms a new one over the new world.
:func:`engine_abort_reason` tells the elastic wrapper why the running
engine aborted, and :func:`abort_process_groups` frees a rank held on
an NCCL group by a dead peer.
"""

from __future__ import annotations

import datetime
import os
import threading
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.types import NoCudaDeviceError, \
    NotInitializedError
from horovod_tpu_torch.utils import env as env_util

_lock = threading.Lock()


class EngineUnavailableError(RuntimeError):
    """An eager op ran in a multi-rank job that ``init`` started without
    the launcher's rendezvous, so no eager engine runs."""

    def __init__(self, size: int):
        super().__init__(
            f"the eager engine is not running: this {size}-rank job was "
            f"initialized without a rendezvous; set "
            f"{env_util.RENDEZVOUS_ADDR} and {env_util.RENDEZVOUS_PORT} "
            f"(the launcher does) before hvd.init(), or use the mesh-axis "
            f"collectives of horovod_tpu_torch.ops.collective")


@dataclass(frozen=True)
class _World:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    device: torch.device
    group: bool = True  # a torch.distributed process group was formed
    # The group's timeout (None: the backend's default), which a mesh's
    # subgroups take too.
    group_timeout: Optional[datetime.timedelta] = None
    backend: str = ""  # the group's backend ("nccl", "gloo"; "": none)


_world: Optional[_World] = None
_engine_obj = None  # the eager engine, or None
# Why this incarnation's NCCL groups were aborted (None: they were not),
# set once under its own lock, held through the abort: the engine's
# threads abort, and ``_lock`` is held while ``shutdown`` joins them.
_group_aborted: Optional[str] = None
# Set by ``shutdown`` under the same lock: its groups are being destroyed,
# and no abort may start on them.
_groups_closing = False
_abort_lock = threading.Lock()


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
        # An MPI-style launcher's variables (hvdrun --launcher mpirun or
        # jsrun, srun): its own cross split, as the launcher laid it out.
        from horovod_tpu_torch.runner import discovery

        topo = discovery.discover()
        if topo is not None:
            return (topo.rank, topo.size,
                    topo.local_rank if local_rank is None else local_rank,
                    topo.local_size if local_size is None else local_size,
                    topo.cross_rank, topo.cross_size)
    if size is None:
        rank, size = 0, 1
    if rank is None:
        rank = 0
    if local_rank is None:
        local_rank = rank
    if local_size is None:
        local_size = size
    cross_rank = _env_int("HVD_CROSS_RANK")
    cross_size = _env_int("HVD_CROSS_SIZE")
    if cross_rank is None or cross_size is None:
        cross_rank, cross_size = rank // local_size, max(size // local_size, 1)
    return rank, size, local_rank, local_size, cross_rank, cross_size


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


def _start_engine(r, s, lr, ls, cr, cs):
    """The eager engine for this rank: ``SingleProcessEngine`` at size 1;
    at size > 1 through the launcher's rendezvous, the native engine or
    ``PyEngine`` (see the module docstring); None without one."""
    from horovod_tpu_torch import native, runtime_py

    if s == 1:
        return runtime_py.SingleProcessEngine()
    addr = os.environ.get(env_util.RENDEZVOUS_ADDR, "")
    port = os.environ.get(env_util.RENDEZVOUS_PORT, "")
    if not addr or not port:
        return None
    try:
        if os.environ.get(env_util.ELASTIC_EPOCH, "") and \
                not native.forced_python():
            raise NotImplementedError(
                "elastic training (HVD_ELASTIC_EPOCH) is not supported by "
                "the native engine; set HVD_TPU_CORE=py")
        native.load()  # raises NativeUnavailable before any rendezvous
    except native.NativeUnavailable as e:
        # Only a failure before the bootstrap falls back: after it, the
        # peers have this rank's address, and a second bootstrap under
        # another engine would hang the gang.
        eng = runtime_py.PyEngine(r, s, lr, ls, cr, cs, addr, int(port))
        eng.native_fallback_reason = str(e)
        from horovod_tpu_torch.utils.logging import get_logger

        log = get_logger(r)
        (log.info if native.forced_python() else log.warning)(
            "running the Python engine: %s", e)
        return eng
    from horovod_tpu_torch.runtime_native import NativeEngine

    return NativeEngine(r, s, lr, ls, cr, cs, addr, int(port))


def init(rank: Optional[int] = None, size: Optional[int] = None,
         local_rank: Optional[int] = None, local_size: Optional[int] = None,
         *, device: Union[str, torch.device, None] = None,
         init_method: Optional[str] = None,
         backend: Optional[str] = None) -> None:
    """Initialize the runtime for this process.  Idempotent.

    ``init_method`` is passed to ``torch.distributed.init_process_group``
    for a multi-rank job (default ``env://``: ``MASTER_ADDR`` and
    ``MASTER_PORT``).  ``backend`` overrides the process group's backend
    (NCCL on a card, gloo on the CPU): ranks that share one card, which
    NCCL refuses, pass ``device="cuda:0", backend="gloo"`` and run their
    collectives through the eager engine.  ``backend="none"`` forms no
    process group at all, only the engine: a port rank in a gang with JAX
    ranks, which have no torch process group to join, passes it (the
    mesh-axis collectives then have no group to run on).

    An elastic rank (``HVD_ELASTIC_EPOCH`` set) bounds every operation of
    its process group, the store's rendezvous included, by the collective
    deadline (``HVD_COLLECTIVE_TIMEOUT``) where one is set, so that a
    group collective stalled on a peer fails within the deadline the
    eager engine keeps, not after the backend's 30 minutes; otherwise the
    backend's default holds.  An elastic rank's NCCL group is aborted on
    the eager engine's word (:func:`abort_process_groups`, through
    torch's ``_abort_process_group``), which torch documents for use with
    the watchdog's error handling off, so that the watchdog does not
    handle the aborted communicators' errors itself: it is set off
    (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``) unless the environment sets
    it.  The group's timeout then only logs, so a live peer that stalls
    inside a group collective holds the rank until that peer's control
    link drops."""
    global _world, _engine_obj, _group_aborted, _groups_closing
    with _lock:
        if _world is not None:
            return
        r, s, lr, ls, cr, cs = _discover(rank, size, local_rank, local_size)
        dev = _device(device, lr, "hvd.init()")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        group = backend != "none"
        timeout = env_util.collective_timeout_s() \
            if os.environ.get(env_util.ELASTIC_EPOCH) else 0.0
        kw = {}
        if group and timeout > 0:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        elastic_nccl = backend == "nccl" and \
            os.environ.get(env_util.ELASTIC_EPOCH) is not None
        if elastic_nccl:
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        if group and s == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
        elif group:
            dist.init_process_group(backend,
                                    init_method=init_method or "env://",
                                    rank=r, world_size=s, **kw)
        try:
            _engine_obj = _start_engine(r, s, lr, ls, cr, cs)
        except BaseException:
            if group:
                dist.destroy_process_group()
            raise
        _world = _World(r, s, lr, ls, cr, cs, dev, group,
                        kw.get("timeout"), backend if group else "")
        _group_aborted, _groups_closing = None, False
        if elastic_nccl and hasattr(_engine_obj, "free_groups_on_failure"):
            _engine_obj.free_groups_on_failure(abort_process_groups)
        # The engines start telemetry themselves; this idempotent call
        # covers a rank with no engine, so that the eager layer's metrics
        # still count.
        from horovod_tpu_torch import telemetry

        telemetry.init_from_env(r, lr or 0, size=s)


def abort_process_groups(reason: str) -> bool:
    """Abort the NCCL communicators of the world group and of every group
    made from it (a mesh's subgroups), in one NCCL group call
    (``torch.distributed``'s ``_abort_process_group`` of the world), on the
    eager engine's word that a peer is gone: an eviction, an agreed abort,
    a lost coordinator, or an elastic re-form after a failure.

    A peer's death never ends an NCCL kernel that waits on it, and the host
    thread's next sync on the card (a decode step's copy of its tokens)
    waits behind that kernel; the abort ends the kernel, the sync returns,
    and the next collective of this incarnation raises
    ``parallel.mesh.GroupAbortedError``, which ``@hvd.elastic.run`` reads
    as a group failure.  The groups are gone after it (``shutdown`` does
    not destroy them again).  A no-op returning False for a gloo group
    (its collectives fail on a closed socket or at the group's timeout),
    for no group, after the first call and once ``shutdown`` began."""
    global _group_aborted
    # Held through the abort: a second caller (the re-form after the
    # engine's eviction) returns only once the groups are gone.
    with _abort_lock:
        if _world is None or _world.backend != "nccl" or \
                _group_aborted is not None or _groups_closing:
            return False
        _group_aborted = reason
        import logging

        logging.getLogger("horovod_tpu_torch").warning(
            "aborting the NCCL process groups: %s", reason)
        dist.distributed_c10d._abort_process_group()
    return True


def group_aborted() -> Optional[str]:
    """Why this incarnation's process groups were aborted
    (:func:`abort_process_groups`), or None."""
    return _group_aborted


def shutdown() -> None:
    """Stop the eager engine (a negotiated stop at size > 1), then tear
    down the process group; every mesh built on it goes stale
    (``parallel.mesh.StaleMeshError``).  Groups that
    :func:`abort_process_groups` aborted are not destroyed again."""
    global _world, _engine_obj, _groups_closing
    with _lock:
        if _engine_obj is not None:
            _engine_obj.shutdown()
            _engine_obj = None
        if _world is not None and _world.group:
            with _abort_lock:
                _groups_closing = True
            if _group_aborted is None:
                dist.destroy_process_group()
            # Every mesh held groups of the one just destroyed.
            from horovod_tpu_torch.parallel import mesh

            mesh.invalidate_meshes()
        _world = None
    # The metrics server and flusher stop (a final flush included); the
    # registry keeps its series, as the JAX package's does.
    from horovod_tpu_torch import telemetry

    telemetry.stop()


def _engine():
    """The running eager engine; raises a named error without one."""
    w = _w()
    if _engine_obj is None:
        raise EngineUnavailableError(w.size)
    return _engine_obj


def is_initialized() -> bool:
    return _world is not None


def has_process_group() -> bool:
    """True when ``init`` formed a ``torch.distributed`` process group
    (every backend but ``"none"``)."""
    return _w().group


def engine_abort_reason() -> Optional[str]:
    """Why the running eager engine aborted (a worker's lost coordinator
    reads ``"lost connection to coordinator"``), or None while it runs."""
    eng = _engine_obj
    if eng is not None and getattr(eng, "_aborted", False):
        return getattr(eng, "_abort_reason", None) or "aborted"
    return None


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


def cross_rank() -> int:
    """Which host this rank runs on."""
    return _w().cross_rank


def cross_size() -> int:
    """How many hosts the job spans."""
    return _w().cross_size


def device() -> torch.device:
    """The device this rank's collectives and entry points run on."""
    return _w().device


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes."""
    w = _w()
    return w.size % w.local_size == 0 and \
        w.size // w.local_size == w.cross_size


def cache_stats() -> dict:
    """The eager engine's response-cache counters (hits, misses,
    evictions, size, capacity)."""
    return _engine().cache_stats()


def metrics_snapshot() -> dict:
    """This rank's telemetry registry as JSON-able data (``{"counters":
    ..., "gauges": ..., "histograms": ...}``, Prometheus-style series
    keys), or ``{}`` with telemetry off.  Process-global: the counters
    outlive an engine."""
    from horovod_tpu_torch import telemetry

    return telemetry.snapshot()


def nccl_built() -> bool:
    """True where this torch has NCCL (the compiled regime's backend on
    the card)."""
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def mpi_built() -> bool:
    return dist.is_mpi_available()


def cuda_built() -> bool:
    """True where this torch was built with CUDA."""
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def xla_built() -> bool:
    """The port runs no XLA."""
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False
