"""``@hvd.elastic.run``: the in-process re-form of the gang.  The port of
``horovod_tpu/elastic/run.py``.

The wrapper catches a failure, tears the eager engine down, re-forms the
gang through the launcher's KV rendezvous under the next membership
epoch, rolls the state back to its last commit, re-syncs it from the new
rank 0 and calls the user's function again.  No process is relaunched:
the survivors keep their CUDA context, their built kernels and their model
on the card.

Failures it handles:

* :class:`~horovod_tpu_torch.common.types.RanksFailedError`: the
  coordinator evicted dead ranks and broadcast the set, so every survivor
  computes the same new membership;
  :class:`~horovod_tpu_torch.common.types.CollectiveTimeoutError`, its
  subclass, also replays the aborted batch (below);
* a lost coordinator (a ``RuntimeError`` while the engine's abort reason
  names the coordinator): a failure of rank 0, whose lowest surviving old
  rank takes the lead (leader failover);
* a failed ``torch.distributed`` collective, on a rank whose ``init``
  formed a process group: the group's error names no rank, so the wrapper
  asks the engine for its verdict (``PyEngine.group_abort``, told the
  failed group's ranks, which ``ops/collective.py`` puts on the error) and
  re-forms without the ranks it names, never on the group's word alone;
  a rank outside the failed group hears the verdict and re-forms too;
* :class:`~horovod_tpu_torch.elastic.driver.HostsUpdatedInterrupt`: no
  failure; a joiner announced itself or the discovery script found new
  hosts, and every rank raised it at the same ``State.commit()``.

A ``FencedError`` and any other error go through: a fenced rank has no
seat in the new gang.

The re-form's KV keys (the JAX package's, so that JAX and port ranks
re-form one gang), under the launch-time ``HVD_RDV_SCOPE``, frozen once as
``HVD_ELASTIC_SCOPE_BASE``:

* ``elastic/roster/0/<rank>``: each rank's uid at epoch 0;
* ``elastic/pending/<uid>`` and ``elastic/notify``: a joiner announces
  itself and bumps the counter the commit check polls;
* ``elastic/world/<epoch>``: the leader (the lowest surviving old rank)
  writes the new world, a JSON list of uids in rank order; each member's
  new rank is its index, so that the new rank 0 is the lowest surviving
  committed rank and ``state.sync()`` roots at 0;
* ``elastic/assign/<uid>``: the leader's grant of epoch, rank and size to
  a waiting joiner.

Each incarnation initializes under ``HVD_ELASTIC_EPOCH=<n>`` (on every
frame; the coordinator fences another epoch's) and
``HVD_RDV_SCOPE=<base>.elastic-<n>`` (a fresh rendezvous namespace), in a
flat topology (each rank its own host block), on the first incarnation's
device and with its backend.  A rank the wrapper initializes forms no
``torch.distributed`` process group (``backend="none"``).  A rank whose
``init`` formed one gets a new group at every incarnation, with the same
backend, since one process drives one card and a group dies with any of
its ranks:

* the re-form destroys the old group (``hvd.shutdown()``), with it every
  mesh built on it (``parallel.mesh.StaleMeshError`` from then on), and
  forgets the old store's address (``multihost.reset()``); an NCCL group
  of a gang that lost a rank is aborted instead
  (``basics.abort_process_groups``), and the engine aborts it as soon as
  it learns of the loss (an eviction, an agreed abort, a lost
  coordinator), which frees a host thread held by a kernel that waits on
  the dead peer;
* the new rank 0 hosts a fresh store and publishes its address under the
  new epoch's scope (``multihost.init_torch_distributed``), where every
  member reads it; a zombie of an older epoch reads its own epoch's key
  and never reaches the new store;
* a joiner's grant (``elastic/assign/<uid>``) carries the backend, and the
  joiner forms the same group at its first incarnation;
* the group's operations, its mesh's subgroups' too, are bounded by the
  collective deadline (``HVD_COLLECTIVE_TIMEOUT``, which ``hvd.init``
  reads under the wrapper), so that a gloo collective stalled on a peer
  raises in the body before the engine's verdict is stale.

The JAX wrapper re-forms no ``jax.distributed`` world: a JAX rank's mesh
is its own process's devices, where a port rank reaches other ranks' cards
only through a process group.

The quorum (``HVD_QUORUM``, default on): a re-form needs a strict majority
of the last-committed roster (half, when the half holds old rank 0), so
that two sides of a partition never both re-form; a minority stops with
``PARTITION_MINORITY``.

Records: the timeline's ``ELASTIC_RESET``, ``ELASTIC_REFORM``,
``LEADER_FAILOVER``, ``ELASTIC_REPLAY`` and ``PARTITION_MINORITY``; the
trace's ``elastic.reform`` and ``elastic.replay`` spans; the recorder's
``elastic.reform``, ``leader.failover`` and ``partition.minority`` notes
(a failover and a minority dump it); the registry's
``hvd_elastic_reforms_total`` and ``hvd_leader_failovers_total``.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import socket
import time
from typing import List, Optional, Set, Union

import torch

from horovod_tpu_torch.elastic.driver import (
    ElasticDriver,
    HostDiscoveryScript,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.telemetry import blackbox as _bb
from horovod_tpu_torch.telemetry import registry as _tmx
from horovod_tpu_torch.telemetry import trace as _trace
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import timeline as _timeline

log = logging.getLogger("horovod_tpu_torch.elastic")

_ASSIGN_TIMEOUT_S = 600.0


def _postmortem_suffix() -> str:
    """Where the flight recorder's dumps landed, for a terminal error."""
    if not env_util.blackbox_enabled():
        return ""
    return f"; postmortem: {env_util.blackbox_dir()}"


def _worker_uid() -> str:
    uid = os.environ.get(env_util.ELASTIC_UID, "")
    return uid or f"{socket.gethostname()}:{os.getpid()}"


class _ElasticContext:
    """This process's view of the gang across incarnations."""

    def __init__(self, device: torch.device, backend: str = "none"):
        from horovod_tpu_torch.runner.http_client import KVClient

        self.device = device
        # The process group's backend at every incarnation ("none": no
        # group).
        self.backend = backend
        self.uid = _worker_uid()
        addr = os.environ.get(env_util.RENDEZVOUS_ADDR, "127.0.0.1")
        port = int(os.environ.get(env_util.RENDEZVOUS_PORT, "0"))
        self.kv = KVClient(addr, port)
        self.scope = os.environ.get("HVD_ELASTIC_SCOPE_BASE", "")
        self.epoch = env_util.get_int(env_util.ELASTIC_EPOCH, 0)
        self.min_np = env_util.get_int(env_util.ELASTIC_MIN_NP, 1)
        self.max_np = env_util.get_int(env_util.ELASTIC_MAX_NP, 1 << 30)
        self.check_interval_s = env_util.get_float(
            env_util.ELASTIC_CHECK_INTERVAL_S, 0.5)
        self.rank = -1
        self.roster: List[str] = []  # the uid of each rank, this epoch
        self._seen_notify = 0
        self._driver: Optional[ElasticDriver] = None
        # The host set the discovery driver last saw.  Kept here, not in
        # the driver, which restarts at every re-form: its first poll is a
        # baseline, and only a change against this set is an update (or
        # every restart would publish one and re-form again).
        self._known_hosts: Optional[Set[str]] = None

    def key(self, suffix: str) -> str:
        """A KV key under the launch's scope (isolates relaunches)."""
        return f"{self.scope}/{suffix}" if self.scope else suffix

    # -- update notifications ---------------------------------------------

    def has_pending_update(self) -> bool:
        v = self.kv.get(self.key("elastic/notify"))
        return int(v) > self._seen_notify if v else False

    def consume_updates(self) -> None:
        v = self.kv.get(self.key("elastic/notify"))
        self._seen_notify = int(v) if v else 0

    def publish_update(self) -> None:
        v = self.kv.get(self.key("elastic/notify"))
        self.kv.put(self.key("elastic/notify"),
                    str((int(v) if v else 0) + 1))

    # -- roster -----------------------------------------------------------

    def gather_initial_roster(self) -> None:
        """Epoch 0: every rank publishes its uid and reads the others'."""
        from horovod_tpu_torch import basics

        self.rank = basics.rank()
        size = basics.size()
        self.kv.put(self.key(f"elastic/roster/{self.epoch}/{self.rank}"),
                    self.uid)
        timeout = env_util.get_float(env_util.START_TIMEOUT, 120.0)
        self.roster = [
            self.kv.wait_get(self.key(f"elastic/roster/{self.epoch}/{r}"),
                             timeout=timeout)
            for r in range(size)]

    # -- the discovery driver (rank 0, in-process) ------------------------

    def maybe_start_driver(self) -> None:
        script = os.environ.get(env_util.HOST_DISCOVERY_SCRIPT, "")
        if not script or self.rank != 0 or self._driver is not None:
            return

        def on_update(epoch, added, removed):
            # The driver's first poll (its epoch 1) reports the whole set
            # as added; later polls are changes.
            current = set(added) if epoch == 1 else \
                (self._known_hosts | set(added)) - set(removed)
            if self._known_hosts is not None and \
                    current != self._known_hosts:
                # Published only: the ranks interrupt together at a commit.
                self.publish_update()
            self._known_hosts = current

        self._driver = ElasticDriver(
            HostDiscoveryScript(script), self.min_np, self.max_np,
            on_hosts_updated=on_update)
        self._driver.start()

    def stop_driver(self) -> None:
        if self._driver is not None:
            self._driver.stop()
            self._driver = None


def _set_world_env(rank: int, size: int, epoch: int) -> None:
    # A re-formed gang is flat (each rank its own block): the two-level
    # paths stay off until a relaunch rebuilds the host-grouped layout.
    os.environ["HVD_RANK"] = str(rank)
    os.environ["HVD_SIZE"] = str(size)
    os.environ["HVD_LOCAL_RANK"] = "0"
    os.environ["HVD_LOCAL_SIZE"] = "1"
    os.environ["HVD_CROSS_RANK"] = str(rank)
    os.environ["HVD_CROSS_SIZE"] = str(size)
    os.environ[env_util.ELASTIC_EPOCH] = str(epoch)
    base = os.environ.get("HVD_ELASTIC_SCOPE_BASE", "")
    os.environ[env_util.RDV_SCOPE] = (
        f"{base}.elastic-{epoch}" if base else f"elastic-{epoch}")


def _init(ctx: _ElasticContext) -> None:
    """Initialize this incarnation, with a new process group over a store
    that its rank 0 hosts where the gang runs one."""
    from horovod_tpu_torch import basics

    if ctx.backend != "none":
        from horovod_tpu_torch.parallel import multihost

        multihost.reset()
        multihost.init_torch_distributed(
            timeout=env_util.get_float(env_util.START_TIMEOUT, 120.0))
    basics.init(device=ctx.device, backend=ctx.backend)


def quorum_lost(roster_size: int, failed: Set[int]) -> bool:
    """True when this side of a partition holds no re-form quorum of the
    last-committed ``roster_size`` members: a strict majority wins, and an
    exact half wins only while it holds old rank 0 (of two live halves,
    exactly one does).  With rank 0 truly dead in an even split, both
    sides lose and the job needs a relaunch."""
    n_alive = roster_size - len(failed)
    return (2 * n_alive < roster_size
            or (2 * n_alive == roster_size and 0 in failed))


def _reform(ctx: _ElasticContext, failed: Set[int]) -> None:
    """Tear down, compute the new world, and re-init at the next epoch."""
    from horovod_tpu_torch import basics, process_sets

    t_reform0 = time.monotonic_ns()
    # The quorum gate, recorded before the teardown, while the timeline
    # and the recorder still run.
    n_alive = len(ctx.roster) - len(failed)
    if env_util.quorum_on() and ctx.roster \
            and quorum_lost(len(ctx.roster), failed):
        _timeline.engine_event(_timeline.PARTITION_MINORITY, alive=n_alive,
                               roster=len(ctx.roster),
                               failed=sorted(failed))
        _bb.note("partition.minority", t_reform0, alive=n_alive,
                 roster=len(ctx.roster), failed=sorted(failed))
        _bb.dump("partition_minority",
                 f"alive={n_alive}/{len(ctx.roster)}")
        print(f"PARTITION_MINORITY: only {n_alive} of "
              f"{len(ctx.roster)} last-committed members reachable; "
              "refusing to re-form a minority gang", flush=True)
        ctx.stop_driver()
        basics.shutdown()
        raise RuntimeError(
            f"PARTITION_MINORITY: {n_alive}/{len(ctx.roster)} members "
            f"reachable after failure of rank(s) {sorted(failed)}: no "
            "strict majority of the last-committed membership; stopping "
            "instead of re-forming a split-brain sibling gang"
            + _postmortem_suffix())
    if 0 in failed:
        _tmx.inc_counter("hvd_leader_failovers_total")
        # The old incarnation's end: dump before the teardown, so that
        # the evidence names the dead hub.
        _bb.note("leader.failover", t_reform0, failed=sorted(failed),
                 epoch=ctx.epoch)
        _bb.dump("leader_failover", f"failed={sorted(failed)}")
    _timeline.engine_event("ELASTIC_RESET", failed=sorted(failed))
    ctx.stop_driver()
    if failed:
        # An NCCL group with a dead member is aborted, never destroyed:
        # its destruction waits on kernels that wait on the dead peer
        # (a gloo group is destroyed as ever).
        basics.abort_process_groups(
            f"re-forming without rank(s) {sorted(failed)}")
    # The engine, then the process group and every mesh built on it.
    basics.shutdown()
    process_sets.reset()  # the ranks are renumbered

    new_epoch = ctx.epoch + 1
    survivors = [uid for r, uid in enumerate(ctx.roster) if r not in failed]
    if ctx.uid not in survivors:
        raise RuntimeError(
            "this rank was evicted from the gang; it cannot re-join the "
            "same incarnation (restart the process to re-join)"
            + _postmortem_suffix())

    if survivors and survivors[0] == ctx.uid:
        # The leader: admit pending joiners up to max_np, publish the
        # world, grant the joiners.
        prefix = ctx.key("elastic/pending/")
        pending = [k[len(prefix):] for k in ctx.kv.list(prefix)]
        pending = [u for u in pending if u not in survivors]
        room = max(0, ctx.max_np - len(survivors))
        admitted, deferred = pending[:room], pending[room:]
        world = survivors + admitted
        if len(world) < ctx.min_np:
            raise RuntimeError(
                f"only {len(world)} worker(s) left after failure of "
                f"rank(s) {sorted(failed)}, below --min-np={ctx.min_np}; "
                f"exiting for a full relaunch" + _postmortem_suffix())
        ctx.kv.put(ctx.key(f"elastic/world/{new_epoch}"), json.dumps(world))
        ctx.kv.put(ctx.key("elastic/epoch"), str(new_epoch))
        for i, uid in enumerate(world):
            if uid in admitted:
                ctx.kv.put(ctx.key(f"elastic/assign/{uid}"), json.dumps(
                    {"epoch": new_epoch, "rank": i, "size": len(world),
                     "backend": ctx.backend}))
                ctx.kv.delete(ctx.key(f"elastic/pending/{uid}"))
        if deferred:
            log.info("%d joiner(s) deferred (at --max-np=%d)",
                     len(deferred), ctx.max_np)
    else:
        timeout = env_util.get_float(env_util.START_TIMEOUT, 120.0)
        world = json.loads(ctx.kv.wait_get(
            ctx.key(f"elastic/world/{new_epoch}"), timeout=timeout))
        if len(world) < ctx.min_np:
            raise RuntimeError(
                f"re-formed world of {len(world)} is below "
                f"--min-np={ctx.min_np}; exiting for a full relaunch"
                + _postmortem_suffix())

    new_rank = world.index(ctx.uid)
    _set_world_env(new_rank, len(world), new_epoch)
    _init(ctx)
    ctx.epoch = new_epoch
    ctx.rank = new_rank
    ctx.roster = world
    ctx.consume_updates()
    ctx.maybe_start_driver()
    _tmx.inc_counter("hvd_elastic_reforms_total")
    # The re-formed engine restamped rank and epoch on the surviving ring.
    _bb.note("elastic.reform", t_reform0, epoch=new_epoch,
             size=len(world), failed=sorted(failed))
    if 0 in failed:
        # Recorded after the re-init: only rank 0 writes a timeline, and
        # the promoted process had none before its renumbering.
        _timeline.engine_event("LEADER_FAILOVER", failed=sorted(failed),
                               epoch=ctx.epoch - 1,
                               new_leader=new_rank == 0)
    _timeline.engine_event("ELASTIC_REFORM", epoch=new_epoch,
                           size=len(world))
    # After the re-init: the new engine's tracer is the one to record it.
    _trace.emit("elastic.reform", t_reform0, time.monotonic_ns(),
                epoch=new_epoch, size=len(world), failed=sorted(failed))
    log.info("gang re-formed: epoch %d, rank %d/%d", new_epoch, new_rank,
             len(world))


# -- evict and replay -----------------------------------------------------
# After a CollectiveTimeoutError every survivor holds copies of the aborted
# fused allreduce's inputs (runtime_py.retain_aborted_batch); after the
# re-form the wrapper replays them, so that the batch is not lost with the
# wedged rank.

_last_replay: Optional[dict] = None


def last_replay_results() -> Optional[dict]:
    """The most recent replay's results (the original tensor name -> its
    reduction over the re-formed gang), or None if none ran in this
    process."""
    return _last_replay


def _replay_aborted_batch(ctx: _ElasticContext,
                          old_roster: List[str]) -> None:
    global _last_replay
    from horovod_tpu_torch import runtime_py
    from horovod_tpu_torch.ops import eager

    batch = runtime_py.take_retained_batch()
    if not batch:
        return
    if not set(ctx.roster) <= set(old_roster):
        # A joiner came in with this re-form: it holds no retained inputs,
        # and a survivors-only replay would desync the negotiation.  The
        # loop restarts from its commit instead.
        log.warning("dropping the retained aborted batch: new worker(s) "
                    "joined during the re-form")
        return
    # Submitted together, so that the coordinator fuses them as the
    # original launch; named by epoch, apart from the loop's own names.
    t_replay0 = time.monotonic_ns()
    handles = [
        (item["name"], eager.allreduce_async(
            item["array"], name=f"replay.e{ctx.epoch}.{item['name']}",
            op=item["op"], prescale_factor=item["prescale"],
            postscale_factor=item["postscale"]))
        for item in batch]
    _last_replay = {nm: eager.synchronize(h) for nm, h in handles}
    _timeline.engine_event("ELASTIC_REPLAY", epoch=ctx.epoch,
                           tensors=len(handles))
    _trace.emit("elastic.replay", t_replay0, time.monotonic_ns(),
                epoch=ctx.epoch, tensors=len(handles))
    log.info("replayed %d aborted tensor(s) on the re-formed gang",
             len(handles))


def _join_as_new_worker(ctx: _ElasticContext) -> None:
    """A late worker: announce itself, then wait for an epoch assignment
    instead of bootstrapping at epoch 0."""
    ctx.kv.put(ctx.key(f"elastic/pending/{ctx.uid}"), "1")
    ctx.publish_update()
    deadline = time.monotonic() + env_util.get_float(
        "HVD_ELASTIC_JOIN_TIMEOUT", _ASSIGN_TIMEOUT_S)
    while True:
        v = ctx.kv.get(ctx.key(f"elastic/assign/{ctx.uid}"))
        if v is not None:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                "no gang admitted this joiner (is a job with --max-np "
                "headroom running?)")
        time.sleep(ctx.check_interval_s)
    grant = json.loads(v)
    # A JAX leader's grant names no backend: its gang has no group.
    ctx.backend = grant.get("backend", "none")
    os.environ.pop(env_util.ELASTIC_JOINER, None)
    _set_world_env(grant["rank"], grant["size"], grant["epoch"])
    _init(ctx)
    ctx.epoch = grant["epoch"]
    ctx.rank = grant["rank"]
    timeout = env_util.get_float(env_util.START_TIMEOUT, 120.0)
    ctx.roster = json.loads(ctx.kv.wait_get(
        ctx.key(f"elastic/world/{ctx.epoch}"), timeout=timeout))
    ctx.consume_updates()


def _wait_abort_reason() -> Optional[str]:
    """The engine's abort reason, polled for up to 2 s: a dead hub shows
    first as the training thread's socket error, and the engine's
    lost-coordinator abort lands a beat later."""
    from horovod_tpu_torch import basics

    reason = basics.engine_abort_reason()
    deadline = time.monotonic() + 2.0
    while reason is None and time.monotonic() < deadline:
        time.sleep(0.05)
        reason = basics.engine_abort_reason()
    return reason


def _is_group_error(e: BaseException) -> bool:
    """A failed ``torch.distributed`` collective: one of the port's
    collectives (``ops/collective.py`` puts its group's ranks on the
    error, whichever backend raised it), or a ``DistError`` of a call
    made on the group directly."""
    return hasattr(e, "group_ranks") or isinstance(
        e, torch.distributed.DistError)


_last_group_error = None


def last_group_error():
    """The engine's typed error for the most recent process-group failure
    that this process re-formed after (a
    :class:`~horovod_tpu_torch.common.types.CollectiveTimeoutError` naming
    the wedged ranks), or None."""
    return _last_group_error


def _group_failure(e: RuntimeError) -> Set[int]:
    """The ranks to re-form without after a failed group collective, as
    the engine rules them (:meth:`PyEngine.group_abort`); re-raises ``e``
    when it names none."""
    from horovod_tpu_torch import basics

    reason = basics.engine_abort_reason()
    if reason is None:
        abort = getattr(basics._engine_obj, "group_abort", None)
        wedged = abort(getattr(e, "group_ranks", None)) \
            if abort is not None else []
        if wedged:
            global _last_group_error
            _last_group_error = basics._engine_obj._collective_err
            log.warning("process-group collective failed (%s); the gang's "
                        "verdict: rank(s) %s", e, wedged)
            return set(wedged)
        if wedged is None:
            reason = _wait_abort_reason()
    if reason is not None and "coordinator" in reason:
        return {0}
    raise e


def run(func=None, *, device: Union[str, torch.device, None] = None):
    """Decorator: ``@hvd.elastic.run`` around a training function whose
    first argument is a :class:`~horovod_tpu_torch.elastic.state.State`.

    The function is called again after every re-form, with the state
    rolled back to its last commit and synced from the new rank 0: it must
    resume from the state (``state.step``, ...), not from scratch.

    Every incarnation runs on one device, with one backend: the running
    runtime's where the wrapper is entered after ``hvd.init()`` (a rank
    that formed a process group gets a new one at every re-form), else
    ``device`` (default: the card, ``cuda:<local_rank>``) with no process
    group.  A joiner, uninitialized until its grant, names its device as
    ``@hvd.elastic.run(device=...)`` and takes the gang's backend from
    the grant."""
    if func is None:
        return functools.partial(run, device=device)

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.common.types import (
            CollectiveTimeoutError,
            RanksFailedError,
        )

        # The native engine has no in-process re-form: an elastic rank
        # runs the Python engine (the launcher's elastic mode sets it
        # too).
        os.environ.setdefault("HVD_TPU_CORE", "py")
        # Frozen before a re-form rewrites HVD_RDV_SCOPE: every elastic
        # key and later scope derives from it, so that a relaunch (a new
        # scope) never reads a dead attempt's keys.
        if "HVD_ELASTIC_SCOPE_BASE" not in os.environ:
            os.environ["HVD_ELASTIC_SCOPE_BASE"] = \
                os.environ.get(env_util.RDV_SCOPE, "")
        joined = env_util.get_bool(env_util.ELASTIC_JOINER, False)
        backend = "none"
        if basics.is_initialized():
            dev = basics.device()
            if basics.has_process_group():
                backend = str(torch.distributed.get_backend())
        else:
            dev = basics.resolve_device(device, "@hvd.elastic.run")
        ctx = _ElasticContext(dev, backend)
        if not joined and not basics.is_initialized():
            os.environ.setdefault(env_util.ELASTIC_EPOCH, "0")
            ctx.epoch = env_util.get_int(env_util.ELASTIC_EPOCH, 0)
            _init(ctx)
        state._elastic_ctx = ctx
        if joined:
            # A joiner never bootstraps epoch 0: it waits for its grant
            # and first initializes there.
            _join_as_new_worker(ctx)
        else:
            # No consume_updates() here: at the first incarnation every
            # notification is a joiner's that waits for admission (a
            # relaunch has a fresh scope, and the discovery driver's first
            # poll is a baseline), and consuming it would strand a joiner
            # that announced itself before this rank got here.
            ctx.gather_initial_roster()
            ctx.maybe_start_driver()
        try:
            while True:
                replay = False
                try:
                    if joined:
                        # The first sync delivers the gang's state; the
                        # incumbents' matching one is their post-reset
                        # sync below.
                        state.sync()
                        joined = False
                    return func(state, *args, **kwargs)
                except RanksFailedError as e:
                    failed = set(e.ranks)
                    # A hung rank (not a dead one): every survivor kept
                    # the aborted batch's inputs; replay after the re-form.
                    replay = isinstance(e, CollectiveTimeoutError)
                except HostsUpdatedInterrupt:
                    failed = set()
                except RuntimeError as e:
                    if ctx.backend != "none" and _is_group_error(e):
                        failed = _group_failure(e)
                    else:
                        reason = _wait_abort_reason()
                        if reason is None or "coordinator" not in reason:
                            raise
                        # The hub died: a failure of rank 0.
                        failed = {0}
                old_roster = list(ctx.roster)
                _reform(ctx, failed)
                state.on_reset()
                state.restore()
                state.sync()
                if replay:
                    _replay_aborted_batch(ctx, old_roster)
        finally:
            ctx.stop_driver()
            state._elastic_ctx = None

    return wrapper
