"""The gang-wide serving loop, lockstep continuous-batching decode: the port
of ``horovod_tpu/serving/loop.py``.

One :class:`ServingLoop` runs on every rank (``run()`` blocks for the life
of the deployment).  Rank 0 drives: at each token boundary it drains the
scheduler's admission queue into free slots, encodes the batch delta as one
``TAG_SERVE`` frame (``common/wire.py``'s serve delta) and pushes it to
every rank over the control channel (``runtime_py``'s ``serve_broadcast``),
itself included, so that every rank runs the same ``_apply_frame``: prefill
the admitted prompts, one :class:`DecodeEngine` step, retire the finished
slots.  Greedy decode is deterministic, so retirements need no broadcast.

Robustness comes from the engine's own machinery:

* each step ends in a token-agreement allreduce (``__serve.confirm``, MAX
  over the next-token vector, a CPU float64 tensor through the eager
  engine).  It gives the collective deadline a data-plane op to bound (a
  rank wedged in the ring trips the hop deadline, the abort agreement
  names it, and the survivors raise ``CollectiveTimeoutError`` out of this
  loop), feeds the straggler detector, and checks determinism: a rank
  whose tokens differ from the gang's MAX fails the step;
* the epoch body runs under ``@hvd.elastic.run``: after an abort the gang
  re-forms in process, a fresh :class:`DecodeEngine` is built against the
  new world (the old one dropped first), and rank 0 requeues every
  in-flight request at the front of its queue, replayed from its prompt to
  the same tokens (at-least-once);
* leader failover: every rank keeps the in-flight slot table the frames
  describe (the shadow).  When rank 0 dies, the lowest survivor becomes
  rank 0, seeds a fresh scheduler from its shadow
  (``Scheduler.adopt_shadow``) and flips its front door, bound since
  start-up and forwarding to the leader until then, to admit requests
  itself; a client re-POSTing an id joins the adopted request.  The
  leader's door address is published under the elastic-scoped KV key
  ``serve/leader`` and carried on every frame.

A rank that stalls outside the data plane (the ``serve.step`` fault site,
kind ``stall``) never submits its allreduce, so the collective deadline
cannot see it: the coordinator's stall warnings can.

Records: the trace's ``serve.engine`` (a ``DecodeEngine`` built),
``serve.apply`` and ``serve.confirm`` spans, the flight recorder's
``serve.confirm`` note, the leader's
``hvd_serve_token_latency_seconds`` histogram and ``Scheduler.note_step``
(``/stats``' ``last_step_age_s``).

Unlike the JAX package's loop, this one takes the port's model and a
device: ``device=None`` is the card (``basics.resolve_device``), and a
process with no card raises ``NoCudaDeviceError``.  Without a mesh,
``run()`` initializes with ``hvd.init(device=..., backend="none")``.

``mesh=`` serves over tensor parallelism, as the JAX loop's does, but the
mesh spans ranks: one process drives one card, so a ``tp`` group is a group
of gang ranks over a ``torch.distributed`` process group, which
``@hvd.elastic.run`` re-forms at every incarnation.  ``mesh`` is a
:class:`~horovod_tpu_torch.parallel.mesh.Mesh` built after ``hvd.init()``
formed a group, or a dict of axis sizes, with which ``run()`` initializes
and forms the group itself: gloo on the CPU and where two ranks drive one
card (``multihost.ranks_share_a_card``; NCCL refuses them), NCCL where
each rank drives a card of its own, bounded by the collective deadline
(``HVD_COLLECTIVE_TIMEOUT``, ``hvd.init``'s rule under the elastic
wrapper).  The loop keeps the whole model (``model``), and at every
incarnation:

* rebuilds the mesh with ``make_mesh`` from the caller's axis sizes but
  ``dp``, which takes the rest of the ranks (the caller's mesh is bound to
  the first incarnation's group);
* takes, where the new size is not a multiple of the asked ``tp`` (a gang
  of four at dp 2 x tp 2 that lost a rank), the largest ``tp`` not above
  the asked one that divides the size and the model's heads, ``d_ff`` and
  vocabulary: the log, the recorder's ``serve.tp`` note and the
  ``serve.engine`` span carry it (the JAX package's mesh is one process's
  devices and never meets this case);
* cuts this rank's shard of the model (``transformer.shard_state_dict``):
  a promoted or renumbered rank holds another slice than before.

The decode's tensor-parallel collectives run over the group: the
``reduce_from_axis`` SUM allreduces (the embedding's and two a layer;
``copy_to_axis`` is the identity forward) and the head's all-gather of
the logits, 2L + 2 a step; the serve frames and the ``__serve.confirm``
allreduce stay on the engine.  Gloo takes CUDA tensors for ``all_reduce``
and ``all_gather``, the two the decode runs; one it refused would raise,
never fall back.  In-flight requests replay from their prompts after a
re-form, so each reply is computed within one incarnation and one ``tp``.

A dead or stalled tp peer: gloo fails the survivors' collective at once
(a closed socket) or at the deadline, and the gang re-forms without it;
a rank outside the failed group, waiting on the engine, is never blamed.
Over NCCL (a card a rank) a dead peer's kernel never ends, and a
survivor waits in its step's host copy: the eager engine evicts the rank
whose control link dropped and aborts the incarnation's NCCL
communicators (``basics.abort_process_groups``), the copy returns, the
step's next collective fails, and the gang re-forms as over gloo.  A
stalled (live) NCCL peer's collective stays pending on the card until the
collective watch (``parallel/group_watch.py``) aborts the groups at the
deadline; the copy then raises ``GroupAbortedError`` and the verdict
names the silent peer.  A peer that dies outside the tp collectives, in
the token-agreement allreduce or before it joins it, is the engine's to
name, on either backend: it evicts the rank whose link dropped, and a hop
that failed on that link goes to the gang's agreement.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import types
from typing import Callable, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.serving.decode import DecodeEngine
from horovod_tpu_torch.serving.scheduler import Scheduler
from horovod_tpu_torch.serving.server import FrontDoor
from horovod_tpu_torch.telemetry import blackbox as _bb
from horovod_tpu_torch.telemetry import registry as _tmx
from horovod_tpu_torch.utils import env as env_util

log = logging.getLogger("horovod_tpu_torch.serving")


class ServingLoop:
    """Continuous-batching inference over the live gang.

    ``run()`` initializes (if needed), starts this rank's front door, and
    serves until ``stop()``, re-forming the gang in process after a rank's
    failure.  The knobs default from ``HVD_SERVE_*`` (``hvdrun
    --serve-port/--serve-max-batch/--serve-max-queue``).  ``on_ready(port)``
    is called once, when this rank's door listens; on the leader, after
    its address is published too."""

    def __init__(self, model, cfg, *,
                 device=None,
                 max_batch: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 port: Optional[int] = None,
                 host: str = "0.0.0.0",
                 cache_len: Optional[int] = None,
                 mesh=None,
                 eos_id: Optional[int] = None,
                 request_timeout_s: float = 120.0,
                 recv_timeout_s: float = 1.0,
                 idle_poll_s: float = 0.002,
                 on_ready: Optional[Callable[[int], None]] = None):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.max_batch = max_batch or env_util.serve_max_batch()
        self.max_queue = max_queue or env_util.serve_max_queue()
        self.port = env_util.serve_port() if port is None else port
        self.host = host
        self.cache_len = cache_len or cfg.max_seq_len
        # The caller's axis sizes (a Mesh's shape, or a dict); None: no
        # mesh, one rank holds the whole model.
        self.axes = None if mesh is None else dict(
            getattr(mesh, "shape", mesh))
        self.tp = 1  # this incarnation's tp
        self.eos_id = eos_id
        self.request_timeout_s = request_timeout_s
        self.recv_timeout_s = recv_timeout_s
        self.idle_poll_s = idle_poll_s
        self.on_ready = on_ready
        self.scheduler: Optional[Scheduler] = None
        self.engine: Optional[DecodeEngine] = None
        self._door: Optional[FrontDoor] = None
        self._stop = threading.Event()
        # slot -> {"id", "prompt", "max_new", "remaining"}.  Every rank
        # derives the same table from the same frames: the follower's
        # shadow of the leader's in-flight requests, which a rank promoted
        # to 0 seeds its scheduler from (prompt and max_new are all a
        # replay needs).
        self._slots: Dict[int, Dict] = {}
        # The leader's front door ("host:port") as the last frame carried
        # it; the KV key serve/leader holds the authoritative copy.
        self._known_leader: Optional[str] = None
        self._elastic_ctx = None

    # -- lifecycle -------------------------------------------------------

    def stop(self) -> None:
        """Drain and exit: rank 0 finishes every queued and active
        request, then broadcasts a stop frame."""
        self._stop.set()

    def run(self) -> None:
        """Serve until ``stop()``.  Blocks; re-forms the gang in process
        after a rank's failure (``@hvd.elastic.run``)."""
        from horovod_tpu_torch import basics, elastic

        # The serve channel is the Python engine's.
        os.environ.setdefault("HVD_TPU_CORE", "py")
        if not basics.is_initialized():
            dev = basics.resolve_device(self.device, "ServingLoop")
            backend = "none"
            if self.axes is not None:
                from horovod_tpu_torch.parallel import multihost

                multihost.init_torch_distributed()
                backend = "gloo" if dev.type != "cuda" or \
                    multihost.ranks_share_a_card(dev) else "nccl"
            basics.init(device=dev, backend=backend)
        self.device = basics.device()
        try:
            if basics.size() == 1 and \
                    not os.environ.get(env_util.RENDEZVOUS_ADDR):
                # One process and no launcher: no gang to re-form (and no
                # KV store for the elastic protocol), one incarnation.
                self._epoch_body(types.SimpleNamespace(serve_generation=0))
            else:
                state = elastic.ObjectState(serve_generation=0)
                elastic.run(self._epoch_body)(state)
        finally:
            self.engine = None
            if self._door is not None:
                self._door.stop()
                self._door = None
            if self.scheduler is not None:
                self.scheduler.fail_all("serving loop exited")

    # -- one gang incarnation -------------------------------------------

    def _epoch_body(self, state) -> None:
        from horovod_tpu_torch import basics

        eng = basics._engine_obj
        if eng is None:
            raise RuntimeError(
                "serving needs the eager engine: start the ranks through "
                "the launcher's rendezvous (HVD_RENDEZVOUS_ADDR/PORT)")
        if not hasattr(eng, "serve_broadcast"):
            raise RuntimeError(
                "serving requires the Python engine (HVD_TPU_CORE=py)")
        self._elastic_ctx = getattr(state, "_elastic_ctx", None)
        tr = getattr(eng, "_tracer", None)
        tb0 = time.monotonic_ns() if tr is not None else 0
        # The last incarnation's engine (its KV cache and cast matrices)
        # goes before this one's is allocated.
        self.engine = None
        mesh, model = self._incarnation_mesh()
        engine = self.engine = DecodeEngine(
            model, self.cfg, max_batch=self.max_batch,
            cache_len=self.cache_len, mesh=mesh, device=self.device)
        if tr is not None:
            # Host time: device work the build queued lands in the first
            # serve.apply.
            tr.span("serve.engine", tb0, time.monotonic_ns(),
                    epoch=eng.epoch, tp=self.tp)
        # The previous incarnation's in-flight table survives the reset
        # here: on a promoted rank it seeds the fresh scheduler below.
        shadow = sorted(self._slots.items())
        self._slots = {}
        leader = basics.rank() == 0
        if leader and self.scheduler is None:
            # Promoted (or first start): seed the scheduler from the
            # shadow BEFORE the door flips to the leader's role, so that a
            # client re-POSTing an in-flight id joins the adopted request.
            self.scheduler = Scheduler(self.max_batch, self.max_queue,
                                       self.cache_len)
            if shadow:
                adopted = self.scheduler.adopt_shadow(shadow)
                log.info("promoted to serving leader: adopted %d "
                         "in-flight request(s) from the shadow slot table",
                         adopted)
        first_door = self._door is None
        self._ensure_front_door(leader=leader)
        if leader:
            state.serve_generation += 1
            replayed = self.scheduler.requeue_inflight()
            if replayed:
                log.info("re-formed gang (generation %d): replaying %d "
                         "in-flight request(s) from their prompts",
                         state.serve_generation, replayed)
            self._publish_leader()
        if first_door and self.on_ready is not None:
            # On the leader after its address is published: from here on
            # every door of the gang forwards to it.
            self.on_ready(self._door.port)
        if leader:
            self._drive(eng, engine)
        else:
            self._follow(eng, engine)

    def _choose_tp(self, size: int) -> int:
        """The largest ``tp`` not above the asked one that divides the
        gang (with the caller's other axes but ``dp``) and the model."""
        asked = self.axes.get("tp", 1)
        fixed = 1
        for name, n in self.axes.items():
            if name not in ("dp", "tp"):
                fixed *= n
        cfg = self.cfg
        for tp in range(min(asked, size), 0, -1):
            if size % (fixed * tp) == 0 and not (
                    cfg.n_heads % tp or cfg.d_ff % tp
                    or cfg.vocab_size % tp):
                return tp
        raise ValueError(f"a gang of {size} rank(s) holds no mesh of the "
                         f"axes {self.axes} but dp")

    def _incarnation_mesh(self):
        """This incarnation's mesh (None without one) and this rank's
        model: its shard over the mesh's ``tp``."""
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.models import transformer as T
        from horovod_tpu_torch.parallel.mesh import make_mesh

        if self.axes is None:
            return None, self.model
        size = basics.size()
        self.tp = tp = self._choose_tp(size)
        # The caller's order; a dp it did not name goes first.
        axes = {} if "dp" in self.axes else {"dp": -1}
        axes.update((name, -1 if name == "dp" else tp if name == "tp"
                     else n) for name, n in self.axes.items())
        axes.setdefault("tp", tp)
        mesh = make_mesh(axes)
        asked = self.axes.get("tp", 1)
        log.info("serving over %s: tp %d (asked %d) on %d rank(s)",
                 mesh.shape, tp, asked, size)
        _bb.note("serve.tp", time.monotonic_ns(), tp=tp, asked=asked,
                 size=size)
        if tp == 1:
            return mesh, self.model
        with torch.device(self.device):
            model = T.Transformer(self.cfg, mesh)
        model.load_state_dict(T.shard_state_dict(
            self.model.state_dict(), self.cfg, mesh))
        return mesh, model

    def _ensure_front_door(self, leader: bool = True) -> None:
        """Bind this rank's front door once per process (its port is
        stable across re-elections).  A leader's door admits into the
        scheduler, a follower's forwards to the leader; a promoted
        follower's door flips to the leader's role in place."""
        if self._door is None:
            self._door = FrontDoor(
                self.scheduler if leader else None, host=self.host,
                port=self.port, timeout_s=self.request_timeout_s,
                leader_addr_fn=self._leader_addr,
                advertise_host=self._advertise_host())
            door_port = self._door.start()
            if leader:
                self.port = door_port
            log.info("serving front door listening on :%d (%s)", door_port,
                     "leader" if leader else "forwarding to the leader")
        elif leader and self._door.scheduler is None:
            self._door.scheduler = self.scheduler
            self.port = self._door.port
            log.info("front door :%d promoted to serving leader", self.port)

    # -- the leader's address: publish and resolve -----------------------

    def _advertise_host(self) -> str:
        ctx = self._elastic_ctx
        if ctx is not None:
            addr = ctx.kv.local_address()
            if addr:
                return addr
        return "127.0.0.1"

    def _publish_leader(self) -> None:
        """Rank 0: publish this door's address under the elastic-scoped KV
        key, so that follower doors resolve the leader before the epoch's
        first frame."""
        self._known_leader = f"{self._advertise_host()}:{self.port}"
        ctx = self._elastic_ctx
        if ctx is not None:
            try:
                ctx.kv.put(ctx.key("serve/leader"), self._known_leader)
            except Exception:
                # The KV store is briefly unreachable (failing over to a
                # standby): the frames still carry the address.
                log.warning("could not publish the serving leader's "
                            "address to the KV store")

    def _leader_addr(self, refresh: bool = False) -> Optional[str]:
        """Follower doors resolve the leader here: the frame-carried
        address, or the KV key on ``refresh`` (a forward just failed, and a
        re-election may have moved the leader)."""
        if refresh:
            ctx = self._elastic_ctx
            if ctx is not None:
                try:
                    v = ctx.kv.get(ctx.key("serve/leader"))
                except Exception:
                    v = None
                if v:
                    self._known_leader = v
        return self._known_leader

    # -- rank 0: drive ---------------------------------------------------

    def _drive(self, eng, engine: DecodeEngine) -> None:
        seq = 0
        while True:
            stopping = self._stop.is_set() and not self.scheduler.has_work()
            admissions = self.scheduler.take_admissions()
            if not stopping and not admissions and not self._slots:
                time.sleep(self.idle_poll_s)  # idle: no frame, no step
                continue
            seq += 1
            eng.serve_broadcast(wire.encode_serve_delta(
                seq, stopping,
                [(slot, r.id, r.max_new, r.prompt)
                 for slot, r in admissions],
                eng.epoch, leader_addr=self._known_leader or ""))
            frame = eng.serve_recv(timeout=self.recv_timeout_s)
            if frame is None:  # our own frame is in the inbox unless dying
                if self._engine_dying(eng):
                    return
                continue
            if self._apply_frame(frame, eng, engine, rank0=True):
                return

    # -- the other ranks: follow -----------------------------------------

    def _follow(self, eng, engine: DecodeEngine) -> None:
        while True:
            frame = eng.serve_recv(timeout=self.recv_timeout_s)
            if frame is None:
                if self._engine_dying(eng):
                    return
                continue  # a plain timeout: keep listening
            if self._apply_frame(frame, eng, engine, rank0=False):
                return

    @staticmethod
    def _engine_dying(eng) -> bool:
        """After a None from ``serve_recv``: a timeout (go on), a clean
        shutdown (exit), or an abort, raised as the ``RuntimeError`` the
        elastic wrapper reads (a lost coordinator is rank 0's failure)."""
        if getattr(eng, "_aborted", False):
            raise RuntimeError(
                getattr(eng, "_abort_reason", None) or "engine aborted")
        return eng._shutdown_flag.is_set() or \
            eng._shutdown_requested.is_set()

    # -- the lockstep step (the same on every rank) ----------------------

    def _apply_frame(self, frame, eng, engine, *, rank0: bool) -> bool:
        seq, stopping, admissions, epoch, leader_addr = \
            wire.decode_serve_delta_ex(frame)
        if epoch != eng.epoch:
            return False  # a stale frame of an earlier incarnation
        if leader_addr and not rank0:
            self._known_leader = leader_addr
        if stopping:
            return True
        # A stall or delay of this rank mid-decode, before any device
        # work, so that the step's collective shows the gap.
        _fi.fire("serve.step", str(seq))
        tr = getattr(eng, "_tracer", None)
        ta0 = time.monotonic_ns() if tr is not None else 0
        t0 = time.monotonic()
        for slot, req_id, max_new, prompt in admissions:
            first = engine.prefill(slot, prompt)
            self._slots[slot] = {"id": req_id, "prompt": list(prompt),
                                 "max_new": max_new, "remaining": max_new}
            self._emit(slot, first, engine, rank0)
        if self._slots:
            toks = engine.step()  # the step's one device-to-host copy
            tc0 = time.monotonic_ns() if tr is not None else 0
            self._confirm(toks)
            if tr is not None:
                # The agreement allreduce's own spans share this window;
                # serve.confirm ties them to the frame's seq.
                tr.span("serve.confirm", tc0, time.monotonic_ns(),
                        step=seq, slots=len(self._slots))
            for slot in sorted(self._slots):
                self._emit(slot, int(toks[slot]), engine, rank0)
            _bb.note("serve.confirm", tc0, step=seq,
                     slots=len(self._slots))
            if rank0:
                t1 = time.monotonic()
                _tmx.observe("hvd_serve_token_latency_seconds", t1 - t0)
                self.scheduler.note_step(t1)
        if tr is not None:
            tr.span("serve.apply", ta0, time.monotonic_ns(), step=seq,
                    admitted=len(admissions))
        return False

    def _emit(self, slot: int, token: int, engine: DecodeEngine,
              rank0: bool) -> None:
        st = self._slots[slot]
        if rank0:
            self.scheduler.on_token(slot, token)
        st["remaining"] -= 1
        if st["remaining"] <= 0 or \
                (self.eos_id is not None and token == self.eos_id):
            engine.clear(slot)
            del self._slots[slot]
            if rank0:
                self.scheduler.complete(slot)

    def _confirm(self, toks: np.ndarray) -> None:
        """The token-agreement allreduce: the step's data-plane op (the
        deadline's and the straggler detector's) and the greedy lockstep's
        determinism check."""
        from horovod_tpu_torch.ops import eager

        local = torch.from_numpy(np.asarray(toks, dtype=np.float64))
        agreed = eager.allreduce(local, op=ReduceOp.MAX,
                                 name="__serve.confirm")
        if not torch.equal(torch.as_tensor(agreed), local):
            raise RuntimeError(
                "serving token divergence: this rank's greedy tokens "
                "differ from the gang's; lockstep decode is broken "
                "(non-deterministic kernels or mismatched weights?)")
