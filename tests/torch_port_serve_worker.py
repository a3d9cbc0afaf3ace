"""The port's serving-gang worker, for ``tests/test_torch_serving_loop.py``:
``tests/serve_worker.py`` on ``horovod_tpu_torch``.

    python tests/torch_port_serve_worker.py

Every rank loads the same fp32 weights (``SERVE_WEIGHTS``, a state dict the
test saved from the JAX package's init through ``models/convert.py``),
builds the tiny transformer of ``tests/serve_worker.py`` (vocab 64, d_model
32, 2 layers, 2 heads, d_ff 64) and enters ``ServingLoop(...,
device="cpu").run()``.  A rank writes its front door's port to
``SERVE_PORT_FILE`` (when set); the serving leader writes ``SERVE_READY_FILE``
once it published its address under the KV key ``serve/leader``, from when
on a follower's door forwards.  The leader stops the loop once
``SERVE_EXPECT`` requests completed (0: never), or, with
``SERVE_STOP_FILE``, once that file exists (the test writes it when every
client has its reply).  ``SERVE_SHADOW_FILE``:
written once every slot of this rank's slot table (the frames' shadow of
the leader's in-flight requests) is live.

Knobs: ``SERVE_VICTIM=1`` with ``SERVE_STALL_SEQ=<k>`` arms a data-plane
stall (``SERVE_SITE``, default ``sock.stall``) before this rank applies
serve frame ``k``, so that it wedges in that step's token-agreement
allreduce (the worker never exits on its own).  ``SERVE_CACHE_LEN``,
``SERVE_MAX_BATCH``, ``SERVE_MAX_QUEUE`` size the loop.  ``SERVE_MODEL``
(a JSON dict of ``TransformerConfig`` widths) replaces the tiny model, and
``SERVE_MESH`` (a JSON dict of axis sizes) serves over that mesh, the loop
forming the gloo group (``tests/test_torch_serving_tp.py``); the worker
then prints ``TP <tp> epoch <e> size <n> rank <r>`` at each incarnation's
first frame.

``SERVE_FAKE_NCCL=1`` (with ``SERVE_MESH``) models an NCCL group over gloo
on the CPU, as ``tests/torch_port_elastic_worker.py``'s ``GROUP_FAKE_NCCL``
does: the loop's ``hvd.init`` asks for ``nccl`` and a stand-in
``init_process_group`` forms gloo, with a timeout of
``SERVE_GLOO_TIMEOUT_S`` (default 60) instead of the collective deadline,
so that the collective watch, not gloo, ends a wait on a stalled peer.
Each ``all_reduce``/``all_gather`` returns to the caller once its gloo
work completes or the groups are aborted, as a host sync behind an NCCL
kernel does, and its work is the watch's handle (``group_watch``'s:
pending until the peer joins).  The groups' abort clears torch's group
state without gloo's own abort, which would wait for the pending work.
The worker prints ``WATCH_FIRED ranks <json> age <s>`` when the watch's
deadline passes.

Markers (flushed): ``PORT <p>``, ``GEN <epoch>`` at start, ``GEN_FINAL
<epoch>`` after ``run()``, ``DONE``; then the sender-thread leak check of
``tests/serve_worker.py``.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)


def _write(path, text):
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


_kept_groups = []  # gloo groups "aborted" with pending work, never freed


def _fake_nccl():
    """See ``SERVE_FAKE_NCCL`` in the module docstring."""
    import datetime

    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.parallel import group_watch

    gloo_timeout = datetime.timedelta(seconds=float(
        os.environ.get("SERVE_GLOO_TIMEOUT_S", "60")))
    real_init, real_basics_init = dist.init_process_group, basics.init

    def init_process_group(backend, *a, **k):
        k["timeout"] = gloo_timeout
        return real_init("gloo" if backend == "nccl" else backend, *a, **k)

    def basics_init(*a, backend=None, **k):
        return real_basics_init(
            *a, backend="nccl" if backend == "gloo" else backend, **k)

    real_abort = c10d._abort_process_group

    def abort_process_group(group=None):
        _kept_groups.extend(c10d._world.pg_map)
        pg_abort = dist.ProcessGroup.abort
        dist.ProcessGroup.abort = lambda self: None
        try:
            real_abort(group)
        finally:
            dist.ProcessGroup.abort = pg_abort

    expired = basics._collective_expired

    def collective_expired(ranks, age_s):
        print(f"WATCH_FIRED ranks {json.dumps(list(ranks))} age "
              f"{age_s:.3f}", flush=True)
        expired(ranks, age_s)

    class _Pending:
        def __init__(self, work):
            self.work = work

        def query(self):
            return self.work.is_completed()

    def nccl_like(fn):
        def run(*a, group=None, async_op=False, **k):
            work = fn(*a, group=group, async_op=True, **k)
            if async_op:
                return work
            group_watch.current().add(_Pending(work),
                                      dist.get_process_group_ranks(
                                          group or dist.group.WORLD))
            while not work.is_completed():
                if basics.group_aborted() is not None:
                    _kept_groups.append(work)
                    return None  # the kernel ended: its values are junk
                time.sleep(0.0005)
            work.wait()
            return None
        return run

    dist.init_process_group = init_process_group
    dist.get_backend = lambda group=None: "nccl"
    basics.init = basics_init
    basics._collective_expired = collective_expired
    c10d._abort_process_group = abort_process_group
    dist.all_reduce = nccl_like(dist.all_reduce)
    dist.all_gather = nccl_like(dist.all_gather)


def main():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import fault_injection as fi
    from horovod_tpu_torch.common import wire
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serving import ServingLoop

    if os.environ.get("SERVE_FAKE_NCCL") == "1":
        _fake_nccl()
    cache_len = int(os.environ.get("SERVE_CACHE_LEN", "64"))
    dims = json.loads(os.environ.get("SERVE_MODEL", "null")) or dict(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64)
    mesh = json.loads(os.environ.get("SERVE_MESH", "null"))
    cfg = tfm.TransformerConfig(max_seq_len=cache_len,
                                compute_dtype=torch.float32, remat=False,
                                **dims)
    model = tfm.Transformer(cfg)
    model.load_state_dict(torch.load(os.environ["SERVE_WEIGHTS"]))

    port_file = os.environ.get("SERVE_PORT_FILE", "")
    ready_file = os.environ.get("SERVE_READY_FILE", "")
    shadow_file = os.environ.get("SERVE_SHADOW_FILE", "")
    expect = int(os.environ.get("SERVE_EXPECT", "0"))
    stop_file = os.environ.get("SERVE_STOP_FILE", "")

    def on_ready(port):
        print(f"PORT {port}", flush=True)
        if port_file:
            _write(port_file, str(port))

    class Loop(ServingLoop):
        def _publish_leader(self):
            super()._publish_leader()
            if ready_file:
                _write(ready_file, self._known_leader)

        _tp_seen = None

        def _apply_frame(self, frame, eng, engine, *, rank0):
            if mesh is not None and self._tp_seen != (self.tp, eng.epoch):
                self._tp_seen = (self.tp, eng.epoch)
                print(f"TP {self.tp} epoch {eng.epoch} size {hvd.size()} "
                      f"rank {hvd.rank()}", flush=True)
            done = super()._apply_frame(frame, eng, engine, rank0=rank0)
            if shadow_file and len(self._slots) == self.max_batch and \
                    not os.path.exists(shadow_file):
                _write(shadow_file, "1")
            return done

    loop_cls = Loop
    if os.environ.get("SERVE_VICTIM") == "1":
        stall_seq = int(os.environ.get("SERVE_STALL_SEQ", "3"))
        site = os.environ.get("SERVE_SITE", "sock.stall")

        class VictimLoop(Loop):
            """Arms the transport stall right before one serve frame, so
            that this rank wedges inside that step's allreduce."""

            _armed = False

            def _apply_frame(self, frame, eng, engine, *, rank0):
                seq, stopping, _, _ = wire.decode_serve_delta(frame)
                if not stopping and seq >= stall_seq and \
                        not VictimLoop._armed:
                    VictimLoop._armed = True
                    fi.configure({"faults": [
                        {"site": site, "kind": "stall", "stall_s": 600}]})
                return super()._apply_frame(frame, eng, engine,
                                            rank0=rank0)

        loop_cls = VictimLoop

    loop = loop_cls(
        model, cfg, device="cpu",
        max_batch=int(os.environ.get("SERVE_MAX_BATCH", "2")),
        max_queue=int(os.environ.get("SERVE_MAX_QUEUE", "16")),
        port=0, host="127.0.0.1", cache_len=cache_len, mesh=mesh,
        eos_id=None,
        request_timeout_s=90.0, on_ready=on_ready)

    # The scheduler exists only on the serving leader (rank 0 at start, or
    # a rank promoted by a failover): the stopper runs on every rank and
    # fires where the requests complete.
    if expect or stop_file:
        def stopper():
            while True:
                sch = loop.scheduler
                if sch is not None and (
                        os.path.exists(stop_file) if stop_file
                        else sch.stats()["completed"] >= expect):
                    loop.stop()
                    return
                time.sleep(0.05)

        threading.Thread(target=stopper, daemon=True).start()

    epoch0 = os.environ.get("HVD_ELASTIC_EPOCH", "0")
    print(f"GEN {epoch0}", flush=True)
    loop.run()
    print(f"GEN_FINAL {os.environ.get('HVD_ELASTIC_EPOCH', epoch0)}",
          flush=True)

    def senders():
        return [t for t in threading.enumerate()
                if t.name.startswith("hvd-send-")]

    print("DONE", flush=True)
    hvd.shutdown()
    deadline = time.monotonic() + 10.0
    while senders() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not senders(), \
        f"sender threads leaked past shutdown: {[t.name for t in senders()]}"


if __name__ == "__main__":
    main()
