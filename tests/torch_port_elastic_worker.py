"""The port's elastic worker, for ``tests/test_torch_elastic.py`` and
``tests/test_torch_elastic_mixed.py``.

    python tests/torch_port_elastic_worker.py <train|stall|group|group_abort>

``train`` is ``tests/elastic_worker.py`` on ``horovod_tpu_torch``: one gang
member running a training loop under ``@hvd.elastic.run(device="cpu")``
(the wrapper initializes the engine, with no process group), with that
worker's knobs (``ELASTIC_TOTAL_STEPS``, ``_COMMIT_EVERY``,
``_STEP_SLEEP``, ``_STOP_AT_SIZE``, ``_STEPS_AFTER_GROW``,
``_CACHE_PROBE``) and markers, so that a gang may mix the two workers:

* ``STEP <i> <sum>``: the allreduce of step ``i``;
* ``RESET size <n>``: a reset callback ran after a re-form;
* ``CACHE <json>``: the response cache's view after the probe;
* ``FINAL_W <v>`` / ``FINAL_EPOCH <e>`` / ``DONE``: the loop's end.

A late joiner is the same script with ``HVD_ELASTIC_JOINER=1``.  With
``ELASTIC_METRICS=1`` the registry counts, and the worker prints
``COUNTERS <json>`` (the elastic series) before ``DONE``.

``stall`` is ``tests/timeout_worker.py``'s gang under the wrapper: three
tensors a step, the victim (``TIMEOUT_VICTIM=1``) stalls its next
data-plane receive at step 1 (``TIMEOUT_SITE``), and the survivors print
``CTE ranks=<json> tensor=<name> dt=<s>``, re-form, print ``REPLAY
<name> <hex>`` for each replayed tensor and finish the steps.

``group`` (``tests/test_torch_elastic_group.py``): each rank forms a gloo
process group (``init_torch_distributed`` then ``hvd.init(device="cpu")``;
a joiner only at its grant) and every step allreduces one exactly
representable tensor over a fresh mesh's ``dp`` axis and through the
engine, printing ``STEP <i> e<epoch> size <n> rank <r> same <bool> <sum>``;
each incarnation prints ``GROUP epoch <e> ... store <addr>`` and, after
the first, whether the last incarnation's axis raised ``StaleMeshError``;
the reset callback prints the wrapper's group verdict.  It ends after
three steps at epoch 3.

``group_abort`` (``tests/test_torch_elastic_group.py``): the eager
engine's eviction aborting an NCCL group (``basics.abort_process_groups``);
see its docstring.

Every scenario checks the sender threads as ``tests/elastic_worker.py``
does: at most size-1 ``hvd-send-*`` threads after the last re-form, none
after ``shutdown``.  Exit codes: 0 done, 137 killed by an injected fault.
"""

import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import basics  # noqa: E402
from horovod_tpu_torch.common import fault_injection as fi  # noqa: E402

torch.set_num_threads(1)

ELASTIC_SERIES = ("hvd_elastic_reforms_total", "hvd_leader_failovers_total",
                  "hvd_fenced_writes_total")


def senders():
    return [t for t in threading.enumerate()
            if t.name.startswith("hvd-send-")]


def finish(state_w=None):
    assert len(senders()) <= hvd.size() - 1, \
        f"sender pool leaked across re-forms: {[t.name for t in senders()]}"
    if state_w is not None:
        print(f"FINAL_W {float(state_w[0])}", flush=True)
    print(f"FINAL_EPOCH {os.environ.get('HVD_ELASTIC_EPOCH', '0')}",
          flush=True)
    if os.environ.get("ELASTIC_METRICS") == "1":
        counters = hvd.metrics_snapshot().get("counters", {})
        print("COUNTERS " + json.dumps(
            {k: counters.get(k, 0) for k in ELASTIC_SERIES}), flush=True)
    print("DONE", flush=True)
    hvd.shutdown()
    deadline = time.monotonic() + 10.0
    while senders() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not senders(), \
        f"sender threads survived shutdown: {[t.name for t in senders()]}"


def scenario_train():
    total = int(os.environ.get("ELASTIC_TOTAL_STEPS", "8"))
    commit_every = int(os.environ.get("ELASTIC_COMMIT_EVERY", "1"))
    step_sleep = float(os.environ.get("ELASTIC_STEP_SLEEP", "0"))
    stop_size = int(os.environ.get("ELASTIC_STOP_AT_SIZE", "0"))
    after_grow = int(os.environ.get("ELASTIC_STEPS_AFTER_GROW", "3"))

    state = hvd.elastic.ObjectState(w=np.zeros(4, np.float32),
                                    step=0, grown_at=-1)
    state.register_reset_callbacks(
        [lambda: print(f"RESET size {hvd.size()}", flush=True)])

    @hvd.elastic.run(device="cpu")
    def train(state):
        while state.step < total:
            out = hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum,
                                name=f"elastic.step{state.step}")
            print(f"STEP {state.step} {float(out[0])}", flush=True)
            state.w = state.w + out
            fi.fire("train.step", str(state.step))
            state.step += 1
            if state.step % commit_every == 0:
                state.commit()
            # Every rank computes the same cut (the size and the synced
            # state agree), so the break is collective-safe.
            if stop_size and hvd.size() >= stop_size:
                if state.grown_at < 0:
                    state.grown_at = state.step
                if state.step - state.grown_at >= after_grow:
                    break
            if step_sleep:
                time.sleep(step_sleep)

    train(state)
    if os.environ.get("ELASTIC_CACHE_PROBE") == "1":
        # The same names twice: the second pass runs through the cache-hit
        # protocol of the re-formed engine; every member must print the
        # same positions.
        names = [f"cache.warm{i}" for i in range(4)]
        for _ in range(2):
            for n in names:
                out = hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum,
                                    name=n)
                assert float(out[0]) == hvd.size(), (n, out)
        cache = basics._engine_obj._cache
        view = {"positions": sorted(
                    [n, cache.position_of(n)] for n in names),
                "len": len(cache),
                "hits": cache.stats()["hits"]}
        print(f"CACHE {json.dumps(view)}", flush=True)
    finish(state.w)


STALL_STEPS = 4
VICTIM_STEP = 1
NAMES = ("grad.a", "grad.b", "grad.c")


def grad(rank, step, j, n=8):
    """tests/timeout_worker.py's inputs."""
    return (np.arange(n, dtype=np.float32) * (j + 1)
            + 10.0 * rank + 100.0 * step).astype(np.float32)


def scenario_stall():
    victim = os.environ.get("TIMEOUT_VICTIM") == "1"
    hvd.init(device="cpu", backend="none")
    state = hvd.elastic.ObjectState(step=0)

    @hvd.elastic.run
    def train(state):
        replayed = hvd.elastic.last_replay_results()
        if replayed:
            for nm in sorted(replayed):
                print(f"REPLAY {nm} "
                      f"{np.asarray(replayed[nm]).tobytes().hex()}",
                      flush=True)
        while state.step < STALL_STEPS:
            rank = hvd.rank()
            if victim and state.step == VICTIM_STEP:
                fi.configure({"faults": [
                    {"site": os.environ.get("TIMEOUT_SITE", "sock.stall"),
                     "kind": "stall", "stall_s": 600}]})
            t0 = time.monotonic()
            try:
                handles = [hvd.allreduce_async(
                    grad(rank, state.step, j), op=hvd.Sum,
                    name=f"{nm}.s{state.step}")
                    for j, nm in enumerate(NAMES)]
                outs = [np.asarray(hvd.synchronize(h)) for h in handles]
            except hvd.CollectiveTimeoutError as e:
                dt = time.monotonic() - t0
                print(f"CTE ranks={json.dumps(e.ranks)} "
                      f"tensor={e.tensor_name} dt={dt:.3f}", flush=True)
                raise  # the wrapper evicts and replays
            print(f"STEP {state.step} {float(outs[0][0])}", flush=True)
            state.step += 1
            state.commit()

    train(state)
    finish()


GROUP_MAX_STEPS = 400
GROUP_LAST_EPOCH = 3
GROUP_STEPS_AT_LAST = 3


def scenario_group():
    """A gang whose ranks each form a gloo process group, re-formed by the
    wrapper at every epoch (a joiner takes its backend from the grant)."""
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel import mesh as M
    from horovod_tpu_torch.parallel import multihost

    joiner = os.environ.get("HVD_ELASTIC_JOINER") == "1"
    if not joiner:
        multihost.init_torch_distributed()
        hvd.init(device="cpu")
    step_sleep = float(os.environ.get("ELASTIC_STEP_SLEEP", "0.05"))
    state = hvd.elastic.ObjectState(step=0, last_steps=0)
    old = {}

    def on_reset():
        err = hvd.elastic.last_group_error()
        print(f"RESET size {hvd.size()} epoch "
              f"{os.environ['HVD_ELASTIC_EPOCH']} t {time.monotonic():.3f} "
              f"verdict {type(err).__name__ if err else None} "
              f"{json.dumps(err.ranks) if err else '[]'}", flush=True)

    state.register_reset_callbacks([on_reset])

    @hvd.elastic.run(device="cpu")
    def train(state):
        epoch = int(os.environ["HVD_ELASTIC_EPOCH"])
        if "axis" in old:
            # The last incarnation's mesh is bound to a destroyed group.
            try:
                C.allreduce(torch.ones(2), axis=old["axis"])
                print("STALE none", flush=True)
            except M.StaleMeshError:
                print("STALE StaleMeshError", flush=True)
        mesh = M.make_mesh()
        old["axis"] = mesh.axis("dp")
        print(f"GROUP epoch {epoch} rank {hvd.rank()} size {hvd.size()} "
              f"backend {torch.distributed.get_backend()} store "
              f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
              flush=True)
        while state.step < GROUP_MAX_STEPS:
            if epoch >= GROUP_LAST_EPOCH and \
                    state.last_steps >= GROUP_STEPS_AT_LAST:
                break
            rank = hvd.rank()
            # Exactly representable in fp32: every order of the sum
            # gives the same bits.
            x = (torch.arange(8, dtype=torch.float32) * (rank + 1)
                 + 0.25 * state.step)
            fi.fire("train.step", f"e{epoch}.s{state.step}.")
            t0 = time.monotonic()
            try:
                g = C.allreduce(x, op=hvd.Sum, axis=old["axis"])
            except RuntimeError as e:
                print(f"GROUP_ERR e{epoch}.s{state.step} t {t0:.3f} "
                      f"{str(e)[:80]!r}", flush=True)
                raise
            e = torch.as_tensor(np.asarray(hvd.allreduce(
                x.numpy(), op=hvd.Sum, name=f"group.s{state.step}")))
            same = g.numpy().tobytes() == e.numpy().tobytes()
            print(f"STEP {state.step} e{epoch} size {hvd.size()} rank "
                  f"{rank} same {same} {float(g.sum())}", flush=True)
            state.step += 1
            if epoch >= GROUP_LAST_EPOCH:
                state.last_steps += 1
            state.commit()
            time.sleep(step_sleep)

    train(state)
    finish()


ABORT_KILL_STEP = 2
ABORT_STEPS_AFTER = 2


def scenario_group_abort():
    """A gang of four on a dp 2 x tp 2 mesh whose rank 3 dies before its
    group collective of step ``ABORT_KILL_STEP`` (an injected ``kill``).
    Under ``GROUP_FAKE_NCCL=1`` each rank asks ``hvd.init`` for an NCCL
    group, which a stand-in ``init_process_group`` forms over gloo, and
    the survivors model an NCCL collective with a dead peer: at the kill
    step they wait, before the group collective, until the groups'
    abort frees them.  ``_abort_process_group`` is wrapped to print
    ``ABORT thread <name> reason <json> groups <json>`` (the thread that
    called it, ``abort_process_groups``' reason, and the ranks of every
    group it aborts) before it runs.  Each step prints ``STEP``; the
    survivors' failed collective ``GROUP_ERR <type>``; the reset callback
    ``RESET size <n> epoch <e>``."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel import mesh as M
    from horovod_tpu_torch.parallel import multihost

    fake = os.environ.get("GROUP_FAKE_NCCL") == "1"
    aborted = threading.Event()
    reasons = []
    real_abort = c10d._abort_process_group
    real_reason = basics.abort_process_groups

    def abort_process_groups(reason):
        reasons.append(reason)
        return real_reason(reason)

    def record_abort(group=None):
        groups = sorted(sorted(m) for m in c10d._world.pg_group_ranks.values())
        print(f"ABORT thread {threading.current_thread().name} reason "
              f"{json.dumps(reasons[-1:])} groups {json.dumps(groups)}",
              flush=True)
        real_abort(group)
        aborted.set()

    c10d._abort_process_group = record_abort
    basics.abort_process_groups = abort_process_groups
    if fake:
        real_init = dist.init_process_group

        def init_process_group(backend, *a, **k):
            return real_init("gloo" if backend == "nccl" else backend,
                             *a, **k)

        dist.init_process_group = init_process_group
        dist.get_backend = lambda group=None: "nccl"
    multihost.init_torch_distributed()
    hvd.init(device="cpu", backend="nccl" if fake else None)
    state = hvd.elastic.ObjectState(step=0, after=0)
    state.register_reset_callbacks([lambda: print(
        f"RESET size {hvd.size()} epoch {os.environ['HVD_ELASTIC_EPOCH']}",
        flush=True)])

    @hvd.elastic.run(device="cpu")
    def train(state):
        epoch = int(os.environ["HVD_ELASTIC_EPOCH"])
        if hvd.size() == 4:
            mesh = M.make_mesh({"dp": 2, "tp": 2})
            axes = [mesh.axis("tp"), mesh.axis("dp")]
        else:
            axes = [M.make_mesh().axis("dp")]
        print(f"MESH epoch {epoch} rank {hvd.rank()} backend "
              f"{basics._world.backend} axes "
              f"{json.dumps([list(a.ranks) for a in axes])}", flush=True)
        while state.after < ABORT_STEPS_AFTER:
            x = (torch.arange(8, dtype=torch.float32) * (hvd.rank() + 1)
                 + 0.25 * state.step)
            fi.fire("train.step", f"e{epoch}.s{state.step}.")
            if fake and epoch == 0 and state.step == ABORT_KILL_STEP:
                freed = aborted.wait(60.0)
                print(f"PENDING freed {freed}", flush=True)
            try:
                for ax in axes:
                    x = C.allreduce(x, op=hvd.Sum, axis=ax)
            except RuntimeError as e:
                print(f"GROUP_ERR {type(e).__name__}", flush=True)
                raise
            print(f"STEP {state.step} e{epoch} size {hvd.size()} "
                  f"{float(x.sum())}", flush=True)
            state.step += 1
            if epoch > 0:
                state.after += 1
            state.commit()

    train(state)
    print(f"REASONS {json.dumps(reasons)}", flush=True)
    finish()


if __name__ == "__main__":
    if os.environ.get("ELASTIC_METRICS") == "1":
        from horovod_tpu_torch.telemetry import registry

        registry.configure(True)
    {"train": scenario_train, "stall": scenario_stall,
     "group": scenario_group,
     "group_abort": scenario_group_abort}[sys.argv[1]]()
