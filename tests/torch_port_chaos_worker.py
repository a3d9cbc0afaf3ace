"""Chaos-scenario worker for the port's liveness, deadline and control-tree
tests (``tests/test_torch_liveness.py``, ``tests/test_torch_timeouts.py``,
``tests/test_torch_ctrl_tree.py``).

    python tests/torch_port_chaos_worker.py <scenario> <port|jax>

``port`` runs the scenario on ``horovod_tpu_torch`` (``hvd.init(device=
"cpu", backend="none")``), ``jax`` on the JAX package's ``PyEngine`` (the
caller sets ``HVD_TPU_CORE=py``), so that one gang may mix the two.  The
rank, size, topology, rendezvous, knobs and per-rank fault plan
(``HOROVOD_FAULT_PLAN``) come from the environment.  The scenarios
``train_steps`` and ``tree_subcoord_steps`` are ``tests/chaos_worker.py``'s,
with its markers (``STEP <i> <v>``, ``RANKS_FAILED <json> at_step <i>``,
``CTRL_LOST``, ``TREE ...``) and exit codes:

* 0   the scenario completed (the expected ``RanksFailedError`` included)
* 3   a fault that was meant to bite never did
* 17  this rank lost its control connection and aborted
* 137 killed by an injected ``kill`` fault

``stall_steps`` is ``tests/timeout_worker.py``'s gang without the elastic
wrapper: at step 1 the victim (``TIMEOUT_VICTIM=1``) arms a stall of its
next data-plane receive (``TIMEOUT_SITE``: ``sock.stall`` or
``shm.stall``), or with ``TIMEOUT_FAULT=corrupt`` a corruption of every
TCP data frame it sends; the survivors print ``CTE ranks=<json>
tensor=<name> dt=<s>`` (the typed error and its latency from the step's
submission) and ``RETAINED <n> <ok>`` (whether the retained batch holds
their own step-1 inputs bit for bit), then exit 0 at once (the links may
hold the aborted collective's frames).  The victim of a stall never exits
by itself: the caller kills it.

``fence_stale_epoch`` is ``tests/chaos_worker.py``'s: the caller starts the
ranks at different ``HVD_ELASTIC_EPOCH`` values; the stale rank's first
request frame draws ``TAG_FENCE`` and its allreduce raises the typed
``FencedError`` (``FENCED rank=<r> stale=<e> current=<e>``), while the
coordinator prints ``SURVIVED rank=0 sum=<v> fences=<n>`` or
``RANKS_FAILED <json> fences=<n>`` (its recorder's ``epoch.fence``
notes).

``bcast_object_busy`` sends a ``broadcast_object`` that one rank receives
slowly, or wedged, and that every rank takes a while to unpickle (its
docstring has the knobs and markers).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCENARIO, PKG = sys.argv[1], sys.argv[2]
STEPS = 8
STALL_STEPS = 3
VICTIM_STEP = 1
NAMES = ("grad.a", "grad.b", "grad.c")

if PKG == "jax":
    import horovod_tpu as hvd
    from horovod_tpu import basics
    from horovod_tpu.common import fault_injection as fi
    from horovod_tpu.common.types import CollectiveTimeoutError, FencedError
    from horovod_tpu.ops import eager
    from horovod_tpu.telemetry import blackbox as bb
    from horovod_tpu.runtime_py import take_retained_batch

    def engine():
        return basics._runtime

    def init():
        hvd.init()

    submit, wait = eager.allreduce_async, eager.synchronize
else:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.common import fault_injection as fi
    from horovod_tpu_torch.common.types import (CollectiveTimeoutError,
                                                FencedError)
    from horovod_tpu_torch.runtime_py import take_retained_batch
    from horovod_tpu_torch.telemetry import blackbox as bb

    torch.set_num_threads(1)

    def engine():
        return basics._engine_obj

    from horovod_tpu_torch.ops import eager

    def init():
        hvd.init(device="cpu", backend="none")

    submit, wait = hvd.allreduce_async, hvd.synchronize


def grad(rank, step, j, n=8):
    """tests/timeout_worker.py's inputs."""
    return (np.arange(n, dtype=np.float32) * (j + 1)
            + 10.0 * rank + 100.0 * step).astype(np.float32)


def _steps(prefix):
    rank = hvd.rank()
    step = -1
    try:
        for step in range(STEPS):
            out = hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum,
                                name=f"{prefix}.step{step}")
            print(f"STEP {step} {float(np.asarray(out)[0])}", flush=True)
            fi.fire("train.step", str(step))
        print("NO_FAILURE", flush=True)
        os._exit(3)
    except hvd.RanksFailedError as e:
        print(f"RANKS_FAILED {json.dumps(e.ranks)} at_step {step}",
              flush=True)
        return e
    except RuntimeError as e:
        # The rank whose own control path failed: the engine aborts as a
        # lost coordinator and the blocked allreduce raises.
        print(f"CTRL_LOST {rank}: {e}", flush=True)
        os._exit(17)


def scenario_train_steps():
    _steps("chaos")
    os._exit(0)


def scenario_tree_subcoord_steps():
    _steps("tree")
    eng = engine()
    print(f"TREE rank={hvd.rank()} parent={eng._tree_parent} "
          f"orphaned={eng._tree_orphaned} "
          f"reparented={sorted(eng._reparented_ranks)}", flush=True)
    os._exit(0)


def scenario_stall_steps():
    rank = hvd.rank()
    victim = os.environ.get("TIMEOUT_VICTIM") == "1"
    for step in range(STALL_STEPS):
        if victim and step == VICTIM_STEP:
            if os.environ.get("TIMEOUT_FAULT") == "corrupt":
                fault = {"site": "sock.corrupt", "kind": "corrupt"}
            else:
                fault = {"site": os.environ.get("TIMEOUT_SITE",
                                                "sock.stall"),
                         "kind": "stall", "stall_s": 600}
            fi.configure({"faults": [fault]})
        inputs = [grad(rank, step, j) for j in range(len(NAMES))]
        t0 = time.monotonic()
        try:
            handles = [submit(x, op=hvd.Sum, name=f"{nm}.s{step}")
                       for x, nm in zip(inputs, NAMES)]
            outs = [np.asarray(wait(h)) for h in handles]
        except CollectiveTimeoutError as e:
            dt = time.monotonic() - t0
            print(f"CTE ranks={json.dumps(e.ranks)} "
                  f"tensor={e.tensor_name} dt={dt:.3f}", flush=True)
            batch = take_retained_batch() or []
            mine = {f"{nm}.s{step}": x for x, nm in zip(inputs, NAMES)}
            ok = bool(batch) and all(
                item["name"] in mine and np.asarray(item["array"]).tobytes()
                == mine[item["name"]].tobytes() for item in batch)
            print(f"RETAINED {len(batch)} {ok}", flush=True)
            # The links may still hold the aborted collective's frames
            # (elastic would re-form the gang): stop here, after closing
            # rank 0's timeline.
            engine().timeline.shutdown()
            os._exit(0)
        print(f"STEP {step} {float(outs[0][0])}", flush=True)
    print("NO_FAILURE", flush=True)
    os._exit(3)


def scenario_fence_stale_epoch():
    def fences():
        snap = bb.get().snapshot() if bb.active() else {}
        return sum(1 for ev in snap.get("events", [])
                   if ev.get("kind") == "epoch.fence")

    rank = hvd.rank()
    try:
        out = hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum,
                            name="fence.step")
        # Only the coordinator gets here: it fenced the stale frame,
        # evicted the zombie on heartbeat silence and completed the step
        # alone.  No epoch.fence note means the fence never fired (3).
        n = fences()
        print(f"SURVIVED rank={rank} sum={float(np.asarray(out)[0])} "
              f"fences={n}", flush=True)
        os._exit(0 if n else 3)
    except FencedError as e:
        print(f"FENCED rank={rank} stale={e.stale_epoch} "
              f"current={e.current_epoch}", flush=True)
        os._exit(0)
    except hvd.RanksFailedError as e:
        print(f"RANKS_FAILED {json.dumps(e.ranks)} fences={fences()}",
              flush=True)
        os._exit(0)


def _slow_unpickle(seconds, value):
    """What a ``_SlowUnpickle`` turns into: ``value``, after ``seconds``
    of Python work on the main thread."""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass
    return value


class _SlowUnpickle:
    def __init__(self, seconds, value):
        self.seconds, self.value = seconds, value

    def __reduce__(self):
        return _slow_unpickle, (self.seconds, self.value)


def _throttle_large_receives(piece, pause_s):
    """Read every receive of 1 MiB or more in ``piece``-byte slices with
    ``pause_s`` between them: a receiver slower than its root's send,
    whose bytes keep arriving."""
    from horovod_tpu_torch.utils import socketutil as su

    plain = su.recv_exact_into

    def slow(sock, view, *args, **kw):
        if len(view) < (1 << 20):
            return plain(sock, view, *args, **kw)
        for i in range(0, len(view), piece):
            plain(sock, view[i:i + piece], *args, **kw)
            time.sleep(pause_s)

    su.recv_exact_into = slow


def scenario_bcast_object_busy():
    """``broadcast_object`` from rank 0 of a payload (``BUSY_MB`` MiB of
    uint8) and an object whose unpickle takes ``BUSY_UNPICKLE_S`` on every
    rank.  ``BUSY_RANK`` receives slowly (``BUSY_MODE=slow``: 64 KiB
    slices, 50 ms apart) or wedges its receive of the payload's frame for
    ``BUSY_STALL_S`` (``BUSY_MODE=wedge``).  Then three allreduces.
    Prints ``BUSY_OK rank=<r> digest=<hex>`` or ``RANKS_FAILED <json>
    dt=<s>`` (seconds from the broadcast's start)."""
    import hashlib

    rank = hvd.rank()
    busy = int(os.environ["BUSY_RANK"])
    mode = os.environ["BUSY_MODE"]
    n = int(float(os.environ["BUSY_MB"]) * (1 << 20))
    hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum, name="busy.warm")
    obj = None
    if rank == 0:
        obj = {"payload": (np.arange(n) % 251).astype(np.uint8),
               "slow": _SlowUnpickle(float(os.environ["BUSY_UNPICKLE_S"]),
                                     "unpickled")}
    if rank == busy:
        if mode == "slow":
            _throttle_large_receives(64 << 10, 0.05)
        else:
            # The length's frame passes; the payload's wedges.
            fi.configure({"faults": [{
                "site": "sock.stall", "kind": "stall", "after": 1, "times": 1,
                "stall_s": float(os.environ["BUSY_STALL_S"])}]})
    t0 = time.monotonic()
    try:
        got = eager.broadcast_object(obj, 0, name="busy.obj")
        for k in range(3):
            hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum,
                          name=f"busy.after{k}")
    except hvd.RanksFailedError as e:
        print(f"RANKS_FAILED {json.dumps(e.ranks)} "
              f"dt={time.monotonic() - t0:.3f}", flush=True)
        os._exit(0)
    assert got["slow"] == "unpickled", got
    digest = hashlib.sha256(got["payload"].tobytes()).hexdigest()[:16]
    print(f"BUSY_OK rank={rank} digest={digest}", flush=True)
    os._exit(0)


SCENARIOS = {
    "bcast_object_busy": scenario_bcast_object_busy,
    "fence_stale_epoch": scenario_fence_stale_epoch,
    "train_steps": scenario_train_steps,
    "tree_subcoord_steps": scenario_tree_subcoord_steps,
    "stall_steps": scenario_stall_steps,
}


def main():
    init()
    try:
        SCENARIOS[SCENARIO]()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
