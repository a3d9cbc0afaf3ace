"""The port's elastic worker, for ``tests/test_torch_elastic.py`` and
``tests/test_torch_elastic_mixed.py``.

    python tests/torch_port_elastic_worker.py <train|stall>

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

Both check the sender threads as ``tests/elastic_worker.py`` does: at most
size-1 ``hvd-send-*`` threads after the last re-form, none after
``shutdown``.  Exit codes: 0 done, 137 killed by an injected fault.
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


if __name__ == "__main__":
    if os.environ.get("ELASTIC_METRICS") == "1":
        from horovod_tpu_torch.telemetry import registry

        registry.configure(True)
    {"train": scenario_train, "stall": scenario_stall}[sys.argv[1]]()
