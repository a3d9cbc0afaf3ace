"""The classic torch front-end (``import horovod_tpu_torch.torch as hvd``)
against the JAX package's (``import horovod_tpu.torch as hvd``), bit for
bit, in gangs (``tests/torch_port_frontend_worker.py``).

Three gangs of two run once for the module, at once, each against its
own ``RendezvousServer``: a port gang, a JAX gang (``HVD_TPU_CORE=py``)
and a mixed gang (rank 0 the JAX front-end, rank 1 the port's) that runs
the optimizer's case.  Every gang pins ``HVD_SHM_DISABLE=1`` and sets
``HVD_BLACKBOX_DIR`` in its own directory.  The cases, each on inputs
made from a seed with numpy and a small MLP:

* ``ops``: allreduce with every op in fp32, fp64, fp16, int32 and int64,
  pre- and postscale, the in-place and async forms (the result is the
  caller's tensor), grouped allreduce, ragged allgather, reducescatter at
  uneven rows, broadcast from every root and in place, alltoall with and
  without splits, fp16 compression, auto names, ``broadcast_object``;
* ``grads``: the autograd gradients of allreduce (Sum and Average),
  allgather (equal and ragged) and broadcast from every root;
* ``optimizer``: the hook-driven ``DistributedOptimizer`` over SGD with
  momentum, with ``backward_passes_per_step=2`` (a third pass refused),
  the ``zero_grad`` guard, the ``skip_synchronize`` warning, and a
  parameter with no gradient;
* ``process_set``: the optimizer over a process set, a one-rank set;
* ``join``: ranks out of data at different steps;
* ``broadcast_state``: ``broadcast_optimizer_state`` for SGD with momentum
  (the root's state made by a zero-gradient step) and for Adam from
  unequal starts, LBFGS refused;
* ``adasum``: the Adasum allreduce and the delta optimizer's golden
  values, also against the float64 oracle.

Results are the same bits: both front-ends ride the same engine and ring.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_frontend_worker.py")

CASES = ["ops", "grads", "optimizer", "process_set", "join",
         "broadcast_state", "adasum"]
GANGS = {"port2": (["port", "port"], CASES),
         "jax2": (["jax", "jax"], CASES),
         "mixed2": (["jax", "port"], ["optimizer"])}
GANG_TIMEOUT = 180.0


def start_gang(pkgs, cases, out_dir, extra_env=None):
    """One gang against its own rendezvous server; returns (server,
    processes)."""
    os.makedirs(out_dir, exist_ok=True)
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env0["PYTHONPATH"] = REPO + os.pathsep + env0.get("PYTHONPATH", "")
    procs = []
    for rank, pkg in enumerate(pkgs):
        env = dict(env0, HVD_RANK=str(rank), HVD_SIZE=str(len(pkgs)),
                   HVD_LOCAL_RANK=str(rank), HVD_LOCAL_SIZE=str(len(pkgs)),
                   HVD_CROSS_RANK="0", HVD_CROSS_SIZE="1",
                   HVD_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_RENDEZVOUS_PORT=str(port), HVD_TPU_CORE="py",
                   HVD_SHM_DISABLE="1",
                   HVD_BLACKBOX_DIR=os.path.join(out_dir, "blackbox"),
                   JAX_PLATFORMS="cpu", **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, pkg, ",".join(cases), out_dir],
            env=env, cwd=out_dir, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    return server, procs


def finish_gang(server, procs, out_dir, deadline):
    """Wait for a gang (killing it past ``deadline``); returns each rank's
    (exit code, output) and recorded results."""
    runs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += b"\n(killed: the gang outlived its time limit)"
            runs.append((p.returncode, out.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    results = []
    for r in range(len(procs)):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        results.append(pickle.load(open(path, "rb"))
                       if os.path.exists(path) else {})
    return runs, results


def run_gangs(root, gangs, timeout):
    started = {name: (start_gang(pkgs, cases, str(root / name)),
                      str(root / name))
               for name, (pkgs, cases) in gangs.items()}
    deadline = time.monotonic() + timeout
    return {name: finish_gang(*gang, d, deadline)
            for name, (gang, d) in started.items()}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return run_gangs(tmp_path_factory.mktemp("frontend_gangs"), GANGS,
                     GANG_TIMEOUT)


def ran(gang, case):
    for rank, (code, text) in enumerate(gang[0]):
        assert f"SCENARIO_OK {case}" in text, \
            f"rank {rank} (exit {code}):\n{text[-4000:]}"


def same_bits(got, want, case):
    for rank, (g, w) in enumerate(zip(got[1], want[1])):
        g, w = g.get(case), w.get(case)
        assert w, f"the JAX gang recorded nothing for {case} on rank {rank}"
        assert g is not None and sorted(g) == sorted(w), (rank, case)
        for key in w:
            assert g[key][:2] == w[key][:2], (rank, case, key, g[key][:2],
                                               w[key][:2])
            assert g[key][2] == w[key][2], \
                f"rank {rank}, {case} {key}: the bits differ"


def value(gang, rank, case, key):
    dt, shape, raw = gang[1][rank][case][key]
    return np.frombuffer(raw, dtype=dt.split(".")[1]).reshape(shape)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", CASES)
def test_port_front_end_matches_jax_front_end(gangs, case):
    ran(gangs["jax2"], case)
    ran(gangs["port2"], case)
    same_bits(gangs["port2"], gangs["jax2"], case)


@pytest.mark.timeout(300)
def test_mixed_gang_optimizer_step_matches_jax_gang(gangs):
    ran(gangs["jax2"], "optimizer")
    ran(gangs["mixed2"], "optimizer")
    same_bits(gangs["mixed2"], gangs["jax2"], "optimizer")


@pytest.mark.timeout(300)
def test_guards_and_in_place_results(gangs):
    """The flags the cases record: in-place results are the caller's
    tensors, the optimizer's guards fire, the ranks agree."""
    port = gangs["port2"]
    ran(port, "optimizer")
    for rank in range(2):
        for key in ("accumulate.third_pass_refused", "zero_grad_refused",
                    "step_after_synchronize_warns",
                    "skip_synchronize_quiet"):
            assert value(port, rank, "optimizer", key).item(), (rank, key)
        for dt in ("float32", "float64", "float16", "int32", "int64"):
            for form in ("allreduce_", "allreduce_async_", "broadcast_"):
                assert value(port, rank, "ops",
                             f"{form}.is_input.{dt}").item()
        assert value(port, rank, "broadcast_state", "lbfgs_refused").item()
        assert value(port, rank, "adasum", "accumulate_refused").item()
        assert value(port, rank, "join", "join.last").item() == 1
    res = port[1]
    for key in res[0]["optimizer"]:
        if key.startswith(("sgd.", "accumulate.layers", "zero_grad.",
                           "missing_grad.")):
            assert res[0]["optimizer"][key] == res[1]["optimizer"][key], key
    for key in res[0]["broadcast_state"]:
        assert res[0]["broadcast_state"][key] == \
            res[1]["broadcast_state"][key], key


@pytest.mark.timeout(300)
def test_adasum_against_the_float64_oracle(gangs):
    from horovod_tpu.ops.adasum import adasum_reduce_numpy

    port = gangs["port2"]
    ran(port, "adasum")
    sys.path.insert(0, HERE)
    from torch_port_frontend_worker import tensor

    xs = [tensor(("ad", r), (53,)).numpy().astype(np.float64)
          for r in range(2)]
    want = adasum_reduce_numpy(xs)
    for rank in range(2):
        np.testing.assert_allclose(
            value(port, rank, "adasum", "allreduce"), want, rtol=1e-5,
            atol=1e-6)
    # The delta optimizer: every rank starts at rank 0's weights, and a
    # step moves them by the Adasum of the ranks' SGD deltas -lr * g.
    start = tensor(("adw", 0), (1, 13)).numpy().astype(np.float64)
    for s in range(2):
        deltas = [-0.1 * tensor(("adg", r, s), (1, 13)).numpy()
                  .astype(np.float64).ravel() for r in range(2)]
        start = start + adasum_reduce_numpy(deltas).reshape(start.shape)
        for rank in range(2):
            np.testing.assert_allclose(
                value(port, rank, "adasum", f"step{s}"), start,
                rtol=1e-5, atol=1e-6)
