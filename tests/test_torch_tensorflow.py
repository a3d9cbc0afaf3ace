"""The port's TensorFlow front-end (``import horovod_tpu_torch.tensorflow as
hvd``) and its custom kernels against the JAX package's, in gangs
(``tests/torch_port_tf_worker.py``).

Three gangs of two run once for the module, at once, each against its
own ``RendezvousServer``, on the native core (the default of both
packages): a port gang that runs ``tests/tf_worker.py``'s scenarios (the
op surface with process sets, graph mode, the tape, the single-thread
optimizer, Keras ``fit``, the Adasum delta optimizer against its numpy
oracle at two ranks, the native kernels, ``backward_passes_per_step``)
and the op matrix (``bits``), a JAX gang and a mixed gang (rank 0 the
JAX front-end, rank 1 the port's) that run the op matrix.  The matrix is
every op over every dtype of the engine, compression, the gradients and
``broadcast_object``, on inputs made from a seed, once through the native
kernels and once through ``tf.py_function``.

Held: the port gang's and the mixed gang's results are the JAX gang's,
bit for bit; the port's native kernels are engaged (``_native_ops.lib()``
is not ``None``) and give the ``py_function`` path's bits.
"""

import os
import pickle
import subprocess
import sys
import time

import pytest

from horovod_tpu_torch.runner.http_server import RendezvousServer

tf = pytest.importorskip("tensorflow")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_tf_worker.py")

SCENARIOS = ["single_thread_optimizer", "ops", "graph_mode", "tape",
             "keras_fit", "adasum_optimizer", "native_ops",
             "backward_passes"]
GANGS = {"port2": (["port", "port"], SCENARIOS + ["bits"]),
         "jax2": (["jax", "jax"], ["bits"]),
         "mixed2": (["jax", "port"], ["bits"])}
GANG_TIMEOUT = 420.0


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
                   HVD_RENDEZVOUS_PORT=str(port), HVD_SHM_DISABLE="1",
                   HVD_BLACKBOX_DIR=os.path.join(out_dir, "blackbox"),
                   JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="2",
                   **(extra_env or {}))
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
    return run_gangs(tmp_path_factory.mktemp("tf_gangs"), GANGS,
                     GANG_TIMEOUT)


def ran(gang, case):
    for rank, (code, text) in enumerate(gang[0]):
        assert f"SCENARIO_OK {case}" in text, \
            f"rank {rank} (exit {code}):\n{text[-4000:]}"


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", SCENARIOS)
def test_port_gang_runs_the_jax_scenario(gangs, case):
    """Each of ``tests/tf_worker.py``'s scenarios passes on a port gang."""
    ran(gangs["port2"], case)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["port2", "mixed2"])
def test_op_matrix_bits_equal_jax_gang(gangs, name):
    """Every op and dtype of the matrix, through the native kernels and
    through ``py_function``, gives the JAX gang's bits."""
    ran(gangs["jax2"], "bits")
    ran(gangs[name], "bits")
    for rank in range(2):
        got = gangs[name][1][rank]["bits"]
        want = gangs["jax2"][1][rank]["bits"]
        assert sorted(got) == sorted(want), rank
        for key in want:
            assert got[key] == want[key], (name, rank, key)


@pytest.mark.timeout(600)
def test_native_kernels_engaged_and_equal_py_function(gangs):
    """The port's ``tf_ops.cc`` builds here and serves the port gang, and
    its results are the ``py_function`` path's, bit for bit."""
    ran(gangs["port2"], "bits")
    for rank in range(2):
        bits = gangs["port2"][1][rank]["bits"]
        assert bits["native"][2] == b"\x01", rank
        on = {k[3:]: v for k, v in bits.items() if k.startswith("on.")}
        off = {k[4:]: v for k, v in bits.items() if k.startswith("off.")}
        assert on and sorted(on) == sorted(off)
        for key in on:
            assert on[key] == off[key], (rank, key)
