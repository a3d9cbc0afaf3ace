"""The port's MXNet front-end (``horovod_tpu_torch.mxnet``) against the JAX
package's (``horovod_tpu.mxnet``), under ``tests/test_mxnet_binding.py``'s
stand-in NDArray (``tests/torch_port_mxnet_worker.py``).

Three gangs of two run once for the module, at once, on the Python
engine: a port gang, a JAX gang and a mixed gang (rank 0 the JAX
binding, rank 1 the port's).  Held: the optimizer's rescaled updates, the
trainer's allreduced gradients, ``broadcast_parameters`` (a deferred
parameter included) and the ops give the JAX gang's bits in the port and
mixed gangs; and without ``mxnet`` the port's surface raises the JAX
module's ``ImportError``.
"""

import os
import pickle
import subprocess
import sys
import time

import pytest

from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_mxnet_worker.py")
GANGS = {"port2": ["port", "port"], "jax2": ["jax", "jax"],
         "mixed2": ["jax", "port"]}
GANG_TIMEOUT = 120.0


def _run(root):
    started = {}
    for name, pkgs in GANGS.items():
        out_dir = str(root / name)
        os.makedirs(out_dir)
        server = RendezvousServer("127.0.0.1")
        port = server.start()
        env0 = {k: v for k, v in os.environ.items()
                if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
        env0["PYTHONPATH"] = REPO + os.pathsep + env0.get("PYTHONPATH", "")
        procs = [subprocess.Popen(
            [sys.executable, WORKER, pkg, out_dir],
            env=dict(env0, HVD_RANK=str(r), HVD_SIZE="2",
                     HVD_LOCAL_RANK=str(r), HVD_LOCAL_SIZE="2",
                     HVD_RENDEZVOUS_ADDR="127.0.0.1",
                     HVD_RENDEZVOUS_PORT=str(port), HVD_TPU_CORE="py",
                     HVD_SHM_DISABLE="1", JAX_PLATFORMS="cpu",
                     HVD_BLACKBOX_DIR=os.path.join(out_dir, "blackbox")),
            cwd=out_dir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r, pkg in enumerate(pkgs)]
        started[name] = (server, procs, out_dir)
    deadline = time.monotonic() + GANG_TIMEOUT
    done = {}
    for name, (server, procs, out_dir) in started.items():
        runs = []
        try:
            for p in procs:
                try:
                    out, _ = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + b"\n(killed: timed out)"
                runs.append((p.returncode, out.decode(errors="replace")))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            server.stop()
        recs = []
        for r in range(len(procs)):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            recs.append(pickle.load(open(path, "rb"))
                        if os.path.exists(path) else {})
        done[name] = (runs, recs)
    return done


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mxnet_gangs"))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", ["port2", "mixed2"])
def test_mxnet_binding_bits_equal_jax_gang(gangs, name):
    for gang in ("jax2", name):
        for rank, (code, text) in enumerate(gangs[gang][0]):
            assert code == 0 and "MXNET_OK" in text, (gang, rank, text)
    for rank in range(2):
        got, want = gangs[name][1][rank], gangs["jax2"][1][rank]
        assert want and sorted(got) == sorted(want), rank
        for key in want:
            assert got[key] == want[key], (name, rank, key)


def test_gate_without_mxnet():
    """Without ``mxnet`` the surface stays importable and each gated
    entry raises the JAX module's ``ImportError``."""
    import horovod_tpu_torch.mxnet as m

    if m._HAVE_MXNET:
        pytest.skip("real mxnet present")
    for fn, arg in ((m.DistributedOptimizer, object()),
                    (m.broadcast_parameters, {}),
                    (m.DistributedTrainer, [])):
        with pytest.raises(ImportError,
                           match="horovod_tpu_torch.mxnet.* requires the "
                                 "`mxnet` package"):
            fn(arg) if fn is not m.DistributedTrainer else fn(arg, "sgd")
