"""The port's training-loop helpers (``horovod_tpu_torch.callbacks``)
against the JAX package's (``horovod_tpu.callbacks``).

* ``warmup_schedule`` and ``schedule_with_multipliers``: the port's plain
  functions of the step give the JAX optax schedules' learning rate, bit
  for bit in float32, at every step 0..N, for an ``int`` step and for a
  tensor step, and drive a ``torch.optim.lr_scheduler.LambdaLR``;
* ``metric_average`` at one rank, and in a mixed gang of two (rank 0 the
  JAX package's, rank 1 the port's) where both ranks get the same
  average.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.callbacks import schedule_with_multipliers as jax_multi
from horovod_tpu.callbacks import warmup_schedule as jax_warmup
from horovod_tpu_torch.callbacks import schedule_with_multipliers
from horovod_tpu_torch.callbacks import warmup_schedule
from horovod_tpu_torch.runner.http_server import RendezvousServer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
STEPS = 1200


def _f32(x):
    return np.float32(x).tobytes()


@pytest.mark.parametrize("base,warmup,size", [
    (0.1, 10, 8), (0.0123, 7, 3), (1e-3, 1000, 5), (0.3, 0, 2),
    (0.05, 1, 1)])
def test_warmup_schedule_equals_jax(base, warmup, size):
    want = jax_warmup(base, warmup_steps=warmup, size=size)
    got = warmup_schedule(base, warmup_steps=warmup, size=size)
    steps = torch.arange(STEPS)
    as_tensor = got(steps)
    assert as_tensor.dtype == torch.float32
    for s in range(STEPS):
        w = _f32(want(s))
        assert _f32(got(s)) == w, s
        assert _f32(as_tensor[s].item()) == w, s
        assert isinstance(got(s), float)


@pytest.mark.parametrize("base,mults,spe", [
    (0.4, [(0, 1.0), (2, 0.1), (4, 0.01)], 10),
    (0.1, [(3, 0.5), (5, 0.25)], 7),
    (1.0, [(1, 0.3)], 1)])
def test_schedule_with_multipliers_equals_jax(base, mults, spe):
    want = schedule_with_multipliers(base, mults, spe)
    ref = jax_multi(base, mults, spe)
    n = 10 * spe
    for s in range(n):
        w = _f32(ref(s))
        assert _f32(want(s)) == w, s
        assert _f32(want(torch.tensor(s)).item()) == w, s


def test_schedules_drive_lambda_lr():
    """``LambdaLR`` over the base rate walks the warmup schedule."""
    base = 0.1
    sched = warmup_schedule(base, warmup_steps=4, size=4)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=base)
    lam = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: sched(s) / base)
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lam.step()
    np.testing.assert_allclose(seen, [sched(s) for s in range(6)],
                               rtol=1e-7)
    assert seen[-1] == pytest.approx(0.4)


def test_metric_average_one_rank():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import metric_average

    hvd.shutdown()
    hvd.init(rank=0, size=1, local_rank=0, local_size=1, device="cpu")
    try:
        assert metric_average(3.5, "loss") == pytest.approx(3.5)
        np.testing.assert_allclose(
            metric_average(np.array([1.0, 2.0]), "vec"), [1.0, 2.0])
    finally:
        hvd.shutdown()


_RANK = r'''
import sys
import numpy as np
pkg = sys.argv[1]
if pkg == "jax":
    import horovod_tpu as hvd
    from horovod_tpu.callbacks import metric_average
    hvd.init()
else:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import metric_average
    hvd.init(device="cpu", backend="none")
r = hvd.rank()
a = metric_average(1.25 + r, "loss")
v = metric_average(np.array([r, 2.0 * r + 1]), "vec")
print("AVG", repr(a), repr([float(x) for x in v]), flush=True)
hvd.shutdown()
'''


@pytest.mark.timeout(120)
def test_metric_average_mixed_gang():
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    env0 = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env0["PYTHONPATH"] = REPO + os.pathsep + env0.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, pkg],
        env=dict(env0, HVD_RANK=str(r), HVD_SIZE="2",
                 HVD_LOCAL_RANK=str(r), HVD_LOCAL_SIZE="2",
                 HVD_RENDEZVOUS_ADDR="127.0.0.1",
                 HVD_RENDEZVOUS_PORT=str(port), HVD_TPU_CORE="py",
                 HVD_SHM_DISABLE="1", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r, pkg in enumerate(["jax", "port"])]
    try:
        outs = [p.communicate(timeout=100)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    lines = [[ln for ln in out.splitlines() if ln.startswith("AVG")]
             for out in outs]
    assert all(lines), outs
    assert lines[0] == lines[1] == ["AVG 1.75 [0.5, 2.0]"], lines
