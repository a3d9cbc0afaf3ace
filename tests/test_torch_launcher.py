"""The port's launcher end to end: ``python -m horovod_tpu_torch.runner.run``
spawns real port workers that rendezvous through its KV server and run the
eager engine's collectives on the CPU (``tests/test_launcher_e2e.py``'s
cases on the port).

* ``-np 2`` and ``-np 4``: every rank's allreduce sums, the output is
  rank-prefixed;
* fail fast: one rank exits 3, the launcher kills the other and fails;
* ``--max-restarts``: a rank that fails on the first attempt is relaunched
  with the gang, and the job exits 0 (without the flag it fails);
* the function mode: ``run(fn, np=2, device="cpu")`` returns each rank's
  value, and a raising function's traceback;
* elastic: ``--min-np 2`` with three ranks, rank 2 SIGKILLs itself after
  step 3, the survivors re-form in process and finish every step, and the
  launcher exits 0 (two workers finished cleanly).
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""\
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu", backend="none")
    r, n = hvd.rank(), hvd.size()
    out = hvd.allreduce(torch.full((4,), float(r + 1)), name="t",
                        op=hvd.Sum)
    assert torch.equal(out, torch.full((4,), float(sum(range(1, n + 1))))), out
    print(f"rank {r}/{n} ok local {hvd.local_rank()}/{hvd.local_size()}")
    hvd.shutdown()
""")

FAILING_WORKER = textwrap.dedent("""\
    import sys, time
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", backend="none")
    if hvd.rank() == 1:
        sys.exit(3)
    time.sleep(60)  # the launcher must kill this rank
""")

CRASH_ONCE_WORKER = textwrap.dedent("""\
    import os, sys
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", backend="none")
    r = hvd.rank()
    sentinel = os.environ["SENTINEL"]
    if r == 1 and not os.path.exists(sentinel):
        open(sentinel, "w").close()
        sys.exit(5)  # the first attempt: rank 1 dies mid-job
    out = hvd.allreduce(torch.full((3,), float(r + 1)), name="e",
                        op=hvd.Sum)
    assert float(out[0]) == sum(range(1, hvd.size() + 1)), out
    print(f"rank {r} resumed ok ({os.environ.get('HVD_RDV_SCOPE')})")
    hvd.shutdown()
""")

ELASTIC_WORKER = textwrap.dedent("""\
    import os, signal
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    TOTAL = 6
    victim = os.environ["HVD_RANK"] == "2"
    state = hvd.elastic.ObjectState(step=0)
    state.register_reset_callbacks(
        [lambda: print(f"RESET size {hvd.size()}", flush=True)])

    @hvd.elastic.run(device="cpu")
    def train(state):
        while state.step < TOTAL:
            out = hvd.allreduce(np.ones(2, np.float32), op=hvd.Sum,
                                name=f"step{state.step}")
            print(f"STEP {state.step} {float(out[0])}", flush=True)
            if victim and state.step == 3:
                os.kill(os.getpid(), signal.SIGKILL)
            state.step += 1
            state.commit()

    train(state)
    print(f"DONE size {hvd.size()} epoch "
          f"{os.environ.get('HVD_ELASTIC_EPOCH')}", flush=True)
    hvd.shutdown()
""")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _run_cli(tmp_path, script, np_, flags=(), timeout=60, env=None):
    prog = tmp_path / "prog.py"
    prog.write_text(script)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.run",
         "-np", str(np_), *flags, "--", sys.executable, str(prog)],
        capture_output=True, text=True, timeout=timeout,
        env=env or _env(), cwd=str(tmp_path))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("np_", [2, 4])
def test_cli_allreduce_gang(tmp_path, np_):
    res = _run_cli(tmp_path, WORKER, np_, flags=("--no-shm",))
    assert res.returncode == 0, res.stdout + res.stderr
    for r in range(np_):
        assert f"[{r}]<stdout>: rank {r}/{np_} ok local {r}/{np_}" in \
            res.stdout, res.stdout


@pytest.mark.timeout(60)
def test_cli_fail_fast(tmp_path):
    res = _run_cli(tmp_path, FAILING_WORKER, 2, flags=("--no-shm",))
    assert res.returncode != 0
    assert "worker rank 1 exited with code 3" in res.stderr, res.stderr


@pytest.mark.timeout(90)
def test_cli_max_restarts_relaunches(tmp_path):
    env = _env(SENTINEL=str(tmp_path / "crashed_once"))
    res = _run_cli(tmp_path, CRASH_ONCE_WORKER, 2,
                   flags=("--max-restarts", "2", "--no-shm"), env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "restarting the job (attempt 1/2)" in res.stderr, res.stderr
    for r in range(2):
        assert f"rank {r} resumed ok (attempt1)" in res.stdout, res.stdout
    # Without restarts the same crash fails the job.
    os.remove(tmp_path / "crashed_once")
    res = _run_cli(tmp_path, CRASH_ONCE_WORKER, 2, flags=("--no-shm",),
                   env=env)
    assert res.returncode != 0


@pytest.mark.timeout(60)
def test_run_func_mode(monkeypatch):
    from horovod_tpu_torch.runner import run as run_mod

    # Functions defined here travel by value (cloudpickle).
    def _rank_times(x):
        import horovod_tpu_torch as hvd

        return hvd.rank() * x + hvd.size()

    def _raises():
        raise ValueError("from the function")

    monkeypatch.setenv("PYTHONPATH",
                       REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("HVD_SHM_DISABLE", "1")
    assert run_mod.run(_rank_times, args=(10,), np=2, device="cpu") == \
        [2, 12]
    with pytest.raises(RuntimeError, match="from the function"):
        run_mod.run(_raises, np=2, device="cpu")


@pytest.mark.timeout(90)
def test_cli_elastic_min_np_survives_a_killed_rank(tmp_path):
    env = _env(HVD_HEARTBEAT_TIMEOUT="2.0", HVD_HEARTBEAT_INTERVAL="0.25",
               HVD_ELASTIC_CHECK_INTERVAL_S="0.05")
    res = _run_cli(tmp_path, ELASTIC_WORKER, 3,
                   flags=("--min-np", "2", "--no-shm"), env=env, timeout=80)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "worker rank 2 on localhost exited with code -9" in res.stderr, \
        res.stderr
    for r in (0, 1):
        lines = [ln.split(": ", 1)[1] for ln in res.stdout.splitlines()
                 if ln.startswith(f"[{r}]<stdout>: ")]
        assert "RESET size 2" in lines, lines
        assert "DONE size 2 epoch 1" in lines, lines
        steps = {ln.split()[1] for ln in lines if ln.startswith("STEP ")}
        assert steps == {str(i) for i in range(6)}, lines
