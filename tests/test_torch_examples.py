"""The port's torch examples (``examples/torch_port/``) at a tiny size on
the CPU (``--device cpu``).

Everything starts at once in a module fixture, so that the file takes
well under a minute:

* one gang of two port ranks (``hvdrun-torch -np 2``) of
  ``tests/torch_port_examples_runner.py``, which runs, one after another
  in each rank: ``pytorch_mnist.py``, ``pytorch_imagenet_resnet50.py``
  (fp16 compression, two backward passes a step, a rank-0 checkpoint)
  and again to resume from it, ``transformer_lm.py`` at tp 2 over gloo
  with a checkpoint and again to resume from it, ``word2vec.py``,
  ``synthetic_benchmark.py`` (its classic regime) and
  ``pytorch_synthetic_benchmark.py``; the ranks run the Python engine
  (``HVD_TPU_CORE=py``), since a runtime started again in one process
  is its case;
* the JAX package's ``examples/pytorch_mnist.py`` under its own launcher
  with the same arguments: the per-epoch losses the two print are equal
  to their printed four decimals;
* alone: ``serve_lm.py --selftest`` (every reply bit for bit
  ``DecodeEngine``'s alone), ``synthetic_benchmark.py`` in its compiled
  regime, ``engine_benchmark.py`` (its driver: the Python engine at two
  fusion thresholds through the launcher's function mode) and
  ``scaling_benchmark.py`` at one and two ranks.
"""

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLES = os.path.join(REPO, "examples", "torch_port")
RUNNER = os.path.join(HERE, "torch_port_examples_runner.py")
TIMEOUT_S = 240

MNIST_ARGS = ["--epochs", "2", "--steps-per-epoch", "4",
              "--batch-size", "16"]
RN_ARGS = ["--device", "cpu", "--image-size", "32", "--width", "8",
           "--num-classes", "10", "--batch-size", "4",
           "--batches-per-allreduce", "2", "--steps-per-epoch", "2",
           "--fp16-allreduce", "--fp32"]
LM_ARGS = ["--device", "cpu", "--tp", "2", "--fp32", "--d-model", "32",
           "--n-heads", "2", "--d-ff", "64", "--vocab-size", "64",
           "--seq-len", "16", "--batch-size", "4", "--checkpoint-every",
           "2"]
BENCH_ARGS = ["--device", "cpu", "--model", "tiny", "--batch-size", "4",
              "--num-warmup-batches", "1", "--num-batches-per-iter", "2",
              "--num-iters", "2"]


def _env(tmp):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    # Few compute threads a process: every script of a file runs at once,
    # beside the other test files' workers.
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               TF_NUM_INTRAOP_THREADS="2", TF_NUM_INTEROP_THREADS="1",
               HVD_BLACKBOX_DIR=os.path.join(tmp, "blackbox"))
    return env


def _run(cmd, env, cwd, out, key):
    t0 = time.monotonic()
    try:
        p = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                           text=True, timeout=TIMEOUT_S)
        out[key] = (p.returncode, p.stdout + p.stderr)
    except subprocess.TimeoutExpired as e:
        out[key] = ("timeout", str(e.stdout))
    out[f"{key}.seconds"] = time.monotonic() - t0


def port_gang(plan, np_=2):
    """The launcher's command for ``np_`` ranks of the runner over
    ``plan`` ([script, [args]] pairs)."""
    return [sys.executable, "-m", "horovod_tpu_torch.runner.run", "-np",
            str(np_), "--no-shm", "--", sys.executable, RUNNER,
            json.dumps(plan)]


def run_all(commands, tmp, env_extra=None):
    """Run ``{key: (cmd, env_extra)}`` at once; returns ``{key: (rc,
    output)}``."""
    out, threads = {}, []
    for key, (cmd, extra) in commands.items():
        env = dict(_env(tmp), **(extra or {}))
        cwd = os.path.join(tmp, key)
        os.makedirs(cwd, exist_ok=True)
        threads.append(threading.Thread(target=_run,
                                        args=(cmd, env, cwd, out, key)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def sections(output):
    """Rank 0's output of a runner gang, one (script, text) per script
    run, in order."""
    secs = []
    for line in output.splitlines():
        if not line.startswith("[0]<stdout>: "):
            continue
        line = line[len("[0]<stdout>: "):]
        if line.startswith("=== ") and not line.startswith("=== exit"):
            secs.append([line[4:], ""])
        elif secs:
            secs[-1][1] += line + "\n"
    return secs


def epoch_losses(text):
    return re.findall(r"epoch (\d+): loss ([\d.]+)", text)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_examples"))
    ck = os.path.join(tmp, "ck")
    plan = [
        ["pytorch_mnist.py", MNIST_ARGS + ["--device", "cpu"]],
        ["pytorch_imagenet_resnet50.py", RN_ARGS + [
            "--epochs", "1", "--checkpoint-format",
            os.path.join(ck, "rn-{epoch}.pt")]],
        ["pytorch_imagenet_resnet50.py", RN_ARGS + [
            "--epochs", "2", "--checkpoint-format",
            os.path.join(ck, "rn-{epoch}.pt")]],
        ["transformer_lm.py", LM_ARGS + [
            "--steps", "4", "--checkpoint-dir", os.path.join(ck, "lm")]],
        ["transformer_lm.py", LM_ARGS + [
            "--steps", "6", "--checkpoint-dir", os.path.join(ck, "lm")]],
        ["word2vec.py", ["--device", "cpu", "--steps", "101",
                         "--corpus-len", "5000", "--batch-size", "32",
                         "--vocab-size", "500"]],
        ["synthetic_benchmark.py", BENCH_ARGS + ["--fp16-allreduce"]],
        ["pytorch_synthetic_benchmark.py", BENCH_ARGS],
    ]
    py = [sys.executable]
    out = run_all({
        "gang": (port_gang(plan), {"HVD_TPU_CORE": "py"}),
        "jax_mnist": ([sys.executable, "-m", "horovod_tpu.runner.run",
                       "-np", "2", "--", sys.executable,
                       os.path.join(REPO, "examples", "pytorch_mnist.py")]
                      + MNIST_ARGS, None),
        "serve": (py + [os.path.join(EXAMPLES, "serve_lm.py"),
                        "--selftest", "3", "--device", "cpu"], None),
        "compiled": (py + [os.path.join(EXAMPLES, "synthetic_benchmark.py")]
                     + BENCH_ARGS, None),
        "engine": (py + [os.path.join(EXAMPLES, "engine_benchmark.py"),
                         "--np", "2", "--quick", "--engine", "py",
                         "--device", "cpu"], None),
        "scaling": (py + [os.path.join(EXAMPLES, "scaling_benchmark.py"),
                          "--devices", "1,2", "--model", "tiny",
                          "--batch-per-device", "4",
                          "--num-warmup-batches", "1",
                          "--num-batches-per-iter", "2", "--num-iters", "2",
                          "--device", "cpu"], None),
    }, tmp)
    rc, text = out["gang"]
    assert rc == 0, text
    secs = sections(text)
    assert [s for s, _ in secs] == [s for s, _ in plan], text
    out["sections"] = [t for _, t in secs]
    return out


def test_pytorch_mnist_matches_the_jax_package(runs):
    port = epoch_losses(runs["sections"][0])
    rc, text = runs["jax_mnist"]
    assert rc == 0, text
    jax = epoch_losses(text)
    assert len(port) == 2 and port == jax, (port, jax)
    assert "on cpu" in runs["sections"][0]


def test_pytorch_imagenet_resnet50_checkpoints_and_resumes(runs):
    first, second = runs["sections"][1:3]
    assert [e for e, _ in epoch_losses(first)] == ["0"], first
    assert "resumed from epoch 1" in second, second
    assert [e for e, _ in epoch_losses(second)] == ["1"], second
    assert all(math.isfinite(float(v)) for _, v in
               epoch_losses(first) + epoch_losses(second))


def test_transformer_lm_tp2_resumes_from_its_checkpoint(runs):
    first, second = runs["sections"][3:5]
    assert "mesh {'dp': 1, 'tp': 2, 'sp': 1} on 2 rank(s)" in first, first
    assert "checkpoint at step 4" in first, first
    assert "resumed from step 4" in second, second
    steps = [int(s) for s in re.findall(r"step (\d+): loss", second)]
    assert steps == [5, 6], second
    losses = [float(v) for v in re.findall(r"loss ([\d.]+)", first + second)]
    assert losses and all(math.isfinite(v) for v in losses)


def test_word2vec_sparse_and_dense_allreduce(runs):
    text = runs["sections"][5]
    losses = [float(v) for v in re.findall(r"nce loss ([\d.]+)", text)]
    assert len(losses) == 2 and losses[1] < losses[0], text
    assert "across 2 process(es) on cpu" in text, text


@pytest.mark.parametrize("which", ["classic", "pytorch", "compiled"])
def test_synthetic_benchmarks_report(runs, which):
    text = {"classic": runs["sections"][6],
            "pytorch": runs["sections"][7]}.get(which)
    n = 2 if which != "compiled" else 1
    if text is None:
        rc, text = runs["compiled"]
        assert rc == 0, text
        assert "compiled mode on cpu" in text, text
    assert re.search(r"Img/sec per device: [\d.]+ \+-[\d.]+", text), text
    assert f"Total img/sec on {n} device(s)" in text, text
    last = re.search(r"last loss (\S+)", text)
    assert last and math.isfinite(float(last.group(1))), text


def test_serve_lm_selftest(runs):
    rc, text = runs["serve"]
    assert rc == 0, text
    replies = re.findall(r"request \d: (\[.*\])", text)
    assert len(replies) == 3 and len(set(replies)) > 1, text
    assert "selftest: 3 replies equal to DecodeEngine's alone" in text


def test_engine_benchmark_results(runs):
    rc, text = runs["engine"]
    assert rc == 0, text
    rows = [json.loads(x) for x in re.findall(r"RESULT (\{.*\})", text)]
    # Three wire types and the fused workload at two sizes, at each of
    # the two fusion thresholds.
    assert len(rows) == 16, text
    assert {(r["engine"], r["fusion_mb"]) for r in rows} == {
        ("py", 64), ("py", 0)}
    assert all(r["alg_mb_s"] > 0 and r["np"] == 2 for r in rows)


def test_scaling_benchmark_efficiency(runs):
    rc, text = runs["scaling"]
    assert rc == 0, text
    last = json.loads(text.strip().splitlines()[-1])
    assert last["metric"] == "weak_scaling_efficiency"
    assert set(last["per_count"]) == {"1", "2"} and \
        last["per_count"]["1"] == 1.0
    assert "2 rank(s)" in text and "(loss " in text, text


# The JAX package's examples and their twins under examples/torch_port/.
TWINS = {
    "pytorch_mnist.py": "pytorch_mnist.py",
    "jax_mnist.py": "pytorch_mnist.py",
    "pytorch_imagenet_resnet50.py": "pytorch_imagenet_resnet50.py",
    "pytorch_synthetic_benchmark.py": "pytorch_synthetic_benchmark.py",
    "jax_synthetic_benchmark.py": "synthetic_benchmark.py",
    "jax_transformer_lm.py": "transformer_lm.py",
    "jax_word2vec.py": "word2vec.py",
    "serve_lm.py": "serve_lm.py",
    "engine_benchmark.py": "engine_benchmark.py",
    "scaling_benchmark.py": "scaling_benchmark.py",
    "keras_mnist.py": "keras_mnist.py",
    "keras_imagenet_resnet50.py": "keras_imagenet_resnet50.py",
    "keras_spark_mnist.py": "keras_spark_mnist.py",
    "tensorflow2_mnist.py": "tensorflow2_mnist.py",
    "tensorflow2_synthetic_benchmark.py":
        "tensorflow2_synthetic_benchmark.py",
    "pytorch_spark_mnist.py": "pytorch_spark_mnist.py",
    "mxnet_mnist.py": "mxnet_mnist.py",
    "mxnet_imagenet_resnet50.py": "mxnet_imagenet_resnet50.py",
}


def test_every_jax_package_example_has_a_twin():
    originals = sorted(f for f in os.listdir(os.path.join(REPO, "examples"))
                       if f.endswith(".py"))
    assert originals == sorted(TWINS)
    twins = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert twins == sorted(set(TWINS.values()))
    with open(os.path.join(EXAMPLES, "README.md")) as fh:
        readme = fh.read()
    for original, twin in TWINS.items():
        assert f"`{original}`" in readme and f"`{twin}`" in readme
