"""The port's TensorFlow, Keras, Spark and MXNet examples
(``examples/torch_port/``) at a tiny size on the CPU (``--device cpu``).

Everything starts at once in a module fixture:

* two gangs of two port ranks (``hvdrun-torch -np 2``) of
  ``tests/torch_port_examples_runner.py``, which runs scripts one after
  another in each rank (TensorFlow imported once): ``tensorflow2_mnist.py``,
  ``tensorflow2_synthetic_benchmark.py`` (fp16 compression) and
  ``keras_mnist.py`` (with a rank-0 checkpoint) in one, and
  ``keras_imagenet_resnet50.py`` in the other, on the Python engine
  (``HVD_TPU_CORE=py``: a runtime started again in one process is its
  case, and the native engine's TF ops would build first);
* the JAX package's ``examples/tensorflow2_mnist.py`` under its own
  launcher with the same arguments, through the same runner: the losses
  the two print are equal to their printed four decimals (the runner
  seeds Keras's initializers the same way on both sides, which neither
  script does);
* ``keras_spark_mnist.py`` and ``pytorch_spark_mnist.py`` (the
  estimators through the port's launcher function mode, two ranks each);
* ``mxnet_mnist.py`` and ``mxnet_imagenet_resnet50.py``, which exit with
  their message where MXNet is not installed.
"""

import importlib.util
import json
import math
import os
import re
import sys

import pytest

from test_torch_examples import (
    EXAMPLES,
    REPO,
    RUNNER,
    port_gang,
    run_all,
    sections,
)

if importlib.util.find_spec("tensorflow") is None:
    pytest.skip("TensorFlow is not installed", allow_module_level=True)

TF_MNIST_ARGS = ["--steps", "51", "--batch-size", "16"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_examples_tf"))
    plans = {
        "tf": [["tensorflow2_mnist.py", TF_MNIST_ARGS + ["--device", "cpu"]],
               ["tensorflow2_synthetic_benchmark.py", [
                   "--device", "cpu", "--model", "tiny", "--batch-size", "4",
                   "--num-warmup-batches", "1", "--num-batches-per-iter",
                   "2", "--num-iters", "2", "--fp16-allreduce"]],
               ["keras_mnist.py", [
                   "--device", "cpu", "--epochs", "2", "--samples", "256",
                   "--batch-size", "64", "--checkpoint-dir",
                   os.path.join(tmp, "ck")]]],
        "keras": [["keras_imagenet_resnet50.py", [
            "--device", "cpu", "--epochs", "1", "--samples", "16",
            "--image-size", "32", "--batch-size", "8"]]],
    }
    py = [sys.executable]
    spark = ["--num-proc", "2", "--epochs", "1", "--device", "cpu"]
    commands = {
        "tf": (port_gang(plans["tf"]), {"HVD_TPU_CORE": "py",
                                        "EXAMPLES_KERAS_SEED": "0"}),
        "keras": (port_gang(plans["keras"]), {"HVD_TPU_CORE": "py"}),
        # The JAX package's original through the same runner, seeded the
        # same way (neither script seeds Keras's initializers).
        "jax_tf_mnist": ([sys.executable, "-m", "horovod_tpu.runner.run",
                          "-np", "2", "--", sys.executable, RUNNER,
                          json.dumps([[os.path.join(
                              REPO, "examples", "tensorflow2_mnist.py"),
                              TF_MNIST_ARGS]])],
                         {"EXAMPLES_KERAS_SEED": "0"}),
        "keras_spark": (py + [os.path.join(EXAMPLES,
                                           "keras_spark_mnist.py")] + spark,
                        {"HVD_TPU_CORE": "py"}),
        "torch_spark": (py + [os.path.join(EXAMPLES,
                                           "pytorch_spark_mnist.py")] + spark,
                        None),
    }
    for name in ("mxnet_mnist.py", "mxnet_imagenet_resnet50.py"):
        commands[name] = (py + [os.path.join(EXAMPLES, name), "--device",
                                "cpu"], None)
    out = run_all(commands, tmp)
    out["sections"] = []
    for gang, plan in plans.items():
        rc, text = out[gang]
        assert rc == 0, text
        secs = sections(text)
        assert [s for s, _ in secs] == [s for s, _ in plan], text
        out["sections"] += [t for _, t in secs]
    out["ck"] = os.listdir(os.path.join(tmp, "ck"))
    return out


def test_tensorflow2_mnist_matches_the_jax_package(runs):
    port = re.findall(r"step (\d+): loss ([\d.]+)", runs["sections"][0])
    rc, text = runs["jax_tf_mnist"]
    assert rc == 0, text
    jax = re.findall(r"step (\d+): loss ([\d.]+)", sections(text)[0][1])
    assert len(port) == 2 and port == jax, (port, jax)
    assert "images/sec across 2 process(es)" in runs["sections"][0]


def test_tensorflow2_synthetic_benchmark_reports(runs):
    text = runs["sections"][1]
    assert re.search(r"Img/sec per device: [\d.]+ \+-[\d.]+", text), text
    assert "Total img/sec on 2 device(s)" in text, text


def test_keras_mnist_averages_and_checkpoints_on_rank0(runs):
    text = runs["sections"][2]
    acc = re.search(r"accuracy \(avg over 2 ranks\): ([\d.]+)", text)
    assert acc and 0.0 <= float(acc.group(1)) <= 1.0, text
    # The two epochs scale down to one per rank of two (the reference's
    # idiom); rank 0 alone wrote its checkpoint.
    assert runs["ck"] == ["checkpoint-1.keras"], runs["ck"]


def test_keras_imagenet_resnet50_trains(runs):
    text = runs["sections"][3]
    m = re.search(r"final loss (\S+) acc (\S+)", text)
    assert m and math.isfinite(float(m.group(1))), text


@pytest.mark.parametrize("which", ["keras_spark", "torch_spark"])
def test_spark_estimators_fit_and_predict(runs, which):
    rc, text = runs[which]
    assert rc == 0, text
    assert "DONE" in text, text
    acc = re.search(r"accuracy on 512 train rows: ([\d.]+)", text)
    assert acc and float(acc.group(1)) > 0.5, text


@pytest.mark.parametrize("name", ["mxnet_mnist.py",
                                  "mxnet_imagenet_resnet50.py"])
def test_mxnet_scripts_exit_with_a_message_without_mxnet(runs, name):
    if importlib.util.find_spec("mxnet") is not None:
        pytest.skip("mxnet is installed: the gate does not apply")
    rc, text = runs[name]
    assert rc == 1, text
    assert "mxnet is not installed" in text, text
    assert "tests/test_torch_mxnet.py" in text, text
