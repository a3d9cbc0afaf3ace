"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.types import NoCudaDeviceError
from horovod_tpu_torch.models import mnist
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "horovod_tpu_torch")


def _forbidden(name: str) -> bool:
    """jax, horovod_tpu, or a submodule of either -- by exact name, so that
    horovod_tpu_torch itself does not match."""
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "horovod_tpu"))


def _port_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_forbidden_matches_exact_names():
    assert _forbidden("horovod_tpu") and _forbidden("horovod_tpu.ops")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("horovod_tpu_torch")
    assert not _forbidden("horovod_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_import_loads_no_jax_or_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import horovod_tpu_torch\n"
        "for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,\n"
        "                               'horovod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(m for m, v in sys.modules.items()\n"
        "                         if v is not None)))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = r.stdout.split()
    assert "horovod_tpu_torch.models.transformer" in loaded
    assert "horovod_tpu_torch.models.resnet" in loaded
    assert "horovod_tpu_torch.models.mnist" in loaded
    for mod in ("ops.adasum", "parallel.pipeline", "data",
                "utils.checkpoint", "integrity.audit", "parallel.multihost",
                "runner.http_client", "serving.decode", "serving.server",
                "torch", "torch.mpi_ops", "torch.compression", "ops.bridge",
                "tools.hvd_trace", "tools.hvd_postmortem", "tools.hvd_top",
                "native", "runtime_native", "common.native_build",
                "torch._native_ops", "utils.logging", "utils.platform",
                "tensorflow", "tensorflow._native_ops", "keras",
                "keras.callbacks", "callbacks", "mxnet", "spark",
                "spark.store", "spark.estimator", "ctrl_sim"):
        assert f"horovod_tpu_torch.{mod}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_source_file_imports_jax_or_jax_package():
    files = list(_port_files())
    assert len(files) >= 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert bad == []


def test_no_example_script_imports_jax_or_jax_package():
    """``examples/torch_port/`` runs on the port alone."""
    ex = os.path.join(REPO, "examples", "torch_port")
    files = sorted(os.path.join(ex, f) for f in os.listdir(ex)
                   if f.endswith(".py"))
    assert len(files) >= 17
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert bad == []


def test_native_sources_include_only_their_own_directory():
    """The core's sources (``horovod_tpu_torch/csrc/``) include only each
    other and system headers: nothing of the JAX package's ``csrc/``.
    ``tf_ops.cc`` adds TensorFlow's framework headers."""
    import re

    from horovod_tpu_torch.common import native_build

    csrc = native_build.CSRC_DIR
    assert csrc == os.path.join(PORT, "csrc")
    files = sorted(os.listdir(csrc))
    assert "ffi_bridge.cc" not in files and "tf_ops.cc" in files
    for f in files:
        with open(os.path.join(csrc, f)) as fh:
            for inc in re.findall(r'#include\s+"([^"]+)"', fh.read()):
                if f == "tf_ops.cc" and \
                        inc.startswith("tensorflow/core/framework/"):
                    continue
                assert "/" not in inc and inc in files, (f, inc)


def test_native_build_reads_and_writes_only_its_directories(
        tmp_path, monkeypatch):
    """Every path the build's compiler commands name is under the port's
    ``csrc/`` or the build directory (the dispatcher ops add torch's own
    headers and libraries)."""
    import torch

    from horovod_tpu_torch.common import native_build
    from horovod_tpu_torch.torch import _native_ops

    cmds = []

    def run(batch):
        for cmd in batch:
            cmds.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_run", run)
    monkeypatch.setattr(native_build, "build_seconds", {})
    native_build.build_core()
    flags, links, key = _native_ops._flags()
    native_build.build_ops(_native_ops.SRC, flags, links, key)
    torch_dir = os.path.dirname(torch.__file__)
    allowed = (native_build.CSRC_DIR, str(tmp_path), torch_dir)
    def path(arg):
        for prefix in ("-I", "-L", "-Wl,-rpath,"):
            if arg.startswith(prefix):
                return arg[len(prefix):]
        return arg

    paths = [path(a) for cmd in cmds for a in cmd[1:] if "/" in a]
    assert paths and all(p.startswith(allowed) for p in paths), paths
    assert sum("-c" in c for c in cmds) == len(native_build.CORE_SOURCES)
    # Nothing lands outside the build directory.
    assert sorted(os.listdir(tmp_path)) == sorted(
        [".native.lock", os.path.basename(native_build.core_path()),
         os.path.basename(_native_ops.library_path())])


def test_tf_ops_build_reads_and_writes_only_its_directories(
        tmp_path, monkeypatch):
    """The TensorFlow kernels' build names only the port's ``csrc/``, the
    build directory and TensorFlow's own headers and libraries, and
    writes only the core and its library into the build directory."""
    tf = pytest.importorskip("tensorflow")

    from horovod_tpu_torch.common import native_build
    from horovod_tpu_torch.tensorflow import _native_ops

    cmds = []

    def run(batch):
        for cmd in batch:
            cmds.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_run", run)
    monkeypatch.setattr(native_build, "build_seconds", {})
    flags, links, key = _native_ops._flags()
    native_build.build_ops(_native_ops.SRC, flags, links, key)
    tf_dir = os.path.dirname(os.path.dirname(tf.sysconfig.get_include()))
    allowed = (native_build.CSRC_DIR, str(tmp_path), tf_dir)

    def path(arg):
        for prefix in ("-I", "-L", "-Wl,-rpath,"):
            if arg.startswith(prefix):
                return arg[len(prefix):]
        return arg

    paths = [path(a) for cmd in cmds for a in cmd[1:] if "/" in a]
    assert paths and all(p.startswith(allowed) for p in paths), paths
    assert os.path.join(native_build.CSRC_DIR, "tf_ops.cc") in paths
    assert sorted(os.listdir(tmp_path)) == sorted(
        [".native.lock", os.path.basename(native_build.core_path()),
         os.path.basename(_native_ops.library_path())])


def _reference_names(path):
    """The public names a module of the JAX package binds at its top level
    (read from its source, not imported)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")} - {"annotations"}


@pytest.mark.parametrize("port_mod, ref", [
    ("horovod_tpu_torch.torch", "horovod_tpu/torch/__init__.py"),
    ("horovod_tpu_torch.torch.mpi_ops", "horovod_tpu/torch/mpi_ops.py"),
    ("horovod_tpu_torch.torch.compression",
     "horovod_tpu/torch/compression.py"),
    ("horovod_tpu_torch.ops.bridge", "horovod_tpu/ops/bridge.py"),
], ids=["torch", "mpi_ops", "compression", "bridge"])
def test_classic_surface_has_the_reference_names(port_mod, ref):
    """``import horovod_tpu_torch.torch as hvd`` is the whole classic API:
    every public name the JAX package's module binds, the port's binds."""
    import importlib

    mod = importlib.import_module(port_mod)
    # The reference's typing and module imports are not its API.
    want = _reference_names(os.path.join(REPO, ref)) - {
        "Optional", "np", "partial", "torch", "basics", "contextmanager",
        "collections"}
    assert sorted(n for n in want if not hasattr(mod, n)) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.shutdown()
    yield
    hvd.shutdown()


def test_init_without_device_raises_instead_of_using_cpu(no_cuda):
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


def test_classic_front_end_init_without_device_raises(no_cuda):
    import horovod_tpu_torch.torch as hvd_torch

    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        hvd_torch.init()
    assert not hvd_torch.is_initialized()


@pytest.mark.parametrize("front_end", ["tensorflow", "keras", "mxnet"])
def test_other_front_ends_init_without_device_raises(no_cuda, front_end):
    """The TensorFlow, Keras and MXNet front-ends' ``init`` is the
    port's: no card, no ``device="cpu"``, no runtime."""
    import importlib

    if front_end != "mxnet":
        pytest.importorskip(front_end)
    hvd_fe = importlib.import_module(f"horovod_tpu_torch.{front_end}")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        hvd_fe.init()
    assert not hvd_fe.is_initialized()


def test_model_init_without_device_raises(no_cuda):
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16)
    with pytest.raises(NoCudaDeviceError):
        tfm.init(0, cfg)
    with pytest.raises(NoCudaDeviceError):
        tfm.init(0, cfg, device="cuda")


def test_train_step_without_device_raises(no_cuda):
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16)
    with pytest.raises(NoCudaDeviceError):
        train.make_transformer_train_step(cfg)


def test_pipeline_and_prefetch_without_device_raise(no_cuda):
    from horovod_tpu_torch.data import prefetch_to_device
    from horovod_tpu_torch.parallel import pipeline

    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=2,
                                n_heads=2, d_ff=16)
    with pytest.raises(NoCudaDeviceError, match="make_pipeline_train_step"):
        pipeline.make_pipeline_train_step(cfg, n_stages=2)
    with pytest.raises(NoCudaDeviceError, match="prefetch_to_device"):
        prefetch_to_device(iter([]))


@pytest.mark.parametrize("make", [
    lambda: resnet.init(0, resnet.ResNetConfig(blocks=(1,), width=8)),
    lambda: resnet.init(0, resnet.resnet18_config(), device="cuda"),
    lambda: mnist.init(0),
    lambda: mnist.init(0, device="cuda"),
], ids=["resnet", "resnet-cuda", "mnist", "mnist-cuda"])
def test_cnn_init_without_device_raises(no_cuda, make):
    with pytest.raises(NoCudaDeviceError):
        make()


@pytest.mark.parametrize("builder", ["make_resnet_train_step",
                                     "make_resnet_train_step_hvd",
                                     "make_mnist_train_step"])
def test_cnn_train_steps_without_device_raise(no_cuda, builder):
    args = () if builder == "make_mnist_train_step" else (
        resnet.resnet50_config(),)
    with pytest.raises(NoCudaDeviceError, match=builder):
        getattr(hvd, builder)(*args)


def test_generate_and_decode_engine_without_device_raise(no_cuda):
    from horovod_tpu_torch.serving import DecodeEngine

    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16, max_seq_len=8)
    model = tfm.init(0, cfg, device="cpu")
    with pytest.raises(NoCudaDeviceError, match="generate"):
        tfm.generate(model, [[1, 2]], max_new_tokens=2)
    with pytest.raises(NoCudaDeviceError, match="DecodeEngine"):
        DecodeEngine(model, cfg, max_batch=2)


def test_multihost_gang_without_device_raises(no_cuda, monkeypatch):
    """``init_torch_distributed`` publishes the store's address; the
    ``hvd.init()`` after it then refuses to run on the CPU unasked."""
    from horovod_tpu.runner.http_server import RendezvousServer

    from horovod_tpu_torch.parallel import multihost

    srv = RendezvousServer(host="127.0.0.1", port=0)
    port = srv.start()
    try:
        monkeypatch.setattr(multihost, "_initialized", False)
        for k, v in (("HVD_RANK", "0"), ("HVD_SIZE", "2"),
                     ("HVD_RENDEZVOUS_ADDR", "127.0.0.1"),
                     ("HVD_RENDEZVOUS_PORT", str(port)),
                     ("MASTER_ADDR", "unset"), ("MASTER_PORT", "unset")):
            monkeypatch.setenv(k, v)
        monkeypatch.delenv("HVD_RDV_SCOPE", raising=False)
        monkeypatch.delenv("HVD_SECRET_KEY", raising=False)
        multihost.init_torch_distributed()
        assert os.environ["MASTER_PORT"] != "unset"
        with pytest.raises(NoCudaDeviceError, match="hvd.init"):
            hvd.init()
        assert not hvd.is_initialized()
    finally:
        srv.stop()


def test_serving_loop_run_without_device_raises(no_cuda, monkeypatch):
    """``ServingLoop``'s default device is the card: ``run()`` on a box
    with none raises before it initializes or binds anything."""
    from horovod_tpu_torch.serving import ServingLoop

    for k in ("HVD_RANK", "HVD_SIZE", "HVD_RENDEZVOUS_ADDR"):
        monkeypatch.delenv(k, raising=False)
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16, max_seq_len=8)
    loop = ServingLoop(tfm.init(0, cfg, device="cpu"), cfg, max_batch=2,
                       port=0, host="127.0.0.1")
    with pytest.raises(NoCudaDeviceError, match="ServingLoop"):
        loop.run()
    assert not hvd.is_initialized()
    assert loop._door is None


def test_launcher_import_loads_no_jax_or_cloudpickle():
    """The launcher's modules import neither JAX nor ``cloudpickle``
    (imported only when the function mode runs; the card's machine has
    none)."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch.runner.run\n"
        "import horovod_tpu_torch.runner.launch\n"
        "import horovod_tpu_torch.runner.run_task\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'horovod_tpu',\n"
        "                                    'cloudpickle')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
