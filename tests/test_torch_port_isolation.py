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
