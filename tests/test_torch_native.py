"""The port's native core, in process: its build, the engine choice of
``hvd.init()``, the refusals, and the wire codecs against the port's numpy
arithmetic.

* The core builds from ``horovod_tpu_torch/csrc/`` alone: four processes
  that start at once on a copy of that directory, with an empty build
  directory, produce one library, compiled by exactly one of them.
* ``basics._start_engine`` chooses as the JAX package's ``basics`` does:
  the native engine by default, ``PyEngine`` with a reason under
  ``HVD_TPU_CORE=py`` or after a failed build, ``NotImplementedError``
  under ``HVD_ELASTIC_EPOCH`` unless the Python engine is asked for, and
  no fallback for a failure after the bootstrap.  The engines are stubs
  here; ``tests/test_torch_native_gang.py`` starts real ones.
* The native engine refuses ``HVD_WIRE_CRC=1`` before any rendezvous
  traffic, and serving refuses an engine without the serve channel.
* One hop's combine (``hvd_combine_into``, the SIMD paths where the CPU
  has them) against numpy on the same random bits, for every wire dtype
  and op: the values equal (NaN signs and payloads unspecified, and
  min/max lanes with a NaN input left out, as in
  ``tests/test_kernels_simd.py``).
* The fp8 codecs against ``common/floats.py``: every code decoded, a grid
  of floats encoded, bit for bit.
"""

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from horovod_tpu_torch import basics, native, runtime_py
from horovod_tpu_torch.common import floats, native_build
from horovod_tpu_torch.common.types import DataType, ReduceOp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    """The core's library, bound (whatever ``HVD_TPU_CORE`` says)."""
    import ctypes

    return native._bind(ctypes.CDLL(native_build.build_core()))


def _unset(monkeypatch, name):
    """Unset ``name`` and restore it after the test, also when the code
    under test sets it."""
    monkeypatch.setenv(name, "")
    monkeypatch.delenv(name)


def test_build_paths_stay_in_the_package_and_build_dir():
    pkg = os.path.join(REPO, "horovod_tpu_torch")
    assert native_build.CSRC_DIR == os.path.join(pkg, "csrc")
    assert native_build.BUILD_DIR == os.path.join(REPO, "build",
                                                  "horovod_tpu_torch")
    assert os.path.dirname(native_build.core_path()) == \
        native_build.BUILD_DIR
    for f in native_build.CORE_SOURCES + native_build.HEADERS:
        assert os.path.isfile(os.path.join(native_build.CSRC_DIR, f)), f


_BUILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from horovod_tpu_torch.common import native_build as nb
nb.CSRC_DIR, nb.BUILD_DIR = sys.argv[2], sys.argv[3]
while time.time() < float(sys.argv[4]):
    time.sleep(0.005)
path = nb.build_core()
import ctypes
ctypes.CDLL(path).hvd_simd_available()
print(path, int(bool(nb.build_seconds)))
"""


def test_core_builds_once_under_concurrent_starts(tmp_path):
    """Four processes build at once from a copy of ``csrc/`` into an
    empty build directory: one compiles, the others load its library."""
    import time

    src = tmp_path / "csrc"
    shutil.copytree(native_build.CSRC_DIR, src)
    out = tmp_path / "build"
    start = time.time() + 3.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, REPO, str(src), str(out),
         str(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(4)]
    results = []
    for p in procs:
        so, se = p.communicate(timeout=240)
        assert p.returncode == 0, se
        results.append(so.split())
    paths = {r[0] for r in results}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.dirname(path) == str(out)
    assert sorted(r[1] for r in results) == ["0", "0", "0", "1"]
    # Nothing half-written is left beside the library.
    assert sorted(os.listdir(out)) == [".native.lock",
                                       os.path.basename(path)]


# ---------------------------------------------------------------------------
# the engine choice


class _Stub:
    def __init__(self, *args):
        self.args = args


@pytest.fixture
def choice(monkeypatch):
    """``_start_engine`` with stub engines: returns the started engine's
    class name and its ``native_fallback_reason``."""
    from horovod_tpu_torch import runtime_native

    class Native(_Stub):
        pass

    class Py(_Stub):
        native_fallback_reason = None

    monkeypatch.setattr(runtime_native, "NativeEngine", Native)
    monkeypatch.setattr(runtime_py, "PyEngine", Py)
    for k in ("HVD_TPU_CORE", "HVD_ELASTIC_EPOCH"):
        _unset(monkeypatch, k)
    monkeypatch.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HVD_RENDEZVOUS_PORT", "1")

    def start(size=2):
        eng = basics._start_engine(0, size, 0, size, 0, 1)
        return type(eng).__name__, getattr(eng, "native_fallback_reason",
                                           None)

    return start


def test_default_engine_is_native(choice):
    assert choice() == ("Native", None)


def test_size_one_and_no_rendezvous(choice, monkeypatch):
    assert choice(size=1)[0] == "SingleProcessEngine"
    monkeypatch.delenv("HVD_RENDEZVOUS_PORT")
    assert basics._start_engine(0, 2, 0, 2, 0, 1) is None


@pytest.mark.parametrize("value", ["py", "python", "PY"])
def test_core_py_forces_python_engine_with_reason(choice, monkeypatch,
                                                  value):
    monkeypatch.setenv("HVD_TPU_CORE", value)
    name, reason = choice()
    assert name == "Py"
    assert reason == "HVD_TPU_CORE forces the Python engine"


def test_build_failure_falls_back_with_reason_and_warning(
        choice, monkeypatch):
    def fail():
        raise RuntimeError("native build failed: no compiler")

    logged = []
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "build_core", fail)
    from horovod_tpu_torch.utils import logging as hvd_logging

    log = hvd_logging.get_logger(0)
    monkeypatch.setattr(log, "warning",
                        lambda msg, *a: logged.append(msg % a))
    name, reason = choice()
    assert name == "Py"
    assert reason.startswith("cannot build the native core: native build "
                             "failed: no compiler")
    assert logged and "running the Python engine" in logged[0]


def test_failure_after_bootstrap_raises(choice, monkeypatch):
    from horovod_tpu_torch import runtime_native

    def wired_then_failed(*args):
        raise OSError("engine already initialized")

    monkeypatch.setattr(runtime_native, "NativeEngine", wired_then_failed)
    with pytest.raises(OSError, match="already initialized"):
        choice()


def test_elastic_epoch_refuses_native_engine(choice, monkeypatch):
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "0")
    with pytest.raises(NotImplementedError, match="HVD_TPU_CORE=py"):
        choice()
    monkeypatch.setenv("HVD_TPU_CORE", "py")
    assert choice()[0] == "Py"


def test_elastic_wrapper_pins_python_engine(monkeypatch):
    """``@hvd.elastic.run`` sets ``HVD_TPU_CORE=py`` unless the caller
    chose, before it initializes, as the JAX package's wrapper does."""
    from horovod_tpu_torch import elastic

    _unset(monkeypatch, "HVD_TPU_CORE")
    _unset(monkeypatch, "HVD_ELASTIC_SCOPE_BASE")
    seen = {}

    def is_initialized():
        seen["core"] = os.environ.get("HVD_TPU_CORE")
        raise KeyboardInterrupt  # stop before anything starts

    monkeypatch.setattr(basics, "is_initialized", is_initialized)
    with pytest.raises(KeyboardInterrupt):
        elastic.run(lambda state: None)(types.SimpleNamespace())
    assert seen == {"core": "py"}


def test_launcher_elastic_mode_pins_python_engine(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "MASTER_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.run", "-np", "1",
         "--min-np", "1", "--max-np", "2", "--", sys.executable, "-c",
         "import os; print('CORE', os.environ.get('HVD_TPU_CORE'))"],
        capture_output=True, text=True, timeout=60, env=env,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CORE py" in r.stdout


def test_autotune_arguments_match_the_jax_engine(monkeypatch):
    """``hvd_create``'s autotuner arguments, from the environment as the
    JAX package's ``NativeEngine`` reads it."""
    from horovod_tpu.runtime_native import NativeEngine as JaxNative

    from horovod_tpu_torch.runtime_native import NativeEngine

    for k in list(os.environ):
        if k.startswith(("HVD_AUTOTUNE", "HVD_FUSION", "HVD_CYCLE",
                         "HVD_CACHE", "HVD_HIERARCHICAL")):
            monkeypatch.delenv(k)
    assert NativeEngine._autotune_args() == JaxNative._autotune_args() == \
        (0, 0, 0, 0, 0, 0, 0, 0, 0.0, None)
    monkeypatch.setenv("HVD_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_AUTOTUNE_LOG", "/tmp/tune.csv")
    monkeypatch.setenv("HVD_CYCLE_TIME", "2")
    for hier in (False, True):
        got = NativeEngine._autotune_args(hier)
        assert got == JaxNative._autotune_args(hier)
        assert got[:6] == (1, 1, 0, 1, int(hier), int(hier))
        assert got[-1] == b"/tmp/tune.csv"


# ---------------------------------------------------------------------------
# refusals


def test_native_engine_refuses_wire_crc(monkeypatch):
    from horovod_tpu_torch.runtime_native import NativeEngine

    monkeypatch.setenv("HVD_WIRE_CRC", "1")
    # No rendezvous listens on port 1: the refusal comes first.
    with pytest.raises(RuntimeError, match="HVD_WIRE_CRC=1 is not "
                                           "supported by the native"):
        NativeEngine(0, 2, 0, 2, 0, 1, "127.0.0.1", 1)


def test_serving_refuses_engine_without_serve_channel(monkeypatch):
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serving import ServingLoop

    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16, max_seq_len=8)
    loop = ServingLoop(tfm.init(0, cfg, device="cpu"), cfg, max_batch=2,
                       port=0, host="127.0.0.1", device="cpu")
    monkeypatch.setattr(basics, "_engine_obj", types.SimpleNamespace())
    with pytest.raises(RuntimeError, match=r"serving requires the Python "
                                           r"engine \(HVD_TPU_CORE=py\)"):
        loop._epoch_body(types.SimpleNamespace(serve_generation=0))


def test_serving_loop_asks_for_python_engine(monkeypatch):
    """``ServingLoop.run`` sets ``HVD_TPU_CORE=py`` unless the caller
    chose, before it initializes."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serving import ServingLoop

    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16, max_seq_len=8)
    loop = ServingLoop(tfm.init(0, cfg, device="cpu"), cfg, max_batch=2,
                       port=0, host="127.0.0.1", device="cpu")
    _unset(monkeypatch, "HVD_TPU_CORE")
    seen = {}

    def init(*a, **k):
        seen["core"] = os.environ.get("HVD_TPU_CORE")
        raise KeyboardInterrupt  # stop before anything binds

    monkeypatch.setattr(basics, "is_initialized", lambda: False)
    monkeypatch.setattr(basics, "init", init)
    with pytest.raises(KeyboardInterrupt):
        loop.run()
    assert seen == {"core": "py"}


# ---------------------------------------------------------------------------
# the wire codecs

OPS = [ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX, ReduceOp.PRODUCT]
NUMPY_OP = {ReduceOp.SUM: np.add, ReduceOp.MIN: np.minimum,
            ReduceOp.MAX: np.maximum, ReduceOp.PRODUCT: np.multiply}
N = 1031  # odd: the vector loops' tails run too


def _inputs(dt, op):
    rs = np.random.RandomState(5 + int(dt) * 10 + int(op))
    st = floats.storage_dtype(dt)
    if dt in (DataType.INT32, DataType.INT64):
        # Small values: the C++ signed sum and product must not overflow.
        return (rs.randint(-1000, 1000, N).astype(st),
                rs.randint(-1000, 1000, N).astype(st))
    if dt == DataType.BOOL:
        return rs.randint(0, 2, N).astype(bool), \
            rs.randint(0, 2, N).astype(bool)
    raw = rs.randint(0, 256, (2, N * st.itemsize)).astype(np.uint8)
    return raw[0].view(st), raw[1].view(st)


def _values(arr, dt):
    if dt in floats.NARROW:
        return floats.to_f32(arr, dt)
    return arr


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.name.lower())
@pytest.mark.parametrize("dt", list(DataType), ids=lambda d: d.name.lower())
def test_combine_matches_numpy(lib, dt, op):
    a, b = _inputs(dt, op)
    dst = a.copy()
    lib.hvd_combine_into(dst.ctypes.data, b.ctypes.data, N, int(dt),
                         int(op))
    fa, fb = _values(a, dt), _values(b, dt)
    with np.errstate(all="ignore"):
        want = NUMPY_OP[op](fb, fa)
        if dt in floats.NARROW:
            want = floats.from_f32(want.astype(np.float32), dt)
    want_v, got_v = _values(want, dt), _values(dst, dt)
    if dt == DataType.BOOL or np.dtype(want_v.dtype).kind in "iu":
        np.testing.assert_array_equal(got_v, want_v)
        return
    ok = np.ones(N, bool)
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        ok = ~(np.isnan(fa) | np.isnan(fb))
    np.testing.assert_array_equal(np.isnan(got_v[ok]), np.isnan(want_v[ok]))
    ok &= ~np.isnan(want_v)
    np.testing.assert_array_equal(got_v[ok], want_v[ok])


def test_simd_paths_report_the_cpu(lib):
    """The SIMD paths run wherever the CPU has AVX2 and F16C."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = f.read()
    except OSError:
        pytest.skip("cannot read the CPU's flags")
    want = "avx2" in flags and "f16c" in flags
    assert bool(lib.hvd_simd_available()) == want


@pytest.mark.parametrize("kind,dt", [(0, DataType.FLOAT8_E4M3),
                                     (1, DataType.FLOAT8_E5M2)],
                         ids=["e4m3fn", "e5m2"])
def test_fp8_decode_matches_floats(lib, kind, dt):
    codes = np.arange(256, dtype=np.uint8)
    want = floats.to_f32(codes, dt)
    got = np.empty(256, np.float32)
    lib.hvd_fp8_to_f32(kind, codes.ctypes.data, got.ctypes.data, 256)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("kind,dt", [(0, DataType.FLOAT8_E4M3),
                                     (1, DataType.FLOAT8_E5M2)],
                         ids=["e4m3fn", "e5m2"])
def test_fp8_encode_matches_floats(lib, kind, dt):
    rs = np.random.RandomState(0)
    f = np.concatenate([
        rs.randn(50000).astype(np.float32) * 100,
        rs.randn(50000).astype(np.float32) * 1e-3,
        rs.randn(20000).astype(np.float32) * 1e-6,
        np.array([0.0, -0.0, np.inf, -np.inf, 448.0, 449.0, 1000.0,
                  -448.0, 57344.0, 61440.0, 65000.0, 2**-9, 2**-10,
                  2**-16, 2**-17, 5.7e-10, 496.0, 500.0, -500.0, 511.99,
                  -496.0, 480.0, 465.0], np.float32)])
    got = np.empty(len(f), np.uint8)
    lib.hvd_f32_to_fp8(kind, f.ctypes.data, got.ctypes.data, len(f))
    want = floats.from_f32(f, dt)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the device guards


def test_force_cpu_platform_hides_the_cards():
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); import torch\n"
            "from horovod_tpu_torch.utils import platform\n"
            "platform.force_cpu_platform()\n"
            "print(os.environ['CUDA_VISIBLE_DEVICES'] == '',"
            " torch.cuda.device_count())\n")
    r = subprocess.run([sys.executable, "-c", code, REPO],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "0"]


def test_default_backend_alive_probes_cuda_in_a_subprocess():
    import torch

    from horovod_tpu_torch.utils import platform

    alive, errors = platform.default_backend_alive(timeout=120,
                                                   attempts=1)
    assert alive == torch.cuda.is_available()
    assert alive or (len(errors) == 1 and errors[0].startswith("rc="))
