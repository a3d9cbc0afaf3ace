"""Build the native C++ core and the framework-op libraries linked against
it: the port of ``horovod_tpu/common/native_build.py`` and of the build in
``horovod_tpu/native.py``.

The core's sources are ``horovod_tpu_torch/csrc/`` (the port's own copy
of the JAX package's ``csrc/``, wire for wire); nothing outside the
package is read.  The build runs at first use, never at import:

* the core: one ``g++ -c`` per source, all started together, then one
  link into ``<repo>/build/horovod_tpu_torch/libhvd_torch_core_<hash>.so``;
* a framework-op library (``torch_ops.cc``): one ``g++`` against the
  framework's headers, linked to the core with an ``$ORIGIN`` rpath, into
  ``libhvd_torch_ops_<hash>.so`` beside it.

Each library is named by a hash of its sources, every header they may
include and the flags (an op library's hash includes the core's), so an
edited source never loads a stale library.  A build holds an ``fcntl``
lock on the build directory: of the processes that start at once (the
ranks of a gang, the test workers) exactly one compiles, and the rest find
its library when they get the lock.  Every file is written under a
per-process name and published by an atomic rename.  ``CXX`` names the
compiler (default ``g++``).
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "horovod_tpu_torch")

CORE_SOURCES = ("wire.cc", "sockets.cc", "kernels.cc", "autotune.cc",
                "timeline.cc", "engine.cc", "c_api.cc")
# Everything a translation unit may include: a change in any of them (the
# enum values in types.h above all) must rebuild, or a stale library would
# map wire enums wrongly.
HEADERS = ("types.h", "wire.h", "sockets.h", "kernels.h", "autotune.h",
           "timeline.h", "engine.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-w")
BUILD_TIMEOUT_S = 600

# Seconds the last build in this process took, by library name (a library
# found built records nothing).
build_seconds = {}


def cxx() -> str:
    return os.environ.get("CXX", "g++")


def _digest(files: Sequence[str], *extra: str) -> str:
    h = hashlib.sha256(" ".join(extra).encode())
    for name in files:
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def core_path() -> str:
    """Where the core built from the current sources lives."""
    tag = _digest(CORE_SOURCES + HEADERS, cxx(), *CXX_FLAGS)
    return os.path.join(BUILD_DIR, f"libhvd_torch_core_{tag}.so")


def ops_path(src: str, key: Sequence[str] = ()) -> str:
    """Where the op library of ``src`` (a file in ``csrc/``), built
    against the core and ``key`` (the framework's version and flags),
    lives."""
    stem = os.path.splitext(src)[0]
    tag = _digest((src,) + HEADERS, os.path.basename(core_path()), *key)
    return os.path.join(BUILD_DIR, f"libhvd_{stem}_{tag}.so")


def _run(cmds):
    """Run the commands at once, at a lower CPU priority (``nice``) than
    the processes beside them: a build may start while other ranks'
    heartbeats must keep their deadlines.  Raises with the first
    failure's output."""
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    procs = [(cmd, subprocess.Popen(nice + cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    fails = []
    for cmd, p in procs:
        try:
            out = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + f"\n(killed after {BUILD_TIMEOUT_S} s)"
        if p.returncode != 0:
            fails.append(f"{' '.join(cmd)}\n{out[-2000:]}")
    if fails:
        raise RuntimeError("native build failed: " + "\n".join(fails))


def _locked_build(out: str, compile_fn) -> str:
    """``compile_fn(part)`` writes the library to ``part``; run it under
    the build directory's lock unless ``out`` exists, then publish."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # built while this process waited
                return out
            part = f"{out}.{os.getpid()}.part"
            t0 = time.perf_counter()
            try:
                compile_fn(part)
                os.replace(part, out)
            finally:
                if os.path.exists(part):
                    os.remove(part)
            build_seconds[os.path.basename(out)] = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def build_core() -> str:
    """The core's library, built unless one of the same sources exists:
    one compiler per source at once, then the link."""
    out = core_path()

    def compile_core(part):
        objs = [f"{part}.{os.path.splitext(s)[0]}.o" for s in CORE_SOURCES]
        try:
            _run([[cxx(), *CXX_FLAGS, "-c", os.path.join(CSRC_DIR, s),
                   "-o", o] for s, o in zip(CORE_SOURCES, objs)])
            _run([[cxx(), *CXX_FLAGS, "-shared", *objs,
                   f"-Wl,-soname,{os.path.basename(out)}", "-o", part]])
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)

    return _locked_build(out, compile_core)


def build_ops(src: str, extra_flags: Sequence[str],
              extra_links: Sequence[str], key: Sequence[str] = ()) -> str:
    """The op library of ``src`` linked against the core (built first),
    with an ``$ORIGIN`` rpath, so that it loads the core instance the
    engine runs in."""
    core = build_core()
    out = ops_path(src, key)

    def compile_ops(part):
        _run([[cxx(), *CXX_FLAGS, f"-I{CSRC_DIR}", *extra_flags, "-shared",
               os.path.join(CSRC_DIR, src), f"-L{BUILD_DIR}",
               f"-l:{os.path.basename(core)}", "-Wl,-rpath,$ORIGIN",
               *extra_links, "-o", part]])

    return _locked_build(out, compile_ops)


def native_engine_active() -> bool:
    """True while this process runs the native engine (checked at every
    call, never latched: a shutdown and ``init`` may change the engine)."""
    try:
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.runtime_native import NativeEngine

        return isinstance(basics._engine_obj, NativeEngine)
    except Exception:
        return False
