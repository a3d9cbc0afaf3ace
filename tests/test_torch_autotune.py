"""The port's autotuner (``horovod_tpu_torch/autotune/``) against the JAX
package's.

* The same initial knobs and the same ``record_bytes(nbytes, now=...)``
  sequence, with an injected clock, give the same ``TunedParams`` at every
  step, the same settled knobs and the same autotune log CSV, byte for
  byte: fusion alone, all six dimensions, and knobs pinned in the
  environment (``from_env``).  The score closes the loop: each sample's
  bytes are a function of the knobs the tuner chose, so that a diverging
  choice changes everything after it.
* ``autotune_options_from_env`` is the JAX policy for every pinned knob
  and topology.
* Gangs of three (``tests/torch_port_engine_worker.py autotune``) tune to
  the end with ``HVD_AUTOTUNE=1`` and a short schedule: a port gang, a
  JAX root over port workers and a port root over JAX workers.  Every
  rank ends holding the root's settled knobs, the root's log ends in its
  ``final`` row, and every rank's results are bit-equal to the others'.
"""

import csv
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest

from horovod_tpu.autotune import parameter_manager as jpm
from horovod_tpu_torch.autotune import parameter_manager as ppm

from test_torch_engine import _finish, _start

PINNABLE = ("HVD_FUSION_THRESHOLD", "HVD_CYCLE_TIME", "HVD_CACHE_CAPACITY",
            "HVD_HIERARCHICAL_ALLREDUCE", "HVD_HIERARCHICAL_ALLGATHER",
            "HVD_RING_SEGMENT_BYTES")
TUNE_ENV = ("HVD_AUTOTUNE", "HVD_AUTOTUNE_LOG", "HVD_AUTOTUNE_WARMUP_SAMPLES",
            "HVD_AUTOTUNE_MAX_SAMPLES",
            "HVD_AUTOTUNE_SAMPLE_DURATION_SECONDS")


@pytest.fixture
def clean_env(monkeypatch):
    for k in PINNABLE + TUNE_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _surface(p) -> float:
    """Bytes a sample moves under knobs ``p``: a bumpy function of every
    knob, so that each dimension changes the score."""
    f = p.fusion_threshold / float(64 << 20)
    c = (p.cycle_time_s - 0.0005) / 0.0245
    s = p.ring_segment_bytes / float(4 << 20)
    return 1e8 * (1.0 + np.sin(6 * f) * 0.3 - (c - 0.3) ** 2
                  + 0.2 * p.cache_enabled + 0.1 * p.hierarchical_allreduce
                  - 0.05 * p.hierarchical_allgather + 0.15 * np.cos(5 * s))


def _drive(mod, pm, n=400):
    """Feed ``pm`` a record every 0.1 s of the injected clock; returns each
    step's result as a tuple (None when no step fired)."""
    out = []
    now = 100.0
    for _ in range(n):
        now += 0.1
        r = pm.record_bytes(int(_surface(pm.current) * 0.1), now=now)
        out.append(None if r is None else dataclasses.astuple(r))
        if pm.done and r is not None:
            break
    return out


DIMS = {
    "fusion": dict(tune_fusion=True, tune_cycle=False, tune_cache=False),
    "all_six": dict(tune_fusion=True, tune_cycle=True, tune_cache=True,
                    tune_hier_allreduce=True, tune_hier_allgather=True,
                    tune_segment=True),
    "default": {},
}


@pytest.mark.parametrize("dims", list(DIMS))
def test_decisions_and_log_equal_jax(tmp_path, dims):
    runs = {}
    for name, mod in (("port", ppm), ("jax", jpm)):
        log = tmp_path / f"{name}.csv"
        pm = mod.ParameterManager(
            mod.TunedParams(32 << 20, 0.005, True, False, False, 0),
            warmup_samples=2, max_samples=12, sample_duration_s=0.5,
            log_path=str(log), **DIMS[dims])
        steps = _drive(mod, pm)
        runs[name] = (steps, dataclasses.astuple(pm.current), pm.done,
                      log.read_bytes())
    port, jax = runs["port"], runs["jax"]
    assert port[2] and jax[2]
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[3] == jax[3]
    rows = list(csv.reader(port[3].decode().splitlines()))
    assert rows[-1][0] == "final" and len(rows) == 1 + 12 + 1
    # The tuner moved the knobs: more than one configuration was scored.
    assert len({tuple(r[2:]) for r in rows[1:-1]}) > 1


PIN_CASES = [
    ({}, False),
    ({}, True),
    ({"HVD_FUSION_THRESHOLD": "1048576"}, True),
    ({"HVD_CYCLE_TIME": "2", "HVD_CACHE_CAPACITY": "0"}, False),
    ({"HVD_HIERARCHICAL_ALLREDUCE": "1",
      "HVD_RING_SEGMENT_BYTES": "65536"}, True),
    ({k: "1" for k in PINNABLE}, True),
]


@pytest.mark.parametrize("pins,hier_ok", PIN_CASES)
def test_env_policy_and_pinned_tuning_equal_jax(clean_env, tmp_path, pins,
                                               hier_ok):
    clean_env.setenv("HVD_AUTOTUNE", "1")
    clean_env.setenv("HVD_AUTOTUNE_WARMUP_SAMPLES", "1")
    clean_env.setenv("HVD_AUTOTUNE_MAX_SAMPLES", "6")
    clean_env.setenv("HVD_AUTOTUNE_SAMPLE_DURATION_SECONDS", "0.25")
    for k, v in pins.items():
        clean_env.setenv(k, v)
    for h in (False, True):
        opts = ppm.autotune_options_from_env(h)
        assert opts == jpm.autotune_options_from_env(h)
    runs = {}
    for name, mod in (("port", ppm), ("jax", jpm)):
        clean_env.setenv("HVD_AUTOTUNE_LOG", str(tmp_path / f"{name}.csv"))
        pm = mod.ParameterManager.from_env(
            8 << 20, 0.005, hierarchical_allreduce=False,
            hierarchical_allgather=True, hierarchical_ok=hier_ok,
            ring_segment_bytes=0)
        if pm is None:
            runs[name] = None
            continue
        steps = _drive(mod, pm)
        runs[name] = (pm._dims, steps, dataclasses.astuple(pm.current),
                      (tmp_path / f"{name}.csv").read_bytes())
    assert runs["port"] == runs["jax"]
    if len(pins) == len(PINNABLE):
        assert runs["port"] is None  # every knob pinned: nothing to tune
    else:
        dims = runs["port"][0]
        assert ("hier_ar" in dims) == (
            hier_ok and "HVD_HIERARCHICAL_ALLREDUCE" not in pins)
        assert ("fusion" in dims) == ("HVD_FUSION_THRESHOLD" not in pins)


def test_off_without_the_knob(clean_env):
    assert ppm.ParameterManager.from_env(1 << 20, 0.005) is None
    clean_env.setenv("HVD_AUTOTUNE", "0")
    assert ppm.autotune_options_from_env(True) is None


# ---------------------------------------------------------------------------
# gangs that tune to the end
# ---------------------------------------------------------------------------

GANGS = {
    "port3": ["port-nogroup"] * 3,
    "jax_root": ["jax", "port-nogroup", "port-nogroup"],
    "port_root": ["port-nogroup", "jax", "jax"],
}


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    root = tmp_path_factory.mktemp("autotune_gangs")
    started = {}
    for name, pkgs in GANGS.items():
        d = str(root / name)
        env = {"HVD_AUTOTUNE": "1", "HVD_AUTOTUNE_WARMUP_SAMPLES": "1",
               "HVD_AUTOTUNE_MAX_SAMPLES": "4",
               "HVD_AUTOTUNE_SAMPLE_DURATION_SECONDS": "0.1",
               "HVD_AUTOTUNE_LOG": os.path.join(d, "autotune.csv")}
        started[name] = _start(pkgs, ["autotune"], d, env)
    deadline = time.monotonic() + 120.0
    out = {}
    for name, (server, procs) in started.items():
        runs = _finish(server, procs, deadline)
        results = []
        for r in range(len(procs)):
            path = root / name / f"rank{r}.pkl"
            results.append(pickle.loads(path.read_bytes())
                           if path.exists() else {})
        log = root / name / "autotune.csv"
        out[name] = (runs, results, log.read_text() if log.exists() else "")
    return out


def _arr(rec):
    dtype, shape, raw = rec
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


@pytest.mark.parametrize("name", list(GANGS))
def test_gang_tunes_to_the_end(tuned, name):
    runs, results, log = tuned[name]
    for r, (code, text) in enumerate(runs):
        assert code == 0 and "SCENARIO_OK autotune" in text, \
            f"rank {r} (exit {code}):\n{text[-3000:]}"
    final = _arr(results[0]["autotune"]["final"])
    assert final[6] == 1.0, final  # the root's tuner settled
    crcs = {tuple(_arr(res["autotune"]["crc"])) for res in results}
    assert len(crcs) == 1, crcs  # the same bits, steps and settling step
    for r, res in enumerate(results):
        knobs = _arr(res["autotune"]["knobs"])
        np.testing.assert_array_equal(knobs, final[:6], err_msg=f"rank {r}")
    rows = list(csv.reader(log.splitlines()))
    assert rows[0][0] == "sample" and rows[-1][0] == "final", log
    assert len(rows) == 1 + 4 + 1, log
    assert int(rows[-1][2]) == int(final[0])
    assert abs(float(rows[-1][3]) - final[1] * 1e3) < 1e-3
    assert int(rows[-1][4]) == int(final[2])
    assert int(rows[-1][7]) == int(final[3])
