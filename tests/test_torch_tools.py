"""The port's operator tools (``horovod_tpu_torch/tools``) against the JAX
package's (``horovod_tpu/tools``) on the same inputs: the outputs and the
command lines' exit codes must be equal.

* ``hvd_trace``: two traced port gangs of two (``HVD_TRACE=1``; the
  engine worker's ``fusion`` case, and ``fusion`` with ``cache``):
  ``merge``, ``analyze`` / ``analyze_dir``, ``diff`` / ``top_deltas``, and
  each command line.
* ``hvd_postmortem``: the flight-recorder dumps of a port gang of three
  whose rank 2 is killed under heartbeats, and of one whose rank 2
  stalls under a collective deadline: the same verdict, naming rank 2,
  and the same command-line output.
* ``hvd_top``: ``--once --json`` and ``--once`` over a port aggregator's
  ``/gang/metrics.json`` served by the port's debug server, and the exit
  code with no server.

Every gang pins ``HVD_SHM_DISABLE=1`` and sets ``HVD_BLACKBOX_DIR`` in its
own directory.
"""

import contextlib
import io
import json
import os
import sys
import time

import pytest

from horovod_tpu.tools import hvd_postmortem as jpm
from horovod_tpu.tools import hvd_top as jtop
from horovod_tpu.tools import hvd_trace as jtrace
from horovod_tpu_torch.tools import hvd_postmortem as ppm
from horovod_tpu_torch.tools import hvd_top as ptop
from horovod_tpu_torch.tools import hvd_trace as ptrace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_torch_engine as engine_gangs  # noqa: E402
import test_torch_liveness as chaos_gangs  # noqa: E402
from test_torch_liveness import HEARTBEAT_ENV, KILL_PLAN  # noqa: E402
from test_torch_timeouts import STALL_ENV  # noqa: E402


def _quiet(d):
    return {"HVD_SHM_DISABLE": "1",
            "HVD_BLACKBOX_DIR": os.path.join(d, "hvd_blackbox")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two waves of gangs: a traced gang and the killed rank's gang, then
    the second traced gang and the stalled rank's gang."""
    root = tmp_path_factory.mktemp("tools_gangs")
    out = {}
    waves = ((("trace_a", ["fusion"]), "kill"),
             (("trace_b", ["fusion", "cache"]), "stall"))
    deadline = time.monotonic() + 200.0
    for (tname, cases), fname in waves:
        td, fd = str(root / tname), str(root / fname)
        trace_env = dict(_quiet(td), HVD_TRACE="1", HVD_TRACE_DIR=td,
                         HVD_TRACE_CLOCK_SYNC_CYCLES="5")
        traced = engine_gangs._start(["port-nogroup"] * 2, cases, td,
                                     trace_env)
        if fname == "kill":
            failing = chaos_gangs._start(
                ["port"] * 3, "train_steps", fd,
                base_env=dict(HEARTBEAT_ENV, **_quiet(fd)),
                rank_env={2: {"HOROVOD_FAULT_PLAN": KILL_PLAN}})
            stalled = ()
        else:
            failing = chaos_gangs._start(
                ["port"] * 3, "stall_steps", fd,
                base_env=dict(STALL_ENV, **_quiet(fd)),
                rank_env={2: {"TIMEOUT_VICTIM": "1",
                              "TIMEOUT_SITE": "sock.stall"}})
            stalled = (2,)
        out[tname] = (engine_gangs._finish(*traced, deadline), td)
        out[fname] = (chaos_gangs._finish(failing, deadline,
                                          stalled=stalled),
                      os.path.join(fd, "hvd_blackbox"))
    return out


def _cli(main, argv):
    """A tool's ``main(argv)``: (exit code, or the name of the exception it
    raised, stdout, stderr)."""
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            code = main(argv)
        except SystemExit as exc:
            code = exc.code
        except Exception as exc:
            code = type(exc).__name__
    return code, o.getvalue(), e.getvalue()


def _traced(runs, name):
    gang, d = runs[name]
    for r, (code, text) in enumerate(gang):
        assert code == 0, f"rank {r}:\n{text[-3000:]}"
    return d


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["trace_a", "trace_b"])
def test_trace_merge_and_analyze_equal_jax(runs, name, tmp_path):
    d = _traced(runs, name)
    paths = ptrace.trace_files(d)
    assert paths == jtrace.trace_files(d) and len(paths) == 2
    files = ptrace.load_files(paths)
    assert files == jtrace.load_files(paths)
    assert ptrace.rank_offsets(files) == jtrace.rank_offsets(files)
    assert ptrace.merge(files) == jtrace.merge(files)
    rep = ptrace.analyze(files)
    assert rep == jtrace.analyze(files)
    assert rep["num_ranks"] == 2 and rep["num_collectives"] >= 3
    assert ptrace.analyze_dir(d) == jtrace.analyze_dir(d)
    # The command lines: the same exit codes, files and text.
    outs = []
    for tag, main in (("port", ptrace.main), ("jax", jtrace.main)):
        merged = str(tmp_path / f"{tag}.json")
        got = [_cli(main, ["merge", merged, *paths])[0]]
        with open(merged) as f:
            got.append(json.load(f))
        got.append(_cli(main, ["analyze", *paths]))
        got.append(_cli(main, ["analyze", "--json", *paths]))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and outs[0][2][0] == 0


@pytest.mark.timeout(300)
def test_trace_diff_equal_jax(runs, tmp_path):
    a, b = _traced(runs, "trace_a"), _traced(runs, "trace_b")
    ra, rb = ptrace.analyze_dir(a), ptrace.analyze_dir(b)
    for top in (1, 3, 10):
        assert ptrace.top_deltas(ra["phase_breakdown_ms"],
                                 rb["phase_breakdown_ms"], top) == \
            jtrace.top_deltas(ra["phase_breakdown_ms"],
                              rb["phase_breakdown_ms"], top)
    snap = tmp_path / "a.json"
    snap.write_text(json.dumps(ra))
    for argv in (["diff", a, b], ["diff", str(snap), b],
                 ["diff", a, str(tmp_path / "missing")]):
        got, want = _cli(ptrace.main, argv), _cli(jtrace.main, argv)
        assert got[:2] == want[:2], argv
    assert _cli(ptrace.main, ["diff", a, b])[0] == 0


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["kill", "stall"])
def test_postmortem_names_the_same_first_cause(runs, name):
    gang, d = runs[name]
    for r in (0, 1):
        assert gang[r][0] == 0, (r, gang[r][1][-3000:])
    verdict = ppm.analyze(d)
    assert verdict == jpm.analyze(d)
    assert verdict["first_cause"] == 2, verdict
    for argv in ([d], [d, "--json"]):
        got, want = _cli(ppm.main, argv), _cli(jpm.main, argv)
        assert got == want and got[0] == 0, argv


@pytest.mark.timeout(60)
def test_postmortem_of_an_empty_directory(tmp_path):
    assert ppm.analyze(str(tmp_path)) is None is jpm.analyze(str(tmp_path))
    got = _cli(ppm.main, [str(tmp_path)])
    assert got[0] == 1 == _cli(jpm.main, [str(tmp_path)])[0]


@pytest.fixture
def gang_view():
    """A port aggregator's fold of three ranks' records (rank 2 lagging,
    so that an alert names it), served by the port's debug server."""
    from horovod_tpu_torch.telemetry import aggregate as pagg
    from horovod_tpu_torch.telemetry import registry as preg
    from horovod_tpu_torch.telemetry import server as pserver

    class KV:
        def __init__(self, data):
            self.data = data

        def get(self, key):
            return self.data.get(key)

        def put(self, key, value):
            pass

    def record(rank, step):
        reg = preg.Registry()
        reg.inc_counter("hvd_collectives_total", float(100 * step),
                        ("allreduce", "float32"))
        reg.inc_counter("hvd_cycles_total", float(10 * step + rank))
        reg.set_gauge("hvd_queue_depth", float(rank))
        for i in range(step):
            reg.observe("hvd_collective_latency_seconds",
                        0.002 * (1 + (i + rank) % 5),
                        ("allreduce", "float32"))
        if rank == 0:
            reg.observe("hvd_straggler_skew_seconds", 0.5, ("2",))
        return {"rank": rank, "seq": step, "epoch": 0, **reg.snapshot()}

    preg.configure(True)
    data = {}
    agg = pagg.GangAggregator(3, kv=KV(data), interval_s=999.0)
    for step, now in ((2, 1.0), (6, 2.0)):
        for r in range(3):
            data[f"metrics/{r}"] = json.dumps(
                record(r, step if r < 2 else 2))
        agg.poll_once(now=now)
    pagg.configure(agg)
    srv = pserver.MetricsServer(host="127.0.0.1", port=0)
    port = srv.start()
    try:
        yield f"127.0.0.1:{port}"
    finally:
        srv.stop()
        pagg.configure(None)
        preg.configure(False)


@pytest.mark.timeout(60)
def test_top_once_equal_jax(gang_view):
    for flags in (["--once", "--json"], ["--once"]):
        argv = ["--addr", gang_view, *flags]
        got, want = _cli(ptop.main, argv), _cli(jtop.main, argv)
        assert got == want and got[0] == 0, flags
    view = json.loads(_cli(ptop.main, ["--addr", gang_view, "--once",
                                       "--json"])[1])
    assert view["ranks"] == [0, 1, 2]
    assert ptop.render(view) == jtop.render(view)


@pytest.mark.timeout(60)
def test_top_without_a_server_exits_1():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    argv = ["--addr", addr, "--once", "--json"]
    got, want = _cli(ptop.main, argv), _cli(jtop.main, argv)
    assert got[0] == want[0] == 1
    assert got[1] == want[1] == ""
