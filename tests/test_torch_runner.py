"""The port's launcher modules (``horovod_tpu_torch/runner``) against the
JAX package's on the same inputs.

Parametrised parity cases: ``parse_hosts``, ``parse_hostfile`` and
``allocate`` (uneven, too few, zero-slot and duplicate hosts),
``HostBlacklist``, the flags and the YAML file as ``HVD_*`` variables
(``env_from_args``, ``env_from_config_file``: the serve, metrics,
ctrl-fanout and kv flags among them), the command line's exit-2
validations, the ``mpirun`` and ``jsrun`` commands (identical but for the
package's name in the task command), the MPI version classification, the
MPI/PMIx/PMI/Slurm/JSM discovery (and ``hvd.init``'s discovery reading it),
the LSF host lists.  Then the port's own: the ssh check with a fake ``ssh``
on ``PATH`` (the unreachable host named, the cache, a stale cache, failures
not cached, the launch failing before any spawn), the NIC probe ring (a
port agent process beside a JAX agent, intersected by the port's
launcher side, and ``probe_common_nics``), HMAC auth on the port's KV server
(the JAX package's client signs alike), the mirror's write-through and
delete (fenced alike on the standby) with ``/kvsync`` and ``sync_from``,
the ssh command keeping the secret off argv and forwarding the GPU stack's
variables, ``worker_env``'s ``PYTHONPATH``, and ``--check-build`` naming
the port's parts.
"""

import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from horovod_tpu.runner import config_parser as jcp
from horovod_tpu.runner import discovery as jdisc
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import lsf as jlsf
from horovod_tpu.runner import mpi as jmpi
from horovod_tpu.runner import run as jrun

from horovod_tpu_torch.runner import config_parser as pcp
from horovod_tpu_torch.runner import discovery as pdisc
from horovod_tpu_torch.runner import hosts as phosts
from horovod_tpu_torch.runner import lsf as plsf
from horovod_tpu_torch.runner import mpi as pmpi
from horovod_tpu_torch.runner import run as prun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tuples(xs):
    return [tuple(vars(x).values()) for x in xs]


def _both(fn_j, fn_p, *args):
    """Each package's result, or the error's type and text."""
    out = []
    for fn in (fn_j, fn_p):
        try:
            out.append(("ok", fn(*args)))
        except Exception as e:  # the comparison is the assertion
            out.append(("err", type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------------------
# hosts
# ---------------------------------------------------------------------------

HOST_STRINGS = ["hostA:2,hostB:4", "h", "[::1]:2", " a:1, b:3 ,",
                "10.0.0.1:8,10.0.0.2", "bad host", "", "a:x"]


@pytest.mark.parametrize("spec", HOST_STRINGS)
def test_parse_hosts_matches_jax(spec):
    j, p = _both(lambda s: _tuples(jhosts.parse_hosts(s)),
                 lambda s: _tuples(phosts.parse_hosts(s)), spec)
    assert j == p


HOSTFILES = {
    "mpirun": "hostA slots=2\nhostB slots=4\n",
    "colon": "# comment\nhostA:2\n\nhostB  # trailing\n",
    "mixed": "a slots = 3\nb:1,c:2\n",
    "empty": "# nothing\n\n",
}


@pytest.mark.parametrize("case", sorted(HOSTFILES))
def test_parse_hostfile_matches_jax(case, tmp_path):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES[case])
    j, p = _both(lambda f: _tuples(jhosts.parse_hostfile(f)),
                 lambda f: _tuples(phosts.parse_hostfile(f)), str(path))
    assert j == p


ALLOCATIONS = {
    "single": ([("localhost", 4)], 4),
    "multi": ([("a", 2), ("b", 2)], 4),
    "uneven": ([("a", 3), ("b", 1)], 4),
    "too_few": ([("a", 1), ("b", 1)], 3),
    "extra_unused": ([("a", 4), ("b", 4)], 5),
    "zero_slot": ([("a", 0), ("b", 2)], 2),
    "duplicate": ([("a", 1), ("b", 1), ("a", 1)], 3),
}


@pytest.mark.parametrize("case", sorted(ALLOCATIONS))
def test_allocate_matches_jax(case):
    spec, np_ = ALLOCATIONS[case]
    j, p = _both(
        lambda: _tuples(jhosts.allocate(
            [jhosts.HostSlots(h, n) for h, n in spec], np_)),
        lambda: _tuples(phosts.allocate(
            [phosts.HostSlots(h, n) for h, n in spec], np_)))
    assert j == p
    if case == "too_few":
        assert p[0] == "err"


def test_host_blacklist_matches_jax():
    def trace(mod):
        bl = mod.HostBlacklist(threshold=2, cooldown_s=10.0)
        hosts = [mod.HostSlots("a", 2), mod.HostSlots("b", 2)]
        seen = []
        for now, host in ((0.0, "a"), (1.0, "a"), (2.0, "b")):
            bl.record_failure(host, now=now)
            seen.append((bl.failure_count("a", now=now),
                         bl.is_blacklisted("a", now=now),
                         bl.is_blacklisted("b", now=now)))
        seen.append(_tuples(bl.filter_hosts(hosts, 2)))
        seen.append(_tuples(bl.filter_hosts(hosts, 4)))  # too few: all
        seen.append(bl.is_blacklisted("a", now=20.0))  # cooled down
        return seen

    assert trace(phosts) == trace(jhosts)


# ---------------------------------------------------------------------------
# flags and config file as HVD_* variables
# ---------------------------------------------------------------------------

ARGVS = {
    "serve": ["--serve-port", "8100", "--serve-max-batch", "4",
              "--serve-max-queue", "32"],
    "metrics": ["--metrics-port", "9100"],
    "ctrl_fanout": ["--ctrl-fanout", "4", "--collective-timeout", "2.5"],
    "kv": ["--kv-addrs", "127.0.0.1:1,127.0.0.1:2"],
    "kv_standbys": ["--kv-standbys", "1"],
    "tunables": ["--fusion-threshold-mb", "32", "--cycle-time-ms", "2",
                 "--cache-capacity", "0", "--hierarchical-allreduce",
                 "--ring-segment-bytes", "65536", "--no-shm",
                 "--shm-slots", "8"],
    "disable_cache": ["--disable-cache"],
    "timeline": ["--timeline-filename", "/tmp/t.json",
                 "--timeline-mark-cycles", "--no-stall-check",
                 "--stall-warning-time-seconds", "30"],
    "autotune": ["--autotune", "--autotune-log-file", "at.csv",
                 "--log-level", "DEBUG", "--adasum-mode", "gpu"],
    "elastic": ["--min-np", "1", "--max-np", "4",
                "--host-discovery-script", "./d.sh"],
    "unset": [],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_env_from_args_matches_jax(case):
    argv = ["-np", "2"] + ARGVS[case] + ["python", "x.py"]
    want = jcp.env_from_args(jrun.make_parser().parse_args(argv))
    got = pcp.env_from_args(prun.make_parser().parse_args(argv))
    assert got == want
    assert pcp._ARG_ENV == jcp._ARG_ENV
    if case == "serve":
        assert got == {"HVD_SERVE_PORT": "8100", "HVD_SERVE_MAX_BATCH": "4",
                       "HVD_SERVE_MAX_QUEUE": "32"}


def test_env_from_config_file_matches_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("fusion-threshold-mb: 16\nautotune: true\n"
                    "no_shm: 0\nserve-max-batch: 8\nmetrics_port: 9000\n")
    assert pcp.env_from_config_file(str(path)) == \
        jcp.env_from_config_file(str(path))
    path.write_text("not-a-flag: 1\n")
    with pytest.raises(ValueError, match="unknown config key"):
        pcp.env_from_config_file(str(path))


# ---------------------------------------------------------------------------
# the command line's exit-2 validations
# ---------------------------------------------------------------------------

INVALID = {
    "no_command": (["-np", "1"], "no command"),
    "max_restarts_negative": (["--max-restarts", "-1"], "--max-restarts"),
    "max_restarts_jsrun": (["--max-restarts", "1", "--launcher", "jsrun"],
                            "--max-restarts"),
    "metrics_port": (["--metrics-port", "0"], "--metrics-port"),
    "serve_port_low": (["--serve-port", "0"], "--serve-port"),
    "serve_port_high": (["--serve-port", "70000"], "--serve-port"),
    "serve_max_batch": (["--serve-max-batch", "0"], "--serve-max-batch"),
    "serve_max_queue": (["--serve-max-queue", "-2"], "--serve-max-queue"),
    "kv_standbys": (["--kv-standbys", "3"], "--kv-standbys"),
    "kv_both": (["--kv-standbys", "1", "--kv-addrs", "h:1"], "--kv-addrs"),
    "kv_addrs_bad": (["--kv-addrs", "nohostport"], "--kv-addrs"),
    "ring_segment": (["--ring-segment-bytes", "-1"], "--ring-segment-bytes"),
    "ctrl_fanout": (["--ctrl-fanout", "-3"], "--ctrl-fanout"),
    "shm_slot_bytes": (["--shm-slot-bytes", "100"], "--shm-slot-bytes"),
    "shm_slots": (["--shm-slots", "1"], "--shm-slots"),
    "min_np_zero": (["--min-np", "0"], "--min-np"),
    "min_np_above": (["--min-np", "3"], "--min-np"),
    "max_np_below": (["--max-np", "1"], "--max-np"),
    "discovery_script": (["--host-discovery-script", "/nonexistent/d.sh"],
                         "--host-discovery-script"),
    "elastic_jsrun": (["--min-np", "1", "--launcher", "jsrun"],
                      "elastic flags"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_cli_validation_exit_2_matches_jax(case, capsys):
    extra, flag = INVALID[case]
    argv = (extra if case == "no_command"
            else ["-np", "2"] + extra + ["python", "-c", "pass"])
    assert jrun.run_commandline(list(argv)) == 2
    capsys.readouterr()
    assert prun.run_commandline(list(argv)) == 2
    err = capsys.readouterr().err
    assert flag in err and err.startswith("hvdrun-torch:"), err


def test_cli_adasum_mode_warns_that_it_changes_nothing(capsys):
    """``--adasum-mode`` is parsed (``env_from_args`` parity) but nothing
    in the port reads it: the launcher says so before it launches."""
    rc = prun.run_commandline(["-np", "2", "--adasum-mode", "gpu",
                               "--min-np", "0", "python", "-c", "pass"])
    assert rc == 2  # stopped by the --min-np check, after the warning
    err = capsys.readouterr().err
    assert "--adasum-mode 'gpu' has no effect" in err, err
    assert "--adasum-mode" in prun.make_parser().format_help()


def test_cli_mpirun_without_mpi_exits_2(capsys):
    if shutil.which("mpirun"):
        pytest.skip("mpirun is on PATH: the error path is not reachable")
    rc = prun.run_commandline(["-np", "2", "--launcher", "mpirun", "--",
                               "python", "-c", "pass"])
    assert rc == 2
    assert "no usable mpirun" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# mpirun / jsrun commands, MPI versions, LSF hosts
# ---------------------------------------------------------------------------


def _slots(mod, spec):
    out, rank = [], 0
    total = sum(n for _, n in spec)
    for h, n in spec:
        for lr in range(n):
            out.append(mod.SlotInfo(h, rank, total, lr, n, 0, 1))
            rank += 1
    return out


MPI_CASES = {
    "openmpi": dict(np=4, spec=[("hostA", 2), ("hostB", 2)],
                    names=["HVD_RENDEZVOUS_ADDR", "HVD_SECRET_KEY"],
                    impl="openmpi", nics=["eth0"], ssh_port=2222,
                    ssh_identity_file="/keys/id"),
    "openmpi_large": dict(np=128, spec=[(f"h{i}", 8) for i in range(16)],
                          names=[], impl="openmpi"),
    "mpich": dict(np=2, spec=[("a", 1), ("b", 1)],
                  names=["HVD_RENDEZVOUS_ADDR", "HVD_RENDEZVOUS_PORT"],
                  impl="mpich", nics=["ib0"]),
    "mpich_ssh_refused": dict(np=2, spec=[("a", 1), ("b", 1)], names=[],
                              impl="mpich", ssh_port=2222),
    "unknown_impl": dict(np=1, spec=[("a", 1)], names=[], impl="lam"),
}


@pytest.mark.parametrize("case", sorted(MPI_CASES))
def test_mpirun_command_matches_jax(case):
    c = dict(MPI_CASES[case])
    spec, np_, names = c.pop("spec"), c.pop("np"), c.pop("names")

    def build(mod, hosts_mod, pkg):
        return mod.mpirun_command(
            np_, _slots(hosts_mod, spec),
            [sys.executable, "-m", f"{pkg}.runner.run_task"],
            env_var_names=names, **c)

    j, p = _both(lambda: build(jmpi, jhosts, "horovod_tpu"),
                 lambda: build(pmpi, phosts, "horovod_tpu_torch"))
    if j[0] == "ok":
        assert p[0] == "ok"
        assert p[1][:-1] == j[1][:-1]
        assert p[1][-1] == "horovod_tpu_torch.runner.run_task"
        assert j[1][-1] == "horovod_tpu.runner.run_task"
    else:
        assert p == j


@pytest.mark.parametrize("cpus", [1, 4])
def test_jsrun_command_matches_jax(cpus):
    assert plsf.jsrun_command(8, ["python", "train.py"], cpus_per_task=cpus,
                              extra_args=["--bind", "rs"]) == \
        jlsf.jsrun_command(8, ["python", "train.py"], cpus_per_task=cpus,
                           extra_args=["--bind", "rs"])


@pytest.mark.parametrize("text", [
    "mpirun (Open MPI) 4.1.4", "OpenRTE 2.1.1",
    "HYDRA build details:\n  Version: 4.0",
    "Intel(R) MPI Library for Linux* OS", "MVAPICH2 2.3", "not an mpi"])
def test_mpi_version_classification_matches_jax(text):
    assert pmpi.classify_mpi_version(text) == jmpi.classify_mpi_version(text)


LSF_ENVS = {
    "mcpu": {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "batch1 1 node1 4 node2 4"},
    "hostfile": {"LSB_JOBID": "1",
                 "LSB_DJOB_HOSTFILE": "batch1\nnode1\nnode1\nnode2\n"},
    "one_host": {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "solo 2"},
    "none": {},
}


@pytest.mark.parametrize("case", sorted(LSF_ENVS))
def test_lsf_hosts_match_jax(case, monkeypatch, tmp_path):
    for k in ("LSB_JOBID", "LSB_MCPU_HOSTS", "LSB_DJOB_HOSTFILE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in LSF_ENVS[case].items():
        if k == "LSB_DJOB_HOSTFILE":
            (tmp_path / "hf").write_text(v)
            v = str(tmp_path / "hf")
        monkeypatch.setenv(k, v)
    assert plsf.in_lsf_job() == jlsf.in_lsf_job()
    assert _tuples(plsf.lsf_hosts()) == _tuples(jlsf.lsf_hosts())


# ---------------------------------------------------------------------------
# MPI-style discovery, and hvd.init's discovery reading it
# ---------------------------------------------------------------------------

_LAUNCHER_VARS = [v for schema in jdisc._MPI_SCHEMAS for v in schema if v] \
    + ["HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_LOCAL_SIZE",
       "HVD_CROSS_RANK", "HVD_CROSS_SIZE", "RANK", "WORLD_SIZE",
       "LOCAL_RANK", "LOCAL_WORLD_SIZE"]

MPI_ENVS = {
    "openmpi": {"OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_SIZE": "8",
                "OMPI_COMM_WORLD_LOCAL_RANK": "1",
                "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
    "openmpi_by_node": {"OMPI_COMM_WORLD_RANK": "1",
                        "OMPI_COMM_WORLD_SIZE": "4",
                        "OMPI_COMM_WORLD_LOCAL_RANK": "0",
                        "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
    "jsm": {"JSM_NAMESPACE_RANK": "2", "JSM_NAMESPACE_SIZE": "4",
            "JSM_NAMESPACE_LOCAL_RANK": "0",
            "JSM_NAMESPACE_LOCAL_SIZE": "2"},
    "pmix": {"PMIX_RANK": "3", "PMIX_SIZE": "6", "PMIX_LOCAL_RANK": "0",
             "PMIX_LOCAL_SIZE": "3"},
    "pmi": {"PMI_RANK": "2", "PMI_SIZE": "3"},
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "4", "SLURM_LOCALID": "1",
              "SLURM_NTASKS_PER_NODE": "2"},
    "malformed": {"PMI_RANK": "x", "PMI_SIZE": "3"},
    "zero_size": {"SLURM_PROCID": "0", "SLURM_NTASKS": "0"},
    "none": {},
}


@pytest.mark.parametrize("case", sorted(MPI_ENVS))
def test_mpi_env_discovery_matches_jax(case, monkeypatch):
    from horovod_tpu_torch import basics

    for k in _LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in MPI_ENVS[case].items():
        monkeypatch.setenv(k, v)
    want = jdisc.from_mpi_env()
    got = pdisc.from_mpi_env()
    assert (got and tuple(vars(got).values())) == \
        (want and tuple(vars(want).values()))
    assert pdisc.discover() == got
    # hvd.init()'s discovery: the launcher's coordinates, else one rank.
    found = basics._discover(None, None, None, None)
    assert found == (tuple(vars(got).values()) if got
                     else (0, 1, 0, 1, 0, 1))


def test_block_topology_ok_matches_jax():
    cases = [(r, s, lr, ls, cr, cs) for s, ls in ((4, 2), (6, 3), (4, 1),
                                                    (4, 4), (5, 2))
             for r in range(s) for lr in (r % ls, 0) for cr, cs in
             ((r // ls, s // ls), (0, 1))]
    assert [pdisc.block_topology_ok(*c) for c in cases] == \
        [jdisc.block_topology_ok(*c) for c in cases]


# ---------------------------------------------------------------------------
# ssh pre-checks with a fake ssh
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_ssh(tmp_path, monkeypatch):
    """A fake ``ssh`` first on PATH: it succeeds for hosts that start with
    'good' and fails otherwise, logging every probed host."""
    log = tmp_path / "ssh_calls.log"
    shim = tmp_path / "bin" / "ssh"
    shim.parent.mkdir()
    shim.write_text(
        "#!/bin/sh\n"
        "host=''\n"
        "prev=''\n"
        "for a in \"$@\"; do\n"
        "  case \"$a\" in -*) ;; true) host=$prev ;; *) prev=$a ;; esac\n"
        "done\n"
        f"echo \"$host\" >> {log}\n"
        "case \"$host\" in good*) exit 0 ;; "
        "*) echo unreachable >&2; exit 255 ;; esac\n")
    shim.chmod(0o755)
    monkeypatch.setenv("PATH", f"{shim.parent}:{os.environ['PATH']}")
    monkeypatch.setenv("HVD_CACHE_DIR", str(tmp_path / "cache"))
    return log


def _calls(log):
    return log.read_text().split() if log.exists() else []


def test_ssh_check_unreachable_host_named(fake_ssh):
    from horovod_tpu_torch.runner import ssh_check

    with pytest.raises(ssh_check.SSHUnreachableError) as ei:
        ssh_check.check_hosts_ssh(["goodhost1", "badhost1"], timeout=20)
    assert "badhost1" in str(ei.value)
    assert "goodhost1" not in str(ei.value)


def test_ssh_check_cache_skips_within_window(fake_ssh):
    from horovod_tpu_torch.runner import ssh_check

    cache = ssh_check.LaunchCache("t1")
    ssh_check.check_hosts_ssh(["goodhost1", "goodhost2"], cache=cache,
                              timeout=20)
    ssh_check.check_hosts_ssh(["goodhost1", "goodhost2"], cache=cache,
                              timeout=20)
    assert sorted(_calls(fake_ssh)) == ["goodhost1", "goodhost2"]
    ssh_check.check_hosts_ssh(["goodhost1"], cache=None, timeout=20)
    assert sorted(_calls(fake_ssh)) == ["goodhost1", "goodhost1",
                                        "goodhost2"]


def test_ssh_check_stale_cache_reprobes(fake_ssh):
    from horovod_tpu_torch.runner import ssh_check

    cache = ssh_check.LaunchCache("t2", staleness_minutes=0.0)
    ssh_check.check_hosts_ssh(["goodhost1"], cache=cache, timeout=20)
    ssh_check.check_hosts_ssh(["goodhost1"], cache=cache, timeout=20)
    assert _calls(fake_ssh) == ["goodhost1", "goodhost1"]


def test_ssh_check_failure_not_cached(fake_ssh):
    from horovod_tpu_torch.runner import ssh_check

    cache = ssh_check.LaunchCache("t3")
    for _ in range(2):
        with pytest.raises(ssh_check.SSHUnreachableError):
            ssh_check.check_hosts_ssh(["badhost1"], cache=cache, timeout=20)
    assert _calls(fake_ssh) == ["badhost1", "badhost1"]


def test_params_hash_matches_jax():
    from horovod_tpu.runner import ssh_check as jssh

    from horovod_tpu_torch.runner import ssh_check as pssh

    for args in ((2, "a:2", None), (4, "h", 22, "/k/id")):
        assert pssh.params_hash(*args) == jssh.params_hash(*args)


def test_launcher_fails_fast_before_spawn(fake_ssh):
    """An unreachable remote host fails the launch on the named ssh error
    before any worker is spawned (the command would leave a file)."""
    from horovod_tpu_torch.runner.ssh_check import SSHUnreachableError

    sentinel = str(fake_ssh) + ".spawned"
    with pytest.raises(SSHUnreachableError) as ei:
        prun.run_commandline(["-np", "2", "-H", "badhost9:2",
                              "--start-timeout", "5", "--", "touch",
                              sentinel])
    assert "badhost9" in str(ei.value)
    assert not os.path.exists(sentinel)


# ---------------------------------------------------------------------------
# the NIC probe ring
# ---------------------------------------------------------------------------


def test_nic_probe_ring_port_agent_beside_jax_agent():
    """A port agent (``python -m horovod_tpu_torch.runner.nic_probe``) and
    a JAX package's agent in one ring against the port's signed KV server;
    the port's launcher side intersects their reports."""
    from horovod_tpu.runner.http_client import KVClient as JKV
    from horovod_tpu.runner.nic_probe import run_agent as jrun_agent

    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_client import KVClient
    from horovod_tpu_torch.runner.http_server import RendezvousServer
    from horovod_tpu_torch.runner.nic_probe import (common_interfaces,
                                                    enumerate_interfaces)

    assert enumerate_interfaces().get("lo") == "127.0.0.1"
    s = secret_mod.make_secret()
    server = RendezvousServer("127.0.0.1", secret=s)
    port = server.start()
    try:
        agent0 = threading.Thread(
            target=jrun_agent, args=(0, 2, JKV("127.0.0.1", port, secret=s)),
            kwargs={"probe_timeout": 2.0, "wait_timeout": 30.0},
            daemon=True)
        agent0.start()
        env = dict(os.environ, HVD_RANK="1", HVD_SIZE="2",
                   HVD_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_RENDEZVOUS_PORT=str(port), **{secret_mod.ENV_VAR: s})
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.nic_probe"],
            env=env, stdout=subprocess.PIPE, text=True)
        common = common_interfaces(KVClient("127.0.0.1", port, secret=s), 2,
                                   wait_timeout=30.0)
        agent0.join(timeout=10)
        out, _ = proc.communicate(timeout=30)
    finally:
        server.stop()
    assert proc.returncode == 0 and "routable" in out, out
    assert "lo" in common
    assert common[-1] == "lo" or len(common) == 1


@pytest.mark.timeout(60)
def test_probe_common_nics_spawns_agents():
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    s = secret_mod.make_secret()
    server = RendezvousServer("127.0.0.1", secret=s)
    port = server.start()
    try:
        common = prun.probe_common_nics(["localhost", "127.0.0.1"],
                                        "127.0.0.1", port, s,
                                        wait_timeout=45.0)
    finally:
        server.stop()
    assert "lo" in common


def test_interface_address():
    assert prun.interface_address("lo") == "127.0.0.1"
    assert prun.interface_address("definitely-not-a-nic") is None
    assert prun.interface_address_any("definitely-not-a-nic,lo") == \
        "127.0.0.1"
    assert prun.interface_address_any("") is None
    with pytest.raises(ValueError, match="network-interface"):
        prun.interface_address_any("definitely-not-a-nic")


# ---------------------------------------------------------------------------
# the KV server: HMAC auth, mirroring, /kvsync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_rendezvous_hmac_auth(client_pkg, monkeypatch):
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    if client_pkg == "port":
        from horovod_tpu_torch.runner.http_client import KVClient
    else:
        from horovod_tpu.runner.http_client import KVClient

    monkeypatch.delenv(secret_mod.ENV_VAR, raising=False)
    s = secret_mod.make_secret()
    server = RendezvousServer("127.0.0.1", secret=s)
    port = server.start()
    try:
        good = KVClient("127.0.0.1", port, secret=s)
        good.put("k", "v")
        assert good.get("k") == "v"
        for bad in (KVClient("127.0.0.1", port),
                    KVClient("127.0.0.1", port, secret="deadbeef")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                bad.put("k", "poison")
            assert ei.value.code == 403
        assert good.get("k") == "v"
        # A signature for other content: refused.
        req = urllib.request.Request(f"http://127.0.0.1:{port}/kv/k",
                                     data=b"tampered", method="PUT")
        req.add_header(secret_mod.HEADER,
                       secret_mod.sign(s, "PUT", "/kv/k", b"original"))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 403
        for path in ("/kvsync", "/kvlist/"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                       timeout=5)
            assert ei.value.code == 403
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=5) as r:
            assert r.read() == b"ok"
    finally:
        server.stop()


@pytest.mark.parametrize("primary_pkg", ["port", "jax"])
def test_mirror_write_through_and_delete(primary_pkg, monkeypatch):
    """Every accepted PUT and DELETE reaches the standby, signed and with
    its epoch header, so that the standby fences a stale elastic write as
    the primary does; a dropped forward (``kv.mirror``) leaves the primary
    ahead, and the standby's ``sync_from`` repairs it."""
    from horovod_tpu_torch.common import fault_injection as fi
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_client import KVClient
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    if primary_pkg == "port":
        Primary = RendezvousServer
    else:
        from horovod_tpu.runner.http_server import RendezvousServer as Primary

    monkeypatch.delenv(secret_mod.ENV_VAR, raising=False)
    monkeypatch.delenv("HVD_KV_ADDRS", raising=False)
    s = secret_mod.make_secret()
    standby = RendezvousServer("127.0.0.1", secret=s)
    sport = standby.start()
    primary = Primary("127.0.0.1", secret=s,
                      mirrors=[("127.0.0.1", sport)])
    pport = primary.start()
    fi.clear()
    try:
        kv = KVClient("127.0.0.1", pport, secret=s)
        kv.put("a", "1")
        kv.put("scope/elastic/world/2", "[]")
        kv.put("gone", "x")
        kv.delete("gone")
        assert standby.get("a") == b"1"
        assert standby.get("gone") is None
        assert standby.get("scope/elastic/world/2") == b"[]"
        # The epoch header travelled: a write of an older epoch is fenced
        # on the standby as on the primary.
        monkeypatch.setenv("HVD_ELASTIC_EPOCH", "3")
        kv.put("scope/elastic/world/3", "[1]")
        skv = KVClient("127.0.0.1", sport, secret=s)
        monkeypatch.setenv("HVD_ELASTIC_EPOCH", "1")
        with pytest.raises(Exception, match="fenced|stale|409"):
            skv.put("scope/elastic/world/1", "zombie")
        monkeypatch.delenv("HVD_ELASTIC_EPOCH")
        # A dropped forward: the primary is ahead until the catch-up.
        if primary_pkg == "port":
            fi.configure({"faults": [{"site": "kv.mirror", "kind": "drop"}]})
        else:
            from horovod_tpu.common import fault_injection as jfi

            jfi.configure({"faults": [{"site": "kv.mirror",
                                       "kind": "drop"}]})
        kv.put("late", "2")
        assert standby.get("late") is None
        assert standby.sync_from("127.0.0.1", pport)
        assert standby.get("late") == b"2" and standby.get("a") == b"1"
        assert primary.get("late") == b"2"
        assert standby.sync_from("127.0.0.1", 1, timeout=0.5) is False
        assert standby.get("late") == b"2"
    finally:
        fi.clear()
        from horovod_tpu.common import fault_injection as jfi

        jfi.clear()
        primary.stop()
        standby.stop()


def test_http_server_cli_mirrors_to_a_standby(tmp_path):
    """``python -m horovod_tpu_torch.runner.http_server``: a primary that
    syncs from one server at start and mirrors to another."""
    from horovod_tpu_torch.runner.http_client import KVClient
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    seed = RendezvousServer("127.0.0.1")
    seed_port = seed.start()
    standby = RendezvousServer("127.0.0.1")
    sport = standby.start()
    env = {k: v for k, v in os.environ.items()
           if k not in ("HVD_SECRET_KEY", "HVD_KV_ADDRS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port_file = tmp_path / "port"
    proc = None
    try:
        KVClient("127.0.0.1", seed_port).put("seeded", "yes")
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.http_server",
             "--port-file", str(port_file), "--mirror",
             f"127.0.0.1:{sport}", "--sync-from", f"127.0.0.1:{seed_port}"],
            env=env, stdout=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 30
        while not port_file.exists() and time.monotonic() < deadline:
            time.sleep(0.02)
        port = int(port_file.read_text())
        kv = KVClient("127.0.0.1", port)
        assert kv.get("seeded") == "yes"
        kv.put("k", "v")
        assert standby.get("k") == b"v"
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
        assert proc.returncode == 0 and f"KV 127.0.0.1:{port}" in out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        seed.stop()
        standby.stop()


# ---------------------------------------------------------------------------
# spawning: the ssh command and the worker's environment
# ---------------------------------------------------------------------------


def test_remote_command_forwards_the_gpu_stack_and_hides_the_secret():
    from horovod_tpu_torch.runner.launch import _remote_command

    env = {"HVD_RANK": "0", "HVD_SECRET_KEY": "s3cr3t",
           "CUDA_VISIBLE_DEVICES": "0,1", "NCCL_DEBUG": "INFO",
           "TORCH_CUDA_ARCH_LIST": "9.0a", "PYTHONPATH": "/src",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "-x", "HOME": "/home/u"}
    remote, payload = _remote_command(env, ["python", "train.py"])
    assert "s3cr3t" not in remote
    assert "read -rs" in remote and "HVD_SECRET_KEY" in remote
    assert payload == "s3cr3t\n"
    for kv in ("HVD_RANK=0", "CUDA_VISIBLE_DEVICES=0,1", "NCCL_DEBUG=INFO",
               "TORCH_CUDA_ARCH_LIST=9.0a", "PYTHONPATH=/src"):
        assert kv in remote, kv
    for name in ("JAX_PLATFORMS", "XLA_FLAGS", "HOME"):
        assert name not in remote
    remote, payload = _remote_command({"HVD_RANK": "1"}, ["prog"])
    assert payload is None and "read" not in remote


def test_worker_env_puts_the_port_on_pythonpath(monkeypatch):
    import horovod_tpu_torch
    from horovod_tpu_torch.runner.launch import worker_env

    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    slot = phosts.SlotInfo("localhost", 1, 2, 1, 2, 0, 1)
    env = worker_env(slot, "10.0.0.1", 1234, {"HVD_SERVE_MAX_BATCH": "8"})
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(horovod_tpu_torch.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep) == [root, "/elsewhere"]
    assert (env["HVD_RANK"], env["HVD_SIZE"], env["HVD_LOCAL_RANK"],
            env["HVD_RENDEZVOUS_ADDR"], env["HVD_RENDEZVOUS_PORT"],
            env["HVD_SERVE_MAX_BATCH"]) == ("1", "2", "1", "10.0.0.1",
                                            "1234", "8")


# ---------------------------------------------------------------------------
# --check-build
# ---------------------------------------------------------------------------


def test_check_build_names_the_ports_parts(capsys):
    import torch

    with pytest.raises(SystemExit) as e:
        prun.run_commandline(["--check-build"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("horovod_tpu_torch v")
    assert f"[X] PyTorch {torch.__version__}" in out
    card = torch.cuda.is_available()
    assert ("[X] NVIDIA card" if card else "[ ] NVIDIA card") in out
    assert "nvcc" in out and "flash attention" in out
    assert "[X] Python engine" in out
    # The native core and the dispatcher ops: built, or buildable from
    # the port's own csrc/ with the C++ compiler this box has.
    from horovod_tpu_torch.common import native_build

    for row in ("native C++ core (the default)",
                "PyTorch dispatcher ops (torch.ops.hvd.*)"):
        line = next(x for x in out.splitlines() if row in x)
        assert line.lstrip().startswith("[X]"), line
        assert "built: " in line or native_build.CSRC_DIR in line, line
    assert "SIMD wire codecs (AVX2 + F16C)" in out
    assert "not ported" not in out
    # The other frameworks, found (not imported), and the TensorFlow
    # kernels: built, buildable from the port's csrc/, or TensorFlow
    # missing.
    import importlib.util

    for fw, mod in (("TensorFlow", "tensorflow"), ("Keras", "keras"),
                    ("MXNet", "mxnet")):
        have = importlib.util.find_spec(mod) is not None
        assert f"[{'X' if have else ' '}] {fw}\n" in out, fw
    line = next(x for x in out.splitlines()
                if "TensorFlow custom kernels (HvdAllreduce/...)" in x)
    if importlib.util.find_spec("tensorflow") is None:
        assert line.lstrip().startswith("[ ]"), line
    else:
        assert line.lstrip().startswith("[X]"), line
        assert "libhvd_tf_ops_" in line or native_build.CSRC_DIR in line, \
            line
    # No row claims a part the port does not have.
    for absent in ("JAX", "XLA"):
        assert f"] {absent}" not in out


def test_check_build_imports_no_tensorflow():
    """``--check-build`` finds TensorFlow, Keras and MXNet without
    importing them, and the launcher's modules import neither torch nor
    tensorflow: the launcher stays fast."""
    code = ("import sys\n"
            "import horovod_tpu_torch.runner.run as run\n"
            "import horovod_tpu_torch.runner.launch\n"
            "before = sorted(m for m in ('torch', 'tensorflow', 'keras')\n"
            "                if m in sys.modules)\n"
            "out = run.check_build()\n"
            "print(before, sorted(m for m in ('tensorflow', 'keras', "
            "'mxnet') if m in sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=100, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[] []", res.stdout
