"""``hvdrun`` for the port: the launcher's command line and the
programmatic ``run()``, the port of ``horovod_tpu/runner/run.py``.

Usage::

    python -m horovod_tpu_torch.runner.run -np 4 -- python train.py
    hvdrun-torch -np 8 -H hostA:4,hostB:4 -- python train.py
    python -m horovod_tpu_torch.runner.run -np 3 --min-np 2 \\
        --serve-max-batch 8 --kv-standbys 1 -- python serve.py

    from horovod_tpu_torch.runner import run
    results = run.run(train_fn, np=4, device="cpu")  # each rank's return

The launcher starts the rendezvous KV server (HMAC-signed with a per-job
secret) and spawns one worker per slot, locally or through ssh, with the
``HVD_*`` variables of its rank; ``--launcher mpirun``/``jsrun`` hand the
fan-out to MPI or LSF instead.  By default the first failed worker fails
the job; ``--max-restarts`` relaunches the gang (skipping blacklisted
hosts), and the elastic flags (``--min-np``, ``--max-np``,
``--host-discovery-script``) let the gang re-form in process
(``elastic/run.py``), the job failing only when fewer than ``--min-np``
workers finish cleanly.  ``--serve-*`` set the ``HVD_SERVE_*`` knobs of
``serving.ServingLoop``, and ``--kv-standbys`` starts mirrored standby KV
servers that the workers fail over to.  Every flag that a validation
refuses exits with code 2 before anything is started.
"""

from __future__ import annotations

import argparse
import fcntl
import os
import socket
import struct
import sys
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.runner import config_parser
from horovod_tpu_torch.runner import secret as secret_mod
from horovod_tpu_torch.runner.hosts import allocate, parse_hostfile, \
    parse_hosts
from horovod_tpu_torch.runner.http_client import KVClient, parse_kv_addrs
from horovod_tpu_torch.runner.http_server import RendezvousServer
from horovod_tpu_torch.runner.launch import is_local, launch_workers
from horovod_tpu_torch.runner.run_task import import_cloudpickle
from horovod_tpu_torch.version import __version__


# The name in usage and error text (the console script's).
PROG = "hvdrun-torch"


def check_build() -> str:
    """The port's parts, each marked available or not: torch and its CUDA,
    the other frameworks (TensorFlow, Keras, MXNet: found, not imported),
    the card, nvcc, the flash attention kernels (built, or buildable from
    ``ops/csrc`` with nvcc), the engines (the native core built, or
    buildable from ``csrc/`` with the C++ compiler) and the native
    components: the dispatcher ops, the TensorFlow custom kernels and the
    SIMD wire codecs."""
    import glob
    import importlib.util
    import shutil

    import torch

    from horovod_tpu_torch.common import native_build
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.torch import _native_ops

    def mark(v):
        return "X" if v else " "

    def native_row(path, what):
        if os.path.exists(path):
            return True, f"built: {path}"
        if compiler:
            return True, (f"buildable from {native_build.CSRC_DIR} with "
                          f"{compiler}")
        return False, f"{what} not built, and no C++ compiler to build it"

    def have(mod):
        return importlib.util.find_spec(mod) is not None

    compiler = shutil.which(native_build.cxx())
    core_ok, core = native_row(native_build.core_path(), "the core")
    ops_ok, ops = native_row(_native_ops.library_path(), "the library")
    # The TensorFlow kernels' library is named by a hash of TensorFlow's
    # flags, which only importing TensorFlow (seconds) would give: any
    # build of it counts.
    tf_built = sorted(glob.glob(os.path.join(native_build.BUILD_DIR,
                                             "libhvd_tf_ops_*.so")))
    if not have("tensorflow"):
        tf_ok, tf_ops = False, "TensorFlow is not installed"
    else:
        tf_ok, tf_ops = native_row(tf_built[-1] if tf_built else "",
                                   "the library")
    simd = False
    if os.path.exists(native_build.core_path()):
        try:
            import ctypes

            simd = bool(ctypes.CDLL(
                native_build.core_path()).hvd_simd_available())
        except OSError:
            pass
    else:
        try:
            with open("/proc/cpuinfo") as f:
                flags = f.read()
            simd = "avx2" in flags and "f16c" in flags
        except OSError:
            pass
    simd_note = ""
    if os.environ.get("HVD_NO_SIMD") == "1":
        simd, simd_note = False, " (disabled by HVD_NO_SIMD=1)"

    cuda = torch.version.cuda
    card = torch.cuda.is_available()
    name = torch.cuda.get_device_name(0) if card else "none found"
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    lib = _build.library_path()
    built = os.path.exists(lib)
    sources = _build.sources()
    if built:
        kernels = f"built: {lib}"
    elif sources and nvcc:
        kernels = f"buildable from {os.path.dirname(sources[0])}"
    else:
        kernels = "not built, and no nvcc to build them"
    return f"""horovod_tpu_torch v{__version__}:

Available Frameworks:
    [X] PyTorch {torch.__version__}
    [{mark(cuda)}] CUDA {cuda or "(this torch is built for the CPU only)"}
    [{mark(have("tensorflow"))}] TensorFlow
    [{mark(have("keras"))}] Keras
    [{mark(have("mxnet"))}] MXNet

Available Devices:
    [{mark(card)}] NVIDIA card: {name}

Available Kernels:
    [{mark(nvcc)}] nvcc: {nvcc or "not found"}
    [{mark(built or (sources and nvcc))}] flash attention (Hopper wgmma): \
{kernels}

Available Engines:
    [{mark(core_ok)}] native C++ core (the default): {core}
    [X] Python engine (wire-compatible with the JAX package's PyEngine)

Available Native Components:
    [{mark(ops_ok)}] PyTorch dispatcher ops (torch.ops.hvd.*): {ops}
    [{mark(tf_ok)}] TensorFlow custom kernels (HvdAllreduce/...): {tf_ops}
    [{mark(simd)}] SIMD wire codecs (AVX2 + F16C){simd_note}"""


class _CheckBuildAction(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        print(check_build())
        sys.exit(0)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Launch a horovod_tpu_torch distributed job.")
    p.add_argument("-v", "--version", action="version",
                   version=__version__)
    p.add_argument("-cb", "--check-build", nargs=0,
                   action=_CheckBuildAction,
                   help="print the port's parts (torch and its CUDA, "
                        "the card, nvcc, the kernels, the engines) and "
                        "exit")
    p.add_argument("-np", "--num-proc", type=int, required=True,
                   dest="np", help="total number of processes")
    g = p.add_mutually_exclusive_group()
    g.add_argument("-H", "--hosts", dest="hosts",
                   help="host:slots[,host:slots...] (default: localhost)")
    g.add_argument("--hostfile", dest="hostfile",
                   help="path to a hostfile (mpirun 'host slots=N' style)")
    p.add_argument("--ssh-port", type=int, dest="ssh_port")
    p.add_argument("--ssh-identity-file", dest="ssh_identity_file")
    p.add_argument("--network-interface", dest="nics",
                   help="comma-separated NIC name(s); the rendezvous "
                        "binds to and advertises the first one that "
                        "resolves (default: automatic via the default "
                        "route)")
    p.add_argument("--launcher", choices=["spawn", "jsrun", "mpirun"],
                   default="spawn",
                   help="spawn: local subprocess / ssh per slot (default); "
                        "jsrun: one jsrun invocation on an LSF cluster; "
                        "mpirun: one mpirun invocation driving an MPI "
                        "cluster (OpenMPI or Hydra/MPICH; tasks need no "
                        "MPI linkage: rank comes from the env, data "
                        "rides the eager engine's own mesh)")
    p.add_argument("--start-timeout", type=int, default=120,
                   dest="start_timeout")
    p.add_argument("--max-restarts", type=int, default=0,
                   dest="max_restarts",
                   help="restart-based elasticity: relaunch the whole "
                        "gang up to N times when any rank fails "
                        "(training scripts resume from their checkpoint). "
                        "Default 0 keeps the fail-fast contract.")
    el = p.add_argument_group(
        "elastic",
        "in-process elasticity: ranks may die or join without "
        "relaunching the job; survivors roll back to the last "
        "State.commit() and re-form under a new membership epoch.  "
        "Needs a training script wrapped in @hvd.elastic.run (or a "
        "serving.ServingLoop), whose ranks form no torch.distributed "
        "group.  Composes with "
        "--max-restarts as the outer fallback: a gang that collapses "
        "below --min-np is relaunched whole.")
    el.add_argument("--min-np", type=int, dest="min_np",
                    help="keep going while at least this many workers "
                         "survive (default: -np)")
    el.add_argument("--max-np", type=int, dest="max_np",
                    help="admit joiners up to this many workers "
                         "(default: -np, i.e. no growth headroom)")
    el.add_argument("--host-discovery-script",
                    dest="host_discovery_script",
                    help="executable printing one 'hostname[:slots]' per "
                         "line; re-polled by the launcher, which starts "
                         "joiner workers on newly discovered hosts "
                         "(absent: membership only shrinks in process, "
                         "and --max-restarts covers full relaunches)")
    p.add_argument("--disable-cache", action="store_true",
                   dest="disable_cache")
    p.add_argument("--output-filename", dest="output_filename")
    p.add_argument("--config-file", dest="config_file")

    tune = p.add_argument_group("tunables")
    tune.add_argument("--fusion-threshold-mb", type=float,
                      dest="fusion_threshold_mb")
    tune.add_argument("--cycle-time-ms", type=float, dest="cycle_time_ms")
    tune.add_argument("--cache-capacity", type=int, dest="cache_capacity")
    tune.add_argument("--hierarchical-allreduce", action="store_true",
                      dest="hierarchical_allreduce")
    tune.add_argument("--hierarchical-allgather", action="store_true",
                      dest="hierarchical_allgather")
    tune.add_argument("--ring-segment-bytes", type=int,
                      dest="ring_segment_bytes",
                      help="segment each ring hop so the next segment's "
                           "receive overlaps the previous segment's "
                           "reduce; 0 disables (autotunable)")
    tune.add_argument("--sock-buf-bytes", type=int,
                      dest="sock_buf_bytes",
                      help="SO_SNDBUF/SO_RCVBUF for data-plane sockets "
                           "in bytes; 0 keeps the kernel default")
    tune.add_argument("--collective-timeout", type=float,
                      dest="collective_timeout",
                      help="seconds before an eager collective is "
                           "declared hung: the gang agrees on the "
                           "wedged rank(s) and aborts with a "
                           "CollectiveTimeoutError instead of "
                           "deadlocking; 0 (default) blocks forever")
    tune.add_argument("--ctrl-fanout", type=int, dest="ctrl_fanout",
                      help="max children a per-host control-plane "
                           "sub-coordinator folds before the next host "
                           "rank goes direct to the root; 0 (default) "
                           "folds the whole host")
    tune.add_argument("--no-shm", action="store_true", dest="no_shm",
                      help="disable the same-host shared-memory "
                           "transport: every peer link uses TCP")
    tune.add_argument("--shm-slot-bytes", type=int,
                      dest="shm_slot_bytes",
                      help="payload bytes per shm ring slot (default "
                           "262144, floor 4096)")
    tune.add_argument("--shm-slots", type=int, dest="shm_slots",
                      help="slots per directed shm ring (default 16, "
                           "floor 2)")

    auto = p.add_argument_group("autotune")
    auto.add_argument("--autotune", action="store_true", dest="autotune")
    auto.add_argument("--autotune-log-file", dest="autotune_log_file")

    tl = p.add_argument_group("timeline")
    tl.add_argument("--timeline-filename", dest="timeline_filename")
    tl.add_argument("--timeline-mark-cycles", action="store_true",
                    dest="timeline_mark_cycles")

    st = p.add_argument_group("stall check")
    st.add_argument("--no-stall-check", action="store_true",
                    dest="no_stall_check")
    st.add_argument("--stall-warning-time-seconds", type=float,
                    dest="stall_warning_time_seconds")
    st.add_argument("--stall-shutdown-time-seconds", type=float,
                    dest="stall_shutdown_time_seconds")

    mx = p.add_argument_group("metrics")
    mx.add_argument("--metrics-port", type=int, dest="metrics_port",
                    help="per-worker metrics debug-server base port "
                         "(worker binds port + local_rank)")

    sv = p.add_argument_group("serving")
    sv.add_argument("--serve-port", type=int, dest="serve_port",
                    help="inference front-door port for "
                         "horovod_tpu_torch.serving.ServingLoop "
                         "(HVD_SERVE_PORT; a rank whose port is taken "
                         "binds an ephemeral one)")
    sv.add_argument("--serve-max-batch", type=int, dest="serve_max_batch",
                    help="decode slots per serving batch "
                         "(continuous-batching width)")
    sv.add_argument("--serve-max-queue", type=int, dest="serve_max_queue",
                    help="admission queue bound; beyond it the front "
                         "door sheds with HTTP 503")

    kv = p.add_argument_group(
        "rendezvous availability",
        "surviving the KV store's death: standbys receive a "
        "write-through mirror of every PUT/DELETE and clients fail over "
        "down the endpoint list inside their normal retry budget.")
    kv.add_argument("--kv-standbys", type=int, dest="kv_standbys",
                    help="start N warm standby KV servers (0..2) next "
                         "to the primary; workers get the full endpoint "
                         "list via HVD_KV_ADDRS and fail over if the "
                         "primary dies")
    kv.add_argument("--kv-addrs", dest="kv_addrs",
                    help="comma-separated host:port list of externally "
                         "managed rendezvous KV endpoints (primary "
                         "first); exported to workers as HVD_KV_ADDRS "
                         "verbatim (mutually exclusive with "
                         "--kv-standbys)")

    p.add_argument("--log-level", dest="log_level",
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                            "FATAL"])
    p.add_argument("--adasum-mode", dest="adasum_mode",
                   help="accepted for the JAX launcher's flags and passed "
                        "on as HVD_ADASUM_MODE, but it changes nothing: "
                        "the port's Adasum (ops/adasum.py) has one mode; "
                        "the launcher warns when it is given")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the training command to run on every slot")
    return p


def _resolve_hosts(args):
    if args.hostfile:
        return parse_hostfile(args.hostfile)
    if args.hosts:
        return parse_hosts(args.hosts)
    # Inside an LSF allocation the job already knows its hosts.
    from horovod_tpu_torch.runner import lsf

    if lsf.in_lsf_job():
        hosts = lsf.lsf_hosts()
        if hosts:
            return hosts
    return parse_hosts(f"localhost:{args.np}")


def _collect_env(args):
    env = {}
    if args.config_file:
        env.update(config_parser.env_from_config_file(args.config_file))
    env.update(config_parser.env_from_args(args))
    return env


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    if not args.command:
        print(f"{PROG}: no command given", file=sys.stderr)
        return 2
    if args.max_restarts < 0:
        print(f"{PROG}: --max-restarts must be >= 0 (there is "
              "no infinite-restart sentinel; pick a bound)",
              file=sys.stderr)
        return 2
    if args.max_restarts and args.launcher in ("jsrun", "mpirun"):
        print(f"{PROG}: --max-restarts is not supported with "
              f"--launcher {args.launcher} (the external scheduler owns "
              "the job lifecycle; use its requeue policy)",
              file=sys.stderr)
        return 2
    if args.metrics_port is not None and \
            not (1 <= args.metrics_port <= 65535):
        print(f"{PROG}: --metrics-port must be in 1..65535 "
              f"(got {args.metrics_port}); each worker binds "
              "metrics-port + local_rank", file=sys.stderr)
        return 2
    if args.serve_port is not None and \
            not (1 <= args.serve_port <= 65535):
        print(f"{PROG}: --serve-port must be in 1..65535 "
              f"(got {args.serve_port})", file=sys.stderr)
        return 2
    for flag, val in (("--serve-max-batch", args.serve_max_batch),
                      ("--serve-max-queue", args.serve_max_queue)):
        if val is not None and val < 1:
            print(f"{PROG}: {flag} must be >= 1 (got {val})",
                  file=sys.stderr)
            return 2
    if args.kv_standbys is not None and not (0 <= args.kv_standbys <= 2):
        print(f"{PROG}: --kv-standbys must be in 0..2 "
              f"(got {args.kv_standbys})", file=sys.stderr)
        return 2
    if args.kv_addrs is not None:
        if args.kv_standbys:
            print(f"{PROG}: --kv-addrs and --kv-standbys are "
                  "mutually exclusive (either the launcher runs the "
                  "standbys or you point at external ones)",
                  file=sys.stderr)
            return 2
        try:
            parse_kv_addrs(args.kv_addrs)
        except ValueError as e:
            print(f"{PROG}: --kv-addrs: {e}", file=sys.stderr)
            return 2
    for flag, val in (("--ring-segment-bytes", args.ring_segment_bytes),
                      ("--sock-buf-bytes", args.sock_buf_bytes),
                      ("--ctrl-fanout", args.ctrl_fanout),
                      ("--collective-timeout", args.collective_timeout)):
        if val is not None and val < 0:
            print(f"{PROG}: {flag} must be >= 0 "
                  f"(got {val}; 0 disables)", file=sys.stderr)
            return 2
    for flag, val, floor in (("--shm-slot-bytes", args.shm_slot_bytes,
                              4096),
                             ("--shm-slots", args.shm_slots, 2)):
        if val is not None and val < floor:
            print(f"{PROG}: {flag} must be >= {floor} "
                  f"(got {val}); use --no-shm to disable the shm "
                  "transport entirely", file=sys.stderr)
            return 2
    if args.adasum_mode is not None:
        print(f"{PROG}: warning: --adasum-mode {args.adasum_mode!r} has no "
              "effect: the port's Adasum has one mode and no module reads "
              "HVD_ADASUM_MODE", file=sys.stderr)
    # Elastic flags: validate at parse time, before any rendezvous/ssh
    # side effects — a bad floor/ceiling or a missing discovery script
    # must fail in milliseconds, not mid-launch.
    elastic = (args.min_np is not None or args.max_np is not None
               or args.host_discovery_script is not None)
    min_np = args.min_np if args.min_np is not None else args.np
    max_np = args.max_np if args.max_np is not None else args.np
    if elastic:
        if args.launcher in ("jsrun", "mpirun"):
            print(f"{PROG}: elastic flags (--min-np/--max-np/"
                  "--host-discovery-script) are not supported with "
                  f"--launcher {args.launcher} (the external scheduler "
                  "owns process placement; elastic needs the spawn "
                  "launcher's supervision loop)", file=sys.stderr)
            return 2
        if min_np < 1:
            print(f"{PROG}: --min-np must be >= 1 "
                  f"(got {min_np})", file=sys.stderr)
            return 2
        if min_np > args.np:
            print(f"{PROG}: --min-np ({min_np}) cannot exceed "
                  f"-np ({args.np}) — the job starts at -np workers and "
                  "shrinks from there", file=sys.stderr)
            return 2
        if max_np < args.np:
            print(f"{PROG}: --max-np ({max_np}) cannot be below "
                  f"-np ({args.np}) — the job starts at -np workers and "
                  "grows from there", file=sys.stderr)
            return 2
        script = args.host_discovery_script
        if script and not (os.path.isfile(script)
                           and os.access(script, os.X_OK)):
            print(f"{PROG}: --host-discovery-script {script!r} "
                  "is not an executable file", file=sys.stderr)
            return 2
    mpi_impl = None
    if args.launcher == "mpirun":
        # Probe before any rendezvous/ssh side effects: a missing
        # mpirun should fail in milliseconds, not after a NIC ring
        # probe across the cluster.
        from horovod_tpu_torch.runner import mpi

        mpi_impl = mpi.detect_mpi_impl()
        if mpi_impl is None:
            print(f"{PROG}: --launcher mpirun: no usable "
                  "mpirun found on PATH (need OpenMPI or a "
                  "Hydra-family MPICH)", file=sys.stderr)
            return 2
        if mpi_impl == mpi.MpiImpl.MPICH and (
                args.ssh_port or args.ssh_identity_file):
            # Statically decidable: fail before the rendezvous server
            # and the cluster NIC probe, not after.
            print(f"{PROG}: --ssh-port/--ssh-identity-file have "
                  "no Hydra/MPICH mapping; configure ssh via "
                  "~/.ssh/config or use the OpenMPI or spawn launcher",
                  file=sys.stderr)
            return 2
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    hosts = _resolve_hosts(args)
    slots = allocate(hosts, args.np)
    env_extra = _collect_env(args)

    env_extra["HVD_START_TIMEOUT"] = str(args.start_timeout)

    # Per-job secret: signs every rendezvous KV request; workers receive
    # it via env.
    job_secret = secret_mod.make_secret()
    env_extra[secret_mod.ENV_VAR] = job_secret

    nic_addr = interface_address_any(args.nics) if args.nics else None
    if args.nics:
        # Workers advertise on the named NIC too (the bootstrap reads
        # HVD_NIC), not just the launcher's rendezvous bind.
        env_extra["HVD_NIC"] = args.nics
    multi_host = any(not is_local(s.hostname) for s in slots)
    if multi_host and args.launcher == "spawn":
        # Fail fast on unreachable hosts BEFORE starting the rendezvous
        # server or spawning anything, with repeat launches skipping the
        # probe inside the on-disk cache window.
        from horovod_tpu_torch.runner import ssh_check

        fn_cache = None
        if not args.disable_cache:
            fn_cache = ssh_check.LaunchCache(ssh_check.params_hash(
                args.np, args.hosts or args.hostfile, args.ssh_port,
                args.ssh_identity_file))
        remote = sorted({s.hostname for s in slots
                         if not is_local(s.hostname)})
        ssh_check.check_hosts_ssh(
            remote, ssh_port=args.ssh_port,
            ssh_identity_file=args.ssh_identity_file, cache=fn_cache)
    server = RendezvousServer(host=nic_addr or "0.0.0.0",
                              secret=job_secret)
    port = server.start()
    # Workers reach the rendezvous at this host; for multi-host jobs they
    # need a routable address, not loopback.
    addr = nic_addr or (_routable_address() if multi_host
                        else "127.0.0.1")
    if multi_host and not nic_addr:
        # No NIC named: ring-probe the hosts for mutually routable
        # interfaces instead of trusting the default-route guess on every
        # host.
        try:
            common = probe_common_nics(
                [s.hostname for s in slots], addr, port, job_secret,
                ssh_port=args.ssh_port,
                ssh_identity_file=args.ssh_identity_file)
            env_extra["HVD_NIC"] = ",".join(common)
            # Only re-point the rendezvous at the common NIC when the
            # launcher itself was in the probe ring (has a local slot);
            # on a pure-remote job, a same-named launcher NIC was never
            # validated, while the current addr demonstrably works (the
            # agents just used it).
            if any(is_local(s.hostname) for s in slots):
                probe_addr = interface_address(common[0])
                if probe_addr:
                    addr = probe_addr
        except Exception as e:  # discovery must never kill the launch
            print(f"{PROG}: NIC ring probe failed ({e}); "
                  "falling back to the default route", file=sys.stderr)
    standbys = []
    if args.kv_standbys:
        # Warm standbys next to the primary: each syncs nothing (the
        # store is empty at launch) and receives a write-through copy
        # of every mutation; workers learn the whole endpoint list.
        for i in range(args.kv_standbys):
            sb = RendezvousServer(host=nic_addr or "0.0.0.0",
                                  secret=job_secret)
            sb.start(name=f"hvd-kv-standby-{i}")
            standbys.append(sb)
        server.set_mirrors([(addr, sb.port) for sb in standbys])
        env_extra["HVD_KV_ADDRS"] = ",".join(
            [f"{addr}:{port}"] + [f"{addr}:{sb.port}" for sb in standbys])
    elif args.kv_addrs is not None:
        env_extra["HVD_KV_ADDRS"] = args.kv_addrs
    output = None
    if args.output_filename:
        output = open(args.output_filename, "w")
    try:
        if args.launcher in ("jsrun", "mpirun"):
            # One external fan-out: tasks get rank/size from the
            # scheduler's env (PMIX_*/OMPI_*/PMI_*, discovery.
            # from_mpi_env) and rendezvous back here.  Coordinates and
            # the job secret ride the launcher's process environment,
            # forwarded by NAME where the tool needs a list (-x /
            # -genvlist), never as values on the ps-visible command line.
            import subprocess

            env = dict(os.environ)
            env.update(env_extra)
            env.update({"HVD_RENDEZVOUS_ADDR": addr,
                        "HVD_RENDEZVOUS_PORT": str(port)})
            if args.launcher == "jsrun":
                from horovod_tpu_torch.runner import lsf

                cmd = lsf.jsrun_command(args.np, command)
            else:  # mpirun
                from horovod_tpu_torch.runner import mpi

                names = sorted(set(env_extra)
                               | {"HVD_RENDEZVOUS_ADDR",
                                  "HVD_RENDEZVOUS_PORT"})
                cmd = mpi.mpirun_command(
                    args.np, slots, command, env_var_names=names,
                    impl=mpi_impl,
                    nics=args.nics.split(",") if args.nics else None,
                    ssh_port=args.ssh_port,
                    ssh_identity_file=args.ssh_identity_file)
            return subprocess.run(
                cmd, env=env, stdout=output or None).returncode
        from horovod_tpu_torch.runner.hosts import HostBlacklist, SlotInfo
        from horovod_tpu_torch.runner.launch import (
            LaunchError,
            launch_workers_elastic,
        )
        from horovod_tpu_torch.utils import env as E

        blacklist = HostBlacklist() if (args.max_restarts or elastic) \
            else None
        if elastic:
            env_extra[E.ELASTIC_MIN_NP] = str(min_np)
            env_extra[E.ELASTIC_MAX_NP] = str(max_np)
            env_extra[E.ELASTIC_EPOCH] = "0"
            # The native engine has no in-process re-form: elastic jobs
            # run the Python engine.
            env_extra["HVD_TPU_CORE"] = "py"
            # The launcher owns the discovery loop (it must spawn joiner
            # processes on the new hosts); don't also start a notifier
            # driver inside rank 0 — joiners announce themselves.
            env_extra.pop(E.HOST_DISCOVERY_SCRIPT, None)
        for attempt in range(args.max_restarts + 1):
            env_try = dict(env_extra)
            if attempt:
                # Scoped rendezvous keys: the relaunched gang must never
                # read the dead attempt's stale addresses.
                env_try["HVD_RDV_SCOPE"] = f"attempt{attempt}"
                # Skip hosts that keep killing workers, while the rest
                # still cover -np; a cooled-down host is re-probed.
                use_hosts = blacklist.filter_hosts(hosts, args.np)
                skipped = sorted({h.hostname for h in hosts}
                                 - {h.hostname for h in use_hosts})
                if skipped:
                    print(f"{PROG}: skipping blacklisted "
                          f"host(s) {', '.join(skipped)} on relaunch",
                          file=sys.stderr)
                slots = allocate(use_hosts, args.np)
            driver = None
            try:
                if elastic:
                    take_pending = None
                    if args.host_discovery_script:
                        import threading

                        from horovod_tpu_torch.elastic.driver import (
                            ElasticDriver,
                            HostDiscoveryScript,
                        )

                        lock = threading.Lock()
                        known = {s.hostname for s in slots}
                        pending: List[SlotInfo] = []
                        next_rank = [len(slots)]

                        def on_update(ep, added, removed):
                            # Queue joiner slots for each genuinely new
                            # host; the supervision loop spawns them.
                            found = driver.hosts()
                            with lock:
                                for h in added:
                                    if h in known:
                                        continue
                                    known.add(h)
                                    n = found.get(h, 1)
                                    for li in range(n):
                                        pending.append(SlotInfo(
                                            hostname=h,
                                            rank=next_rank[0],
                                            size=0, local_rank=li,
                                            local_size=n,
                                            cross_rank=0, cross_size=0))
                                        next_rank[0] += 1

                        def take_pending():
                            with lock:
                                out = list(pending)
                                pending.clear()
                            return out

                        driver = ElasticDriver(
                            HostDiscoveryScript(
                                args.host_discovery_script),
                            min_np, max_np, blacklist=blacklist,
                            on_hosts_updated=on_update)
                        driver.start()
                    launch_workers_elastic(
                        slots, command, addr, port,
                        min_np=min_np, max_np=max_np,
                        env_extra=env_try,
                        ssh_port=args.ssh_port,
                        ssh_identity_file=args.ssh_identity_file,
                        output=output,
                        new_slots=take_pending,
                        on_failure=blacklist.record_failure)
                else:
                    launch_workers(
                        slots, command, addr, port,
                        env_extra=env_try,
                        ssh_port=args.ssh_port,
                        ssh_identity_file=args.ssh_identity_file,
                        output=output)
                return 0
            except LaunchError as e:
                if blacklist is not None:
                    blacklist.record_failure(e.hostname)
                if attempt >= args.max_restarts:
                    raise
                print(f"{PROG}: rank {e.rank} exited with code "
                      f"{e.returncode}"
                      + (f" on host {e.hostname}" if e.hostname else "")
                      + f"; restarting the job "
                      f"(attempt {attempt + 1}/{args.max_restarts})",
                      file=sys.stderr)
            finally:
                if driver is not None:
                    driver.stop()
        raise AssertionError("unreachable: loop returns or raises")
    finally:
        if output is not None:
            output.close()
        server.stop()
        for sb in standbys:
            sb.stop()


def probe_common_nics(hostnames: List[str], rdv_addr: str, rdv_port: int,
                      job_secret: str, *,
                      ssh_port: Optional[int] = None,
                      ssh_identity_file: Optional[str] = None,
                      wait_timeout: float = 60.0) -> List[str]:
    """Run one nic_probe agent per unique host through the normal spawn
    path and intersect their routable-interface reports; returns common
    NIC names, non-loopback first.  Raises if no interface is reachable
    from every host."""
    import threading

    from horovod_tpu_torch.runner import nic_probe
    from horovod_tpu_torch.runner.hosts import SlotInfo

    uniq = list(dict.fromkeys(hostnames))
    n = len(uniq)
    agent_slots = [
        SlotInfo(hostname=h, rank=i, size=n, local_rank=0, local_size=1,
                 cross_rank=i, cross_size=n)
        for i, h in enumerate(uniq)]
    kv = KVClient("127.0.0.1", rdv_port, secret=job_secret)
    result: dict = {}

    def _intersect():
        try:
            result["nics"] = nic_probe.common_interfaces(
                kv, n, wait_timeout=wait_timeout)
        except Exception as e:
            result["error"] = e

    t = threading.Thread(target=_intersect, daemon=True)
    t.start()
    with open(os.devnull, "w") as devnull:
        launch_workers(
            agent_slots,
            [sys.executable, "-m", "horovod_tpu_torch.runner.nic_probe"],
            rdv_addr, rdv_port,
            env_extra={secret_mod.ENV_VAR: job_secret},
            ssh_port=ssh_port, ssh_identity_file=ssh_identity_file,
            prefix_output=False, output=devnull)
    t.join(timeout=wait_timeout)
    if "error" in result:
        raise result["error"]
    if "nics" not in result:
        raise TimeoutError("NIC probe intersection timed out")
    return result["nics"]


def _routable_address() -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))  # no traffic sent; picks the default NIC
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()


def interface_address(ifname: str) -> Optional[str]:
    """IPv4 address of a named interface (the SIOCGIFADDR ioctl), or
    None."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        packed = struct.pack("256s", ifname.strip().encode()[:15])
        addr = fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24]  # SIOCGIFADDR
        return socket.inet_ntoa(addr)
    except OSError:
        return None
    finally:
        s.close()


def interface_address_any(nics: str) -> Optional[str]:
    """First resolvable address from a comma-separated NIC list; raises if
    the user named interfaces and none of them resolve (falling back would
    rendezvous on the wrong network)."""
    names = [n for n in (nics or "").split(",") if n.strip()]
    for n in names:
        addr = interface_address(n)
        if addr:
            return addr
    if names:
        raise ValueError(
            f"--network-interface: none of {names} has an IPv4 address")
    return None


# ---------------------------------------------------------------------------
# programmatic run-func mode
# ---------------------------------------------------------------------------


def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    np: int = 1,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    env: Optional[dict] = None,
    start_timeout: int = 120,
    device: Optional[str] = None,
) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` ranks; returns the list of
    per-rank return values in rank order.

    Each rank initializes the runtime on ``device`` (None: the card,
    ``cuda:<local_rank>``) with the eager engine and no process group,
    then calls the function.  Needs ``cloudpickle``, imported here."""
    cloudpickle = import_cloudpickle()

    if hostfile:
        host_list = parse_hostfile(hostfile)
    elif hosts:
        host_list = parse_hosts(hosts)
    else:
        host_list = parse_hosts(f"localhost:{np}")
    slots = allocate(host_list, np)

    job_secret = secret_mod.make_secret()
    server = RendezvousServer(secret=job_secret)
    port = server.start()
    payload = cloudpickle.dumps((fn, args, kwargs or {},
                                 None if device is None else str(device)))
    multi_host = any(not is_local(s.hostname) for s in slots)
    addr = _routable_address() if multi_host else "127.0.0.1"
    kv = KVClient("127.0.0.1", port, secret=job_secret)
    kv.put("runfunc/fn", payload)
    try:
        env_extra = dict(env or {})
        env_extra.setdefault("HVD_START_TIMEOUT", str(start_timeout))
        env_extra[secret_mod.ENV_VAR] = job_secret
        launch_failure = None
        try:
            launch_workers(
                slots,
                [sys.executable, "-m", "horovod_tpu_torch.runner.run_task"],
                addr, port, env_extra=env_extra)
        except Exception as e:
            # Workers post (False, traceback) before exiting non-zero;
            # surface the real exception rather than just the exit code.
            launch_failure = e
        results = []
        for r in range(np):
            blob = server.get(f"runfunc/result/{r}")
            if blob is None:
                if launch_failure is not None:
                    raise launch_failure
                raise RuntimeError(f"rank {r} returned no result")
            ok, value = cloudpickle.loads(blob)
            if not ok:
                raise RuntimeError(f"rank {r} raised:\n{value}")
            results.append(value)
        if launch_failure is not None:
            raise launch_failure
        return results
    finally:
        server.stop()


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
