"""Worker spawning: local subprocesses or ssh, with each rank's
environment, prefixed output streaming and fail-fast teardown.  The port
of ``horovod_tpu/runner/launch.py``.

Local ranks are executed directly, remote hosts through ``ssh``.  Every
worker runs in a session of its own, so that a teardown signals its whole
process group.  :func:`launch_workers` fails the job at the first non-zero
exit (SIGTERM to every worker, SIGKILL after ``kill_timeout``);
:func:`launch_workers_elastic` lets the gang re-form in process and fails
the job only when fewer than ``min_np`` workers finish cleanly.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from horovod_tpu_torch.runner.hosts import SlotInfo

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}

# Env vars that must never appear on a (ps-visible) remote command line;
# they are delivered over the ssh process's stdin instead.
SENSITIVE_ENV = ("HVD_SECRET_KEY",)

# The variables that cross the ssh boundary (values inlined as exports).
FORWARDED_PREFIXES = ("HVD_", "PYTHON", "CUDA_", "NCCL_", "TORCH_")


def _remote_command(env: Dict[str, str], command: Sequence[str]):
    """Build the ssh remote command string.

    Returns ``(remote, stdin_payload)``.  The variables a port worker reads
    are inlined as exports: ``HVD_*`` and ``PYTHON*`` as the JAX package's
    launcher forwards them, and in place of its ``JAX_*``/``XLA_*`` the
    GPU stack's ``CUDA_*`` (``CUDA_VISIBLE_DEVICES``, ...), ``NCCL_*`` and
    ``TORCH_*``.  Sensitive ones (``SENSITIVE_ENV``) are read from stdin
    with ``read -rs`` (silent: no pty echo into the captured output), so
    that a secret never reaches argv, which any local user can read via
    ``ps``."""
    sensitive = [(k, env[k]) for k in SENSITIVE_ENV if k in env]
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items()
        if k.startswith(FORWARDED_PREFIXES) and k not in SENSITIVE_ENV)
    inner = f"cd {shlex.quote(os.getcwd())} && {exports} " + \
        " ".join(shlex.quote(c) for c in command)
    if not sensitive:
        return inner, None
    reads = "; ".join(f"IFS= read -rs {k} && export {k}"
                      for k, _ in sensitive)
    # bash -c: `read -s` is a bash-ism; the user's login shell may be sh.
    remote = "bash -c " + shlex.quote(f"{reads}; {inner}")
    payload = "".join(v + "\n" for _, v in sensitive)
    return remote, payload


def is_local(hostname: str) -> bool:
    import socket

    if hostname in _LOCAL_NAMES:
        return True
    try:
        return hostname in (socket.gethostname(), socket.getfqdn())
    except OSError:
        return False


def worker_env(slot: SlotInfo, rdv_addr: str, rdv_port: int,
               extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """One slot's environment: the launcher's, ``extra``, the slot's
    coordinates and the rendezvous."""
    env = dict(os.environ)
    if extra:
        env.update(extra)
    # Workers import horovod_tpu_torch from a source tree as well as from
    # an installed package (script-mode python does not put the
    # launcher's working directory on sys.path).
    import horovod_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(horovod_tpu_torch.__file__)))
    pp = env.get("PYTHONPATH", "")
    if pkg_root not in pp.split(os.pathsep):
        env["PYTHONPATH"] = (pkg_root + os.pathsep + pp) if pp else pkg_root
    env.update({
        "HVD_HOSTNAME": slot.hostname,
        "HVD_RANK": str(slot.rank),
        "HVD_SIZE": str(slot.size),
        "HVD_LOCAL_RANK": str(slot.local_rank),
        "HVD_LOCAL_SIZE": str(slot.local_size),
        "HVD_CROSS_RANK": str(slot.cross_rank),
        "HVD_CROSS_SIZE": str(slot.cross_size),
        "HVD_RENDEZVOUS_ADDR": rdv_addr,
        "HVD_RENDEZVOUS_PORT": str(rdv_port),
    })
    return env


def _stream(proc: subprocess.Popen, rank: int, out,
            prefix_output: bool) -> None:
    for raw in iter(proc.stdout.readline, b""):
        line = raw.decode("utf-8", "replace")
        if prefix_output:
            out.write(f"[{rank}]<stdout>: {line}")
        else:
            out.write(line)
        out.flush()


class LaunchError(RuntimeError):
    def __init__(self, rank: int, returncode: int,
                 hostname: Optional[str] = None):
        from horovod_tpu_torch.utils import env as env_util

        # Point the operator at the evidence: every rank's flight
        # recorder dumped into HVD_BLACKBOX_DIR on the way down.
        postmortem = (f"; postmortem: {env_util.blackbox_dir()}"
                      if env_util.blackbox_enabled() else "")
        super().__init__(
            f"worker rank {rank} exited with code {returncode}"
            + (f" on host {hostname}" if hostname else "")
            + postmortem)
        self.rank = rank
        self.returncode = returncode
        self.hostname = hostname


def _spawn_worker(
    slot: SlotInfo,
    command: Sequence[str],
    rdv_addr: str,
    rdv_port: int,
    env_extra: Optional[Dict[str, str]],
    ssh_port: Optional[int],
    ssh_identity_file: Optional[str],
    output,
    prefix_output: bool,
):
    """Start one worker (local exec or ssh) with its streaming thread."""
    env = worker_env(slot, rdv_addr, rdv_port, env_extra)
    stdin_payload = None
    if is_local(slot.hostname):
        argv = list(command)
        popen_env = env
    else:
        # -tt forces a remote pty so killing the local ssh client
        # HUPs the remote process group — fail-fast teardown reaches
        # remote workers, not just the local ssh processes.
        ssh_cmd = ["ssh", "-tt", "-o", "StrictHostKeyChecking=no"]
        if ssh_port:
            ssh_cmd += ["-p", str(ssh_port)]
        if ssh_identity_file:
            ssh_cmd += ["-i", ssh_identity_file]
        # Only the forwarded families cross the ssh boundary; secrets go
        # over stdin, never argv.
        remote, stdin_payload = _remote_command(env, command)
        argv = ssh_cmd + [slot.hostname, remote]
        popen_env = dict(os.environ)
    proc = subprocess.Popen(
        argv, env=popen_env,
        stdin=subprocess.PIPE if stdin_payload else None,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
    if stdin_payload:
        proc.stdin.write(stdin_payload.encode())
        proc.stdin.flush()
        proc.stdin.close()
    t = threading.Thread(target=_stream,
                         args=(proc, slot.rank, output, prefix_output),
                         daemon=True)
    t.start()
    return proc, t


def launch_workers(
    slots: Sequence[SlotInfo],
    command: Sequence[str],
    rdv_addr: str,
    rdv_port: int,
    *,
    env_extra: Optional[Dict[str, str]] = None,
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
    prefix_output: bool = True,
    output=None,
    kill_timeout: float = 5.0,
) -> None:
    """Run ``command`` on every slot; block until all exit.

    Any non-zero exit terminates the whole job (SIGTERM, then SIGKILL
    after ``kill_timeout``) and raises :class:`LaunchError` for the first
    failure: fail fast.
    """
    output = output or sys.stdout
    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []

    for slot in slots:
        proc, t = _spawn_worker(slot, command, rdv_addr, rdv_port,
                                env_extra, ssh_port, ssh_identity_file,
                                output, prefix_output)
        procs.append(proc)
        threads.append(t)

    failure: Optional[LaunchError] = None
    alive = set(range(len(procs)))
    while alive and failure is None:
        for i in list(alive):
            rc = procs[i].poll()
            if rc is None:
                continue
            alive.discard(i)
            if rc != 0:
                failure = LaunchError(slots[i].rank, rc,
                                      hostname=slots[i].hostname)
                break
        time.sleep(0.05)

    if failure is not None:
        _terminate(procs, kill_timeout)
        for t in threads:
            t.join(timeout=2)
        raise failure

    for p in procs:
        p.wait()
    for t in threads:
        t.join(timeout=2)


def launch_workers_elastic(
    slots: Sequence[SlotInfo],
    command: Sequence[str],
    rdv_addr: str,
    rdv_port: int,
    *,
    min_np: int,
    max_np: int,
    env_extra: Optional[Dict[str, str]] = None,
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
    prefix_output: bool = True,
    output=None,
    kill_timeout: float = 5.0,
    new_slots: Optional[Callable[[], List[SlotInfo]]] = None,
    on_failure: Optional[Callable[[str], None]] = None,
) -> None:
    """Elastic supervision: a dying worker does NOT kill the job.

    The in-process gang re-forms around failures (``elastic/run.py``),
    so the launcher's job is only to (a) keep supervising survivors,
    (b) spawn joiner processes on hosts ``new_slots()`` reports (fed by
    the discovery driver), capped at ``max_np`` live workers, and
    (c) declare the job failed only when fewer than ``min_np`` workers
    finished cleanly — the same floor the gang itself enforces.

    ``on_failure(hostname)`` fires per non-zero exit (blacklist feed).
    Joiners still pending once every original worker has exited are
    torn down and not counted as failures.
    """
    output = output or sys.stdout
    entries: List[dict] = []

    def _spawn(slot: SlotInfo, joiner: bool) -> None:
        extra = dict(env_extra or {})
        if joiner:
            extra["HVD_ELASTIC_JOINER"] = "1"
        proc, t = _spawn_worker(slot, command, rdv_addr, rdv_port,
                                extra, ssh_port, ssh_identity_file,
                                output, prefix_output)
        entries.append({"slot": slot, "proc": proc, "thread": t,
                        "joiner": joiner, "rc": None})

    for slot in slots:
        _spawn(slot, joiner=False)

    successes = 0
    first_failure: Optional[LaunchError] = None
    while True:
        live = [e for e in entries if e["rc"] is None]
        if not live:
            break
        for e in live:
            rc = e["proc"].poll()
            if rc is None:
                continue
            e["rc"] = rc
            if rc == 0:
                successes += 1
            else:
                slot = e["slot"]
                if first_failure is None:
                    first_failure = LaunchError(slot.rank, rc,
                                                hostname=slot.hostname)
                if on_failure is not None:
                    on_failure(slot.hostname)
                from horovod_tpu_torch.utils import env as env_util
                pm = (f"; postmortem: {env_util.blackbox_dir()}"
                      if env_util.blackbox_enabled() else "")
                print(f"hvdrun: worker rank {slot.rank} on "
                      f"{slot.hostname} exited with code {rc}; the gang "
                      f"re-forms in process (elastic mode){pm}",
                      file=sys.stderr)
        originals_done = all(e["rc"] is not None for e in entries
                             if not e["joiner"])
        if originals_done:
            # Nobody left to admit a pending joiner — reap stragglers.
            stragglers = [e["proc"] for e in entries
                          if e["joiner"] and e["rc"] is None]
            if stragglers:
                _terminate(stragglers, kill_timeout)
                for e in entries:
                    if e["joiner"] and e["rc"] is None:
                        e["rc"] = e["proc"].poll()
            break
        if new_slots is not None:
            live_count = sum(1 for e in entries if e["rc"] is None)
            for slot in new_slots():
                if live_count >= max_np:
                    break
                _spawn(slot, joiner=True)
                live_count += 1
        time.sleep(0.05)

    for e in entries:
        e["thread"].join(timeout=2)
    if successes < min_np:
        raise first_failure if first_failure is not None else LaunchError(
            slots[0].rank if slots else 0, 1)


def _terminate(procs: List[subprocess.Popen], kill_timeout: float) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
    deadline = time.monotonic() + kill_timeout
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            return
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
