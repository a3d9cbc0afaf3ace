"""The mpirun launch mode: the port of ``horovod_tpu/runner/mpi.py``.

``hvdrun --launcher mpirun`` builds one ``mpirun`` command line (the
implementation's flavour, OpenMPI or a Hydra-family MPICH, each variable
forwarded by name, the NIC, the large-cluster flags) and lets MPI fan the
job out.  The tasks need no MPI linkage: they read rank and size from the
variables mpirun sets (``discovery.from_mpi_env``: ``OMPI_*``, ``PMI_*``,
``PMIX_*``) and rendezvous against the launcher's KV server like spawned
workers.

Secrets: values (the job secret, the rendezvous) are exported by NAME
(OpenMPI ``-x VAR``, Hydra ``-genvlist VAR``) from the launcher's process
environment, never on the ps-visible command line.
"""

from __future__ import annotations

import re
import subprocess
from typing import Dict, List, Optional, Sequence

from horovod_tpu_torch.runner.hosts import SlotInfo


class MpiImpl:
    OPENMPI = "openmpi"
    MPICH = "mpich"  # Hydra family: MPICH, Intel MPI, MVAPICH


def detect_mpi_impl(mpirun: str = "mpirun") -> Optional[str]:
    """Which MPI flavor ``mpirun`` belongs to, or None when unusable.

    ``mpirun --version`` naming "Open MPI"/"OpenRTE" is OpenMPI;
    everything Hydra-shaped (MPICH, Intel MPI, MVAPICH) takes the mpich
    command form.
    """
    try:
        out = subprocess.run(
            [mpirun, "--version"], capture_output=True, text=True,
            timeout=15)
    except (OSError, subprocess.TimeoutExpired):
        return None
    text = (out.stdout or "") + (out.stderr or "")
    return classify_mpi_version(text)


def classify_mpi_version(text: str) -> Optional[str]:
    if re.search(r"Open(?:\s+MPI|RTE|\s+RTE)", text, re.IGNORECASE):
        return MpiImpl.OPENMPI
    if re.search(r"HYDRA|MPICH|Intel\(R\) MPI|MVAPICH", text,
                 re.IGNORECASE):
        return MpiImpl.MPICH
    return None


def _host_list(slots: Sequence[SlotInfo]) -> List[str]:
    """Ordered unique hostnames with slot counts, e.g. ['a:2', 'b:2']."""
    counts: Dict[str, int] = {}
    order: List[str] = []
    for s in slots:
        if s.hostname not in counts:
            order.append(s.hostname)
        counts[s.hostname] = counts.get(s.hostname, 0) + 1
    return [f"{h}:{counts[h]}" for h in order]


# Above this task count OpenMPI's rsh tree-spawn needs throttling and a
# wider routing radix.
_LARGE_CLUSTER_NP = 64


def mpirun_command(np: int, slots: Sequence[SlotInfo],
                   command: Sequence[str],
                   env_var_names: Sequence[str],
                   impl: str = MpiImpl.OPENMPI,
                   mpirun: str = "mpirun",
                   nics: Optional[Sequence[str]] = None,
                   ssh_port: Optional[int] = None,
                   ssh_identity_file: Optional[str] = None,
                   extra_args: Optional[Sequence[str]] = None) -> List[str]:
    """Build the single ``mpirun`` invocation for the job.

    ``env_var_names`` are forwarded by name (values stay in the
    launcher's environment).  OpenMPI gets a TCP-only binding (``-mca pml
    ob1 -mca btl tcp,self``): the tasks use MPI for process placement
    only, and the data plane is the eager engine's own.
    """
    hostlist = _host_list(slots)
    if impl == MpiImpl.OPENMPI:
        cmd = [mpirun, "--allow-run-as-root", "--tag-output",
               "-np", str(np),
               "-H", ",".join(hostlist),
               "--map-by", "slot",
               "-mca", "pml", "ob1",
               "-mca", "btl", "tcp,self"]
        if np >= _LARGE_CLUSTER_NP:
            cmd += ["-mca", "plm_rsh_num_concurrent",
                    str(len(hostlist)),
                    "-mca", "routed", "radix:600"]
        if nics:
            cmd += ["-mca", "btl_tcp_if_include", ",".join(nics)]
        rsh_args = []
        if ssh_port:
            rsh_args += ["-p", str(ssh_port)]
        if ssh_identity_file:
            rsh_args += ["-i", ssh_identity_file]
        if rsh_args:
            cmd += ["-mca", "plm_rsh_args", " ".join(rsh_args)]
        for name in env_var_names:
            cmd += ["-x", name]
        if extra_args:
            cmd += list(extra_args)
        return cmd + list(command)
    if impl == MpiImpl.MPICH:
        if ssh_port or ssh_identity_file:
            # Hydra routes ssh options through launcher-exec scripts,
            # not flags; refusing beats a silent default-ssh failure.
            raise ValueError(
                "--ssh-port/--ssh-identity-file are not supported with "
                "a Hydra/MPICH mpirun; configure ssh via ~/.ssh/config "
                "or use the OpenMPI or spawn launcher")
        # Hydra honors host:count in -hosts, preserving the requested
        # per-host slot layout.
        cmd = [mpirun, "-np", str(np),
               "-hosts", ",".join(hostlist)]
        if nics:
            cmd += ["-iface", nics[0]]
        if env_var_names:
            cmd += ["-genvlist", ",".join(env_var_names)]
        if extra_args:
            cmd += list(extra_args)
        return cmd + list(command)
    raise ValueError(f"unknown MPI implementation {impl!r}")
