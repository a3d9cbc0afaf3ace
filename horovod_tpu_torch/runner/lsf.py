"""LSF allocations and the jsrun launch: the port of
``horovod_tpu/runner/lsf.py``.

Inside an LSF job the launcher reads the allocation's hosts from the
``LSB_*`` variables, and ``--launcher jsrun`` builds one ``jsrun`` line:
jsrun fans the job out and sets the PMIx variables on every task, from
which each worker reads its rank and size (``discovery.from_mpi_env``)
before it rendezvouses against the launcher's KV server.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from horovod_tpu_torch.runner.hosts import HostSlots


def in_lsf_job() -> bool:
    return "LSB_JOBID" in os.environ


def lsf_hosts() -> List[HostSlots]:
    """Hosts and slots of the current LSF allocation.

    Sources, in priority order: ``LSB_DJOB_HOSTFILE`` (one hostname per
    line, repeated per slot), then ``LSB_MCPU_HOSTS`` ("host n host n"
    pairs).  The batch (launch) host contributes no compute slots and is
    dropped when other hosts exist.
    """
    env = os.environ
    counts: dict = {}
    order: List[str] = []

    hostfile = env.get("LSB_DJOB_HOSTFILE")
    if hostfile and os.path.exists(hostfile):
        with open(hostfile) as f:
            for line in f:
                h = line.strip()
                if not h:
                    continue
                if h not in counts:
                    order.append(h)
                counts[h] = counts.get(h, 0) + 1
    elif env.get("LSB_MCPU_HOSTS"):
        toks = env["LSB_MCPU_HOSTS"].split()
        for h, n in zip(toks[::2], toks[1::2]):
            if h not in counts:
                order.append(h)
            counts[h] = counts.get(h, 0) + int(n)
    else:
        return []

    # First entry is the batch node; it holds the launcher, not workers.
    if len(order) > 1:
        order = order[1:]
    return [HostSlots(h, counts[h]) for h in order]


def jsrun_command(np: int, command: Sequence[str],
                  cpus_per_task: int = 1,
                  extra_args: Optional[Sequence[str]] = None) -> List[str]:
    """One ``jsrun`` line launching ``np`` tasks of ``command``.

    Tasks read rank/size from the PMIX env jsrun sets
    (``discovery.from_mpi_env``).  Rendezvous coordinates and the job
    secret travel in the *process environment* of the jsrun invocation
    (jsrun propagates the submitting environment to tasks), never on the
    ps-visible command line.
    """
    cmd = ["jsrun",
           "--np", str(np),
           "--cpu_per_rs", str(max(1, cpus_per_task))]
    if extra_args:
        cmd += list(extra_args)
    return cmd + list(command)
