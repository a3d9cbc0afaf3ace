"""Where a rank sits, from the environment of the launcher that started
it: the port of ``horovod_tpu/runner/discovery.py``.

``hvd.init()`` reads ``HVD_*`` (this package's launcher), then torchrun's
variables, then :func:`discover`: the MPI-style launchers' (Open MPI, IBM
JSM under jsrun, PMIx, PMI, Slurm), so that a worker started by ``hvdrun
--launcher mpirun`` or ``--launcher jsrun`` initializes with no ``HVD_*``
rank variables.

The JAX package's TPU VM metadata (``TPU_WORKER_ID``, ``MEGASCALE_*``)
has no counterpart: a GPU host carries none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PodTopology:
    rank: int            # process index in the whole job
    size: int            # total processes
    local_rank: int      # index within the host
    local_size: int      # processes on the host
    cross_rank: int      # host index
    cross_size: int      # number of hosts


def block_topology_ok(rank: int, size: int, local_rank: int,
                      local_size: int, cross_rank: int,
                      cross_size: int) -> bool:
    """True for a genuine two-level topology in the launcher's block rank
    layout (``rank = cross_rank * local_size + local_rank``): the
    precondition of the hierarchical data plane."""
    return (local_size > 1 and cross_size > 1
            and local_size * cross_size == size
            and rank == cross_rank * local_size + local_rank)


# MPI-launcher env schemas: (rank, size, local_rank, local_size) names.
# Lets ``hvd.init()`` work under mpirun / srun / jsrun with no HVD_*
# variables: the launcher's own say where the rank sits.
_MPI_SCHEMAS = (
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
     "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE"),
    # IBM JSM (jsrun on LSF/Summit) namespace exports.
    ("JSM_NAMESPACE_RANK", "JSM_NAMESPACE_SIZE",
     "JSM_NAMESPACE_LOCAL_RANK", "JSM_NAMESPACE_LOCAL_SIZE"),
    ("PMIX_RANK", "PMIX_SIZE", "PMIX_LOCAL_RANK", "PMIX_LOCAL_SIZE"),
    ("PMI_RANK", "PMI_SIZE", None, None),
    ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
     "SLURM_NTASKS_PER_NODE"),
)


def from_mpi_env() -> Optional[PodTopology]:
    """Topology from an MPI-style launcher's environment (Open MPI /
    PMIx / PMI / Slurm).  None when not launched that way."""
    env = os.environ
    for rank_k, size_k, lrank_k, lsize_k in _MPI_SCHEMAS:
        if rank_k not in env or size_k not in env:
            continue
        try:
            rank = int(env[rank_k])
            size = int(env[size_k])
            local_rank = int(env[lrank_k]) if lrank_k and lrank_k in env \
                else 0
            local_size = int(env[lsize_k]) if lsize_k and lsize_k in env \
                else 1
        except ValueError:
            continue
        if size <= 0:
            continue
        cross_rank = rank // local_size if local_size > 0 else 0
        # The hierarchical data plane assumes the block rank layout;
        # launchers mapping by node (mpirun --map-by node) violate it, and
        # ranks must not *disagree* about hierarchy — degrade to a flat
        # local topology unless the layout verifiably holds.
        if (local_size <= 0 or size % local_size
                or rank != cross_rank * local_size + local_rank):
            local_rank, local_size = 0, 1
            cross_rank = rank
        return PodTopology(
            rank=rank, size=size,
            local_rank=local_rank, local_size=local_size,
            cross_rank=cross_rank,
            cross_size=size // local_size,
        )
    return None


def discover() -> Optional[PodTopology]:
    """The MPI-style launcher's topology, or None."""
    return from_mpi_env()
