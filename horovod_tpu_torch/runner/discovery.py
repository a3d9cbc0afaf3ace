"""Topology checks: the port's copy of ``block_topology_ok`` from
``horovod_tpu/runner/discovery.py``.

Left out until the launcher's periphery is ported: the TPU pod metadata,
host discovery scripts and the elastic host manager.
"""

from __future__ import annotations


def block_topology_ok(rank: int, size: int, local_rank: int,
                      local_size: int, cross_rank: int,
                      cross_size: int) -> bool:
    """True for a genuine two-level topology in the launcher's block rank
    layout (``rank = cross_rank * local_size + local_rank``): the
    precondition of the hierarchical data plane."""
    return (local_size > 1 and cross_size > 1
            and local_size * cross_size == size
            and rank == cross_rank * local_size + local_rank)
