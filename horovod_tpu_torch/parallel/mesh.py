"""Process meshes: the port of ``horovod_tpu/parallel/mesh.py``.

A :class:`Mesh` names the axes of the job's ranks, as the JAX package's
device mesh names the axes of its devices: ``dp`` (data), ``tp`` (tensor),
``pp`` (pipeline), ``sp`` (sequence), ``ep`` (expert) and ``dcn`` (across
hosts).  Rank ``r`` sits at the row-major coordinates of ``r`` in the axis
sizes, where the JAX package's CPU mesh places device ``r``
(``np.array(devices).reshape(sizes)``), so the ranks of a ``P('dp', 'sp')``
batch hold the slices the JAX devices hold.

:meth:`Mesh.axis` gives one or more axes as this rank sees them: an
:class:`Axis` with the size, this rank's index along it (row-major over the
names given) and the process group of the ranks that share this rank's
coordinates on every other axis.  The collectives of
:mod:`horovod_tpu_torch.ops.collective` take such an ``Axis`` where the JAX
package's take axis names.

A mesh belongs to the process group it was built on.  When that group
goes (``hvd.shutdown()``, an elastic re-form), every mesh built on it goes
stale: its ``axis()`` and every collective over one of its axes raise
:class:`StaleMeshError` instead of running over a destroyed group.  (The
JAX package's mesh is one process's devices, which a re-form never
touches.)  After ``basics.abort_process_groups`` (an NCCL group aborted on
the eager engine's word that a peer is gone) every collective of the
incarnation raises :class:`GroupAbortedError`.

The JAX package's ``filter_spec`` and ``sharding_for`` build
``PartitionSpec`` shardings for GSPMD; torch has none.  Each rank holds its
own shard of a tensor-parallel or expert-parallel parameter, cut by
:func:`horovod_tpu_torch.models.transformer.param_specs` and
:func:`shard`.
"""

from __future__ import annotations

import itertools
import math
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from horovod_tpu_torch import basics

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
PIPELINE_AXIS = "pp"
SEQUENCE_AXIS = "sp"
EXPERT_AXIS = "ep"
CROSS_AXIS = "dcn"


class StaleMeshError(RuntimeError):
    """A mesh, or an axis of one, used after the process group it was
    built on was destroyed."""

    def __init__(self, mesh: "Mesh"):
        super().__init__(
            f"{mesh!r} was built on a process group that no longer exists "
            "(hvd.shutdown() or an elastic re-form destroyed it); build a "
            "new mesh with make_mesh() after the re-form")


class GroupAbortedError(RuntimeError):
    """A collective over an axis after this incarnation's NCCL groups were
    aborted (``basics.abort_process_groups``).  Carries the axis's ranks
    (``group_ranks``), as a failed collective's error does, so that
    ``@hvd.elastic.run`` asks the gang's verdict and re-forms."""

    def __init__(self, ranks: Tuple[int, ...], reason: str):
        super().__init__(f"the process groups were aborted ({reason}); "
                         "re-form the gang before the next collective")
        self.group_ranks = tuple(ranks)


# Every live mesh, so that the end of its group can mark it stale.
_meshes: "weakref.WeakSet[Mesh]" = weakref.WeakSet()


def invalidate_meshes() -> None:
    """Mark every mesh stale and drop its axes' process groups: called
    when the default group is destroyed."""
    for m in list(_meshes):
        m.stale = True
        m._axes.clear()
    _meshes.clear()


def check_live(axis: "Axis") -> None:
    """Raise :class:`StaleMeshError` for an axis of a stale mesh, and
    :class:`GroupAbortedError` after the groups were aborted."""
    if getattr(axis.mesh, "stale", False):
        raise StaleMeshError(axis.mesh)
    check_not_aborted(axis)


def check_not_aborted(axis: "Axis") -> None:
    """Raise :class:`GroupAbortedError` for the axis once this
    incarnation's groups were aborted (``basics.group_aborted()``)."""
    aborted = basics.group_aborted()
    if aborted is not None:
        raise GroupAbortedError(axis.ranks, aborted)


@dataclass(frozen=True)
class Axis:
    """One or more mesh axes seen from this rank.

    ``ranks`` are the global ranks of the group in index order (``ranks[i]``
    sits at index ``i``); ``group`` is their process group (``None``: the
    default group, when the axis spans every rank); ``mesh`` is the mesh it
    came from (``None`` for :func:`world_axis`)."""

    names: Tuple[str, ...]
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[dist.ProcessGroup]
    mesh: Optional["Mesh"] = None


def world_axis() -> Axis:
    """Every rank, in rank order, over the default group."""
    n = basics.size()
    return Axis((), n, basics.rank(), tuple(range(n)), None)


def _factor_remaining(total: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Fill in any axis size given as -1 so the product matches ``total``."""
    known = 1
    unknown = None
    for name, s in sizes.items():
        if s == -1:
            if unknown is not None:
                raise ValueError("at most one axis may be -1")
            unknown = name
        else:
            known *= s
    if unknown is not None:
        if total % known != 0:
            raise ValueError(
                f"cannot infer axis {unknown!r}: {total} devices not "
                f"divisible by {known}")
        sizes = dict(sizes)
        sizes[unknown] = total // known
    return sizes


class Mesh:
    """The job's ranks as a named grid (see the module docstring).

    Built by :func:`make_mesh` or :func:`make_hierarchical_mesh` on every
    rank: the constructor creates one process group per line of each axis,
    a collective call that every rank makes in the same order.
    ``shape`` maps each axis name to its size, in mesh order; ``coords`` to
    this rank's coordinate."""

    def __init__(self, axes: Dict[str, int]):
        n = basics.size()
        self.shape = dict(axes)
        if math.prod(self.shape.values()) != n:
            raise ValueError(f"mesh axes {self.shape} require "
                             f"{math.prod(self.shape.values())} ranks, have "
                             f"{n}")
        self.axis_names = tuple(self.shape)
        self.ranks = np.arange(n).reshape(tuple(self.shape.values()))
        coords = np.unravel_index(basics.rank(), self.ranks.shape)
        self.coords = {k: int(c) for k, c in zip(self.axis_names, coords)}
        self._axes: Dict[Tuple[str, ...], Axis] = {}
        self.stale = False
        _meshes.add(self)
        for name in self.axis_names:
            self.axis(name)

    def axis(self, *names: str) -> Axis:
        """The axes ``names`` seen from this rank, index row-major in the
        order given; no names: this rank alone (size 1, a group of one).
        A combination of axes not asked for before creates its process
        groups: every rank must ask for it, in the same order as the
        others."""
        if self.stale:
            raise StaleMeshError(self)
        if any(n not in self.shape for n in names) or \
                len(set(names)) != len(names):
            raise ValueError(f"axes {names} are not distinct axes of the "
                             f"mesh {self.shape}")
        if names not in self._axes:
            self._axes[names] = self._make(names)
        return self._axes[names]

    def _line(self, names, fixed) -> Tuple[int, ...]:
        """Global ranks along ``names`` (row-major in that order) with the
        other axes at the coordinates ``fixed``."""
        out = []
        for idx in itertools.product(*(range(self.shape[n]) for n in names)):
            at = dict(fixed, **dict(zip(names, idx)))
            out.append(int(self.ranks[tuple(at[a] for a in self.axis_names)]))
        return tuple(out)

    def _make(self, names) -> Axis:
        others = [a for a in self.axis_names if a not in names]
        size = math.prod(self.shape[n] for n in names)
        index = 0
        for n in names:
            index = index * self.shape[n] + self.coords[n]
        mine = self._line(names, {a: self.coords[a] for a in others})
        if size == basics.size():
            group = None
        else:
            lines = [sorted(self._line(names, dict(zip(others, idx))))
                     for idx in itertools.product(
                         *(range(self.shape[a]) for a in others))]
            # The default group's bound, which new groups do not inherit.
            group, _ = dist.new_subgroups_by_enumeration(
                lines, timeout=basics._world.group_timeout)
        return Axis(tuple(names), size, index, mine, group, self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def num_slices() -> int:
    """Number of DCN-connected groups.  On TPU pods the JAX package counts
    ICI slices; on GPUs the matching unit is a host, so this is
    ``cross_size()``.  Needs ``hvd.init()``."""
    return basics.cross_size()


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over every rank.  ``axes`` maps axis name -> size; one size
    may be ``-1`` (inferred).  With no arguments, a pure data-parallel mesh
    ``{"dp": size}``, the Horovod default.  Needs ``hvd.init()``."""
    n = basics.size()
    if axes is None:
        axes = {DATA_AXIS: n}
    return Mesh(_factor_remaining(n, dict(axes)))


def make_hierarchical_mesh(*, inner_axes: Optional[Dict[str, int]] = None
                           ) -> Mesh:
    """A mesh with ``dcn`` as its outer axis, over the hosts
    (``cross_size()``), and ``inner_axes`` over the ranks of one host
    (default ``{"dp": ranks per host}``).  Ranks are numbered host by host,
    so the ``dcn`` coordinate is the cross rank.  On one host ``dcn`` is 1,
    so code written against this mesh runs everywhere."""
    n_outer = basics.cross_size()
    per = basics.size() // n_outer
    if inner_axes is None:
        inner_axes = {DATA_AXIS: per}
    inner_axes = _factor_remaining(per, dict(inner_axes))
    return Mesh({CROSS_AXIS: n_outer, **inner_axes})


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def sub_axis(mesh: Mesh, names) -> Axis:
    """The axes of ``names`` that the mesh has, in the mesh's order, as one
    :class:`Axis` (none of them: this rank alone)."""
    return mesh.axis(*(a for a in mesh.axis_names if a in names))


def present_axes(mesh: Mesh, names) -> Tuple[str, ...]:
    """Those of ``names`` that the mesh has with a size above one, in the
    mesh's order."""
    return tuple(a for a in mesh.shape if a in names and mesh.shape[a] > 1)


def shard(x, spec, mesh: Mesh):
    """This rank's block of ``x`` (a tensor or numpy array) under ``spec``:
    one axis name or None per dimension, as a ``PartitionSpec`` reads;
    a dimension over an axis of size ``n`` is cut into ``n`` equal blocks
    and the rank keeps block ``mesh.coords[axis]``.  Axes the mesh lacks
    leave their dimension whole.  ``mesh`` needs only ``shape`` and
    ``coords``."""
    for dim, name in enumerate(spec):
        n = mesh.shape.get(name, 1) if name is not None else 1
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {name!r} of size {n}")
        b = x.shape[dim] // n
        i = mesh.coords[name]
        x = x[(slice(None),) * dim + (slice(i * b, (i + 1) * b),)]
    return x


def data_parallel_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that carry gradient reduction: dcn and dp where the mesh has
    them (sp and ep are the callers' to add)."""
    return tuple(ax for ax in (CROSS_AXIS, DATA_AXIS) if ax in mesh.shape)
