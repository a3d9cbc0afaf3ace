"""The classic torch front-end: ``import horovod_tpu_torch.torch as hvd``.
The port of ``horovod_tpu/torch/__init__.py``.

The Horovod torch surface on the port's eager engine: init/rank/size,
the sync, async and in-place collectives with autograd
(``torch/mpi_ops.py``), the hook-driven ``DistributedOptimizer`` that
wraps a torch optimizer and overlaps the gradients' allreduces with
``backward()``, the Adasum delta optimizer, ``broadcast_parameters``,
``broadcast_optimizer_state``, ``broadcast_object`` and ``join``.  The
functional ``DistributedOptimizer`` of the compiled regime stays
``horovod_tpu_torch.parallel.optimizer.DistributedOptimizer``.

Gradient order on a card: a post-accumulate hook fires while the
backward's kernels for earlier layers may still be queued, and the hook
enqueues ``p.grad``.  The enqueue's host copy (``torch/mpi_ops.py``) is a
blocking ``Tensor.to("cpu")`` on the current stream, which in the hook is
the stream that accumulated the gradient, so the bytes sent are the
gradient's final ones; ``step()`` copies each result back into
``p.grad`` on the gradient's device.

One difference from the JAX package's: ``broadcast_optimizer_state``
initializes an empty state on the root by a step with zero gradients, as
the reference does, and then puts the root's parameters back, so that a
decoupled weight decay (AdamW) in that step does not move the root's
parameters away from the other ranks' (the JAX package's leaves them
decayed once).
"""

from __future__ import annotations

import collections
import warnings
from contextlib import contextmanager

import torch

from horovod_tpu_torch.basics import (  # noqa: F401
    cache_stats,
    cross_rank,
    cross_size,
    cuda_built,
    gloo_built,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
    xla_built,
)
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.process_sets import ProcessSet  # noqa: F401
from horovod_tpu_torch.torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allreduce,
    grouped_allreduce_async,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin applied to the user's optimizer class by
    ``DistributedOptimizer``: a dynamically created subclass with a
    post-accumulate hook per parameter that fires the gradient's async
    allreduce during backward; ``step()`` is the synchronization
    barrier."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, op=ReduceOp.AVERAGE,
                 process_set=None):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.backward_passes_per_step = backward_passes_per_step
        self.process_set = process_set

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}.{j}", v)
                for i, group in enumerate(self.param_groups)
                for j, v in enumerate(group["params"])]
        # Names must be unique and cover every parameter.
        if len({k for k, _ in named_parameters}) < len(named_parameters):
            raise ValueError(
                "parameter names in named_parameters must be unique")
        all_params = {v for group in self.param_groups
                      for v in group["params"]}
        named = {v for _, v in named_parameters}
        if all_params - named:
            raise ValueError(
                "named_parameters was specified, but one or more model "
                "parameters were not named")
        self._parameter_names = {v: k for k, v in named_parameters}
        self._handles = {}
        self._ctxs = {}
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay = {}
        active = size() > 1 if self.process_set is None \
            else self.process_set.size() > 1
        if self.process_set is not None and \
                not self.process_set.included():
            raise ValueError(
                f"rank {rank()} is not a member of {self.process_set}; "
                "construct the optimizer only on member ranks")
        if active:
            self._register_hooks()

    # -- hooks ------------------------------------------------------------

    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    p.register_post_accumulate_grad_hook(self._make_hook())

    def _make_hook(self):
        def hook(p):
            if p in self._handles and self._handles[p] is not None:
                if self._allreduce_delay[p] <= 0:
                    raise AssertionError(
                        "Gradients were computed more than "
                        "backward_passes_per_step times before call to "
                        "step(). Increase backward_passes_per_step to "
                        "accumulate gradients locally.")
            assert not p.grad.requires_grad
            assert self._allreduce_delay[p] > 0
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                self._handles[p] = self._allreduce_grad_async(p)
        return hook

    def _allreduce_grad_async(self, p):
        name = self._parameter_names[p]
        compressed, ctx = self._compression.compress(p.grad)
        self._ctxs[p] = ctx
        return allreduce_async(compressed, name=f"allreduce.{name}",
                               op=self.op,
                               process_set=self.process_set)

    # -- synchronization --------------------------------------------------

    def synchronize(self):
        """Waits for every outstanding gradient allreduce and writes the
        reduced values into ``param.grad``; a parameter whose hook did not
        fire (no gradient this step) is allreduced here, from zeros if it
        has no gradient."""
        missing = [p for p in self._requires_update
                   if p not in self._handles]
        for p in missing:
            if p.grad is None:
                p.grad = p.data.new_zeros(p.shape)
            self._handles[p] = self._allreduce_grad_async(p)
        for p, handle in self._handles.items():
            output = synchronize(handle)
            self._allreduce_delay[p] = self.backward_passes_per_step
            with torch.no_grad():
                p.grad.copy_(
                    self._compression.decompress(output, self._ctxs.pop(p)))
        self._handles.clear()
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        """Use when calling ``synchronize()`` manually before
        ``step()``."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without "
                    "optimizer.skip_synchronize() context after "
                    "optimizer.synchronize(). This can cause training "
                    "slowdown. You may want to consider using "
                    "optimizer.skip_synchronize() context if you use "
                    "optimizer.synchronize() in your code.")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """The delta-model Adasum optimizer.

    Where the averaging optimizer combines *gradients*, Adasum combines
    the *parameter deltas* the local optimizer produced: each rank applies
    its own ``step()``, the deltas ``p - p_start`` are reduced with the
    scale-invariant Adasum operation (the engine's, ``ops/adasum.py``),
    and every rank resets to ``p_start + adasum(deltas)``.  The starting
    model is broadcast from rank 0 at construction, so that the deltas
    are taken from a common point.
    """

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step != 1:
            # The delta model has no hook to delay: accumulate by calling
            # backward() several times before step() instead.
            raise ValueError(
                "backward_passes_per_step > 1 is not supported with "
                "op=Adasum: call loss.backward() several times before "
                "optimizer.step() to accumulate gradients locally")
        self._compression = compression
        names = dict(named_parameters or [])
        by_param = {v: k for k, v in names.items()}
        self._adasum_names = {}
        for i, group in enumerate(self.param_groups):
            for j, p in enumerate(group["params"]):
                self._adasum_names[p] = (
                    f"adasum.delta.{by_param[p]}" if p in by_param
                    else f"adasum.delta.{i}.{j}")
        if size() > 1:
            broadcast_parameters(
                [(nm, p) for p, nm in self._adasum_names.items()],
                root_rank=0)

    def step(self, closure=None):
        updated = [p for group in self.param_groups
                   for p in group["params"] if p.grad is not None]
        starts = {p: p.data.clone().detach() for p in updated}
        loss = super(self.__class__, self).step(closure)
        handles = []
        for p in updated:
            delta = p.data - starts[p]
            compressed, ctx = self._compression.compress(delta)
            h = allreduce_async(compressed, name=self._adasum_names[p],
                                op=ReduceOp.ADASUM)
            handles.append((p, h, ctx))
        with torch.no_grad():
            for p, h, ctx in handles:
                d = self._compression.decompress(synchronize(h), ctx)
                p.data.copy_(starts[p] + d)
        return loss


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1,
                         op=ReduceOp.AVERAGE, process_set=None):
    """Wraps a torch optimizer: the gradients' allreduces overlap
    backward, and ``step()`` synchronizes (a dynamically created subclass
    of the optimizer's class).  ``op=Adasum`` selects the delta-model
    wrapper.  ``process_set`` scopes the gradient collectives to a
    subgroup (construct the optimizer on member ranks only)."""
    if op == ReduceOp.ADASUM:
        if process_set is not None:
            raise ValueError("Adasum does not support process sets")
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_DistributedAdasumOptimizer.__dict__))
        return cls(optimizer.param_groups, named_parameters, compression,
                   backward_passes_per_step)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, process_set)


# ---------------------------------------------------------------------------
# state broadcast helpers
# ---------------------------------------------------------------------------


def broadcast_parameters(params, root_rank=0):
    """Broadcasts a ``state_dict()`` or an iterable of (name, tensor) from
    the root to every rank, in place."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif isinstance(params, collections.abc.Iterable):
        params = list(params)
    handles = []
    for name, p in params:
        if p is None:
            continue
        if torch.is_tensor(p):
            handles.append(broadcast_async_(p, root_rank,
                                            name=f"bp.{name}"))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcasts the optimizer state (momentum buffers, step counters,
    hyperparameters) from the root: tensors in place, the rest by
    ``broadcast_object``.  An empty state is first made on the root by a
    step with zero gradients, its parameters kept."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()
    if rank() == root_rank and not state_dict["state"]:
        # Only the root steps here, so a wrapped optimizer must skip its
        # gradient synchronization or it would launch a one-rank
        # allreduce.
        params = [p for group in optimizer.param_groups
                  for p in group["params"]]
        kept = [p.detach().clone() for p in params]
        for p in params:
            if p.requires_grad and p.grad is None:
                p.grad = p.data.new_zeros(p.shape)
        if hasattr(optimizer, "skip_synchronize"):
            with optimizer.skip_synchronize():
                optimizer.step()
        else:
            optimizer.step()
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)
        state_dict = optimizer.state_dict()

    # Scalars (the param groups' hyperparameters among them) travel as one
    # pickled object that also carries the tensors' metadata: a non-root
    # rank may have no state yet, so it learns shapes and dtypes from the
    # root and allocates receive buffers; the tensors are then broadcast
    # in place.  ``on_device`` names the tensors that live with their
    # parameter rather than on the host (AdamW's ``step`` stays there), a
    # key the JAX package's front-end ignores; without it every buffer is
    # a host one, as there.
    if rank() == root_rank:
        meta = {"param_groups": state_dict["param_groups"], "state": {},
                "on_device": []}
        for pid, pstate in state_dict["state"].items():
            meta["state"][pid] = {}
            for key, value in pstate.items():
                if torch.is_tensor(value):
                    meta["state"][pid][key] = (
                        "tensor", value.dtype, tuple(value.shape))
                    if value.device.type != "cpu":
                        meta["on_device"].append((pid, key))
                else:
                    meta["state"][pid][key] = ("scalar", value)
    else:
        meta = None
    meta = broadcast_object(meta, root_rank,
                            name="broadcast_optimizer_state")

    params = [p for group in optimizer.param_groups for p in group["params"]]
    on_device = set(meta.get("on_device", ()))
    tensors = []
    new_state = {}
    own_state = state_dict["state"]
    for pid, pstate in meta["state"].items():
        new_state[pid] = {}
        for key, entry in pstate.items():
            if entry[0] == "tensor":
                _, dtype, shape = entry
                if rank() == root_rank:
                    t = own_state[pid][key]
                else:
                    where = params[pid].device \
                        if (pid, key) in on_device else "cpu"
                    t = torch.zeros(shape, dtype=dtype, device=where)
                tensors.append((f"opt.{pid}.{key}", t))
                new_state[pid][key] = t
            else:
                new_state[pid][key] = entry[1]
    broadcast_parameters(tensors, root_rank)
    if rank() != root_rank:
        optimizer.load_state_dict({"state": new_state,
                                   "param_groups": meta["param_groups"]})


def broadcast_object(obj, root_rank=0, name=None):
    """Serializes and broadcasts any picklable object from the root (the
    eager layer's pickle-over-broadcast; torch tensors pickle fine)."""
    from horovod_tpu_torch.ops.eager import broadcast_object as _impl

    return _impl(obj, root_rank, name)
