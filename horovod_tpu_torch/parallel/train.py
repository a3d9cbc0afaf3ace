"""Training steps: the port of ``horovod_tpu/parallel/train.py``
(``make_transformer_train_step`` over a mesh of data, sequence, tensor and
expert axes, ``make_resnet_train_step``, ``make_resnet_train_step_hvd``
and ``make_mnist_train_step``).

Every rank holds its own slice of the batch and the whole model, or its
shard of it over ``tp`` and ``ep``.  One step is forward, backward, one
fused gradient allreduce through :class:`DistributedOptimizer` over the
axes that split the batch (where the JAX package let GSPMD infer the
reduction), and the optimizer update.  Each step returns the mean loss over
the global batch.  ``HVD_NONFINITE_POLICY`` arms the non-finite gradient
guard in ``make_resnet_train_step_hvd`` (and in a caller's own
``DistributedOptimizer``), where the JAX package's does; the other steps
pass ``nonfinite_policy="off"``, as the JAX package's GSPMD steps run no
guard.

The two ResNet steps differ in their batch-norm statistics at more than one
rank, as the JAX package's do.  ``make_resnet_train_step`` is the JAX jit
step, which sees the global batch: its batch norms normalize with the mean
and variance over every rank's images (synchronized batch norm, here
differentiable allreduces inside the forward).  ``make_resnet_train_step_hvd``
is the JAX ``shard_map`` step: each rank normalizes with its own slice's
statistics, and the new running statistics are averaged across the ranks
after the step.  At one rank the two are the same step.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import mnist as mnist_model
from horovod_tpu_torch.models import resnet as resnet_model
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.common.types import ReduceOp
from horovod_tpu_torch.parallel.mesh import Axis, Mesh, mesh_axis_size, \
    sub_axis
from horovod_tpu_torch.parallel.optimizer import DistributedOptimizer, \
    allreduce_gradients

_log = logging.getLogger("horovod_tpu_torch")

MakeOptimizer = Callable[[Iterable[torch.nn.Parameter]],
                         torch.optim.Optimizer]


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: "DistributedOptimizer | Zero1Optimizer"
    step: int


class ResNetState(NamedTuple):
    """The model carries its batch-norm statistics as buffers."""

    model: resnet_model.ResNet
    optimizer: DistributedOptimizer
    step: int


def default_optimizer(params: Iterable[torch.nn.Parameter]
                      ) -> torch.optim.Optimizer:
    """AdamW with the JAX package's default ``optax.adamw(1e-3,
    weight_decay=0.01)``: same betas and eps, decoupled decay on every
    parameter."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def make_transformer_train_step(
    cfg: tfm.TransformerConfig,
    optimizer: Optional[MakeOptimizer] = None,
    *,
    mesh: Optional[Mesh] = None,
    zero1: bool = False,
    device=None,
):
    """Returns ``(step_fn, init_fn)``.

    ``optimizer`` builds the inner optimizer from the parameters (default
    :func:`default_optimizer`).  ``init_fn(seed) -> TrainState`` makes the
    model from ``seed`` (the whole model's weights drawn on the CPU; over
    ``mesh`` each rank keeps its ``tp``/``ep`` shard) and gives every rank
    the weights of the first rank holding the same shard.
    ``step_fn(state, tokens, targets) -> (state, loss)`` takes this rank's
    ``[B/dp, S/sp]`` slice of the global batch, laid out ``P('dp', 'sp')``
    over ``mesh`` and replicated over ``tp``, ``ep`` and ``dcn`` (``None``:
    pure data parallelism over every rank), and returns the mean loss over
    the global batch; the model and optimizer are updated in place.
    Attention follows the JAX package's dispatch (see
    :mod:`horovod_tpu_torch.models.transformer`).

    Gradients are averaged over the ranks of ``dcn``, ``dp`` and ``sp``
    (every rank without a mesh), never over ``tp`` or ``ep``, and that is
    the gradient of the global mean loss.  Each rank seeds its backward
    with its own mean loss L_r.  Where a rank's loss reaches another
    rank's keys and values, the ring's ``ppermute``, Ulysses' all-to-all or
    the K/V all-gather carries that gradient back in its backward to the
    rank that computed them; where it reaches the global MoE statistics
    (``density_proxy``), their differentiable allreduce sums the ranks'
    gradients.  So the ranks' gradients sum to that of sum_r L_r, and their
    mean is the gradient of the mean of the L_r, which is the global mean
    loss when the slices are equal.  Within a ``tp`` or ``ep`` group the
    ranks share their tokens and loss: a sharded parameter's gradient is
    its shard of the whole one, and the collectives at the edges of the
    tensor- and expert-parallel regions give every rank the whole gradient
    of each replicated parameter.

    A ``pp`` axis holds replicas, as in the JAX package, whose
    ``param_specs`` name no ``pp``: its ranks hold the whole model and the
    same slice of the batch (:mod:`horovod_tpu_torch.parallel.pipeline`
    splits the layers over it).

    ``zero1=True`` shards the optimizer state over ``dp`` (ZeRO stage 1,
    :class:`Zero1Optimizer`): each rank keeps the AdamW moments of 1/dp of
    every eligible parameter, the first dimension that ``tp`` or ``ep`` do
    not split and that dp divides; the step reduce-scatters that
    parameter's gradient over ``dp`` (and averages the piece over ``dcn``
    and ``sp``), updates the piece and all-gathers the parameter.  Other
    parameters keep today's allreduce and replicated update.  The JAX
    package's two warnings are logged where the state stays replicated: no
    ``dp`` axis larger than 1, or no dimension divisible by dp.  Needs
    ``hvd.init()``."""
    tfm.check_mesh(cfg, mesh)
    dev = basics.resolve_device(device, "make_transformer_train_step()")
    make_inner = optimizer or default_optimizer
    zero_dims = _zero1_dims(cfg, mesh) if zero1 else {}

    def init_fn(seed: int) -> TrainState:
        axis = None if mesh is None else sub_axis(mesh, ("dcn", "dp", "sp"))
        model = _from_rank0(tfm.init(seed, cfg, device=dev, mesh=mesh), axis)
        if zero_dims:
            opt = Zero1Optimizer(model, make_inner, zero_dims, mesh=mesh,
                                 axis=axis)
        else:
            opt = DistributedOptimizer(make_inner(model.parameters()),
                                       axis=axis, nonfinite_policy="off")
        return TrainState(model, opt, 0)

    def step_fn(state: TrainState, tokens, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(state.model, tokens.to(dev), targets.to(dev),
                           mesh=mesh)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), C.allreduce(
            loss.detach(), axis=state.optimizer.axis)

    return step_fn, init_fn


def _zero1_dims(cfg: tfm.TransformerConfig, mesh: Optional[Mesh]
                ) -> Dict[str, int]:
    """ZeRO-1's eligible parameters: ``{name: dimension}``, the first
    dimension of this rank's shard that no axis of the mesh splits (the
    JAX package's ``_zero1_augment`` on its filtered specs) and that dp
    divides, at least dp long.  Logs the JAX package's warning, and
    returns no parameter, where the state stays replicated."""
    n = 1 if mesh is None else mesh_axis_size(mesh, "dp")
    if n <= 1:
        _log.warning("zero1=True but the mesh has no dp axis > 1; "
                     "optimizer state stays replicated")
        return {}
    specs = tfm.param_specs(cfg)
    with torch.device("meta"):
        shapes = {k: p.shape for k, p in
                  tfm.Transformer(cfg, mesh).named_parameters()}
    dims = {}
    for name, shape in shapes.items():
        spec = tfm.spec_of(specs, name)
        for d, size in enumerate(shape):
            if spec[d] not in mesh.shape and size % n == 0 and size >= n:
                dims[name] = d
                break
    if not dims:
        _log.warning("zero1=True but no optimizer-state dimension is "
                     "divisible by dp=%d; state stays replicated", n)
    return dims


class Zero1Optimizer:
    """ZeRO stage 1 over ``dp``: the inner optimizer steps this rank's
    1/dp piece of each parameter of ``dims`` (``{name: dimension}``; the
    piece at its ``dp`` index along that dimension) and the whole of the
    others, so its state for a sharded parameter is 1/dp of it.

    ``step()`` averages each sharded parameter's gradient by a
    reduce-scatter over ``dp`` and an allreduce of the piece over the rest
    of ``axis`` (``dcn`` and ``sp``), the other gradients by one fused
    allreduce over ``axis``, as :class:`DistributedOptimizer` does; runs
    the inner step; and all-gathers each sharded parameter over ``dp``.
    A parameter without a gradient counts as a zero gradient.  The update
    is elementwise (AdamW), so it is the replicated step's."""

    def __init__(self, model: torch.nn.Module, make_inner: MakeOptimizer,
                 dims: Dict[str, int], *, mesh: Mesh, axis: Axis):
        self.axis = axis
        self.dp = mesh.axis("dp")
        self.rest = sub_axis(mesh, ("dcn", "sp"))
        self.dims = dims
        self.params = list(model.named_parameters())
        # The inner optimizer's parameters, in the model's order: for each
        # sharded parameter a view of this rank's piece of it (so loading
        # the model's weights loads the pieces), else the parameter.
        self.pieces = {}
        for name, p in self.params:
            if name in dims:
                b = p.shape[dims[name]] // self.dp.size
                self.pieces[name] = torch.nn.Parameter(
                    p.detach().narrow(dims[name], self.dp.index * b, b))
        self.inner = make_inner([self.pieces.get(name, p)
                                 for name, p in self.params])

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        params = dict(self.params)
        grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
                 for name, p in self.params}
        whole = [name for name, _ in self.params if name not in self.dims]
        for name, g in zip(whole, allreduce_gradients(
                [grads[n] for n in whole], axis=self.axis)):
            params[name].grad = g
        names = list(self.pieces)
        scattered = [C.reduce_scatter(
            grads[n].movedim(self.dims[n], 0).contiguous(), ReduceOp.AVERAGE,
            axis=self.dp).movedim(0, self.dims[n]) for n in names]
        if self.rest.size > 1:
            scattered = C.grouped_allreduce(scattered, axis=self.rest)
        for n, g in zip(names, scattered):
            self.pieces[n].grad = g.contiguous()
        out = self.inner.step()
        for n in names:
            d = self.dims[n]
            params[n].copy_(C.allgather(
                self.pieces[n].movedim(d, 0).contiguous(),
                axis=self.dp).movedim(0, d))
        return out

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.inner.load_state_dict(state_dict)


def state_tree(state: TrainState):
    """A training state as a checkpoint tree: ``{"model": state_dict,
    "optimizer": the optimizer's state_dict, "step": step}`` (see
    :mod:`horovod_tpu_torch.utils.checkpoint`)."""
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def load_state_tree(state: TrainState, tree) -> TrainState:
    """Load a tree from :func:`state_tree` into ``state`` (built the same
    way, on the same mesh): the model's parameters, then the optimizer's
    state; returns the state at the tree's step."""
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    return state._replace(step=int(tree["step"]))


def _from_rank0(model: torch.nn.Module,
                axis: Optional[Axis] = None) -> torch.nn.Module:
    """Give every rank of ``axis`` (every rank when None) the parameters
    and buffers of the rank at index 0."""
    if (basics.size() if axis is None else axis.size) > 1:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                t.copy_(C.broadcast(t.detach(), root_rank=0, axis=axis))
    return model


def resnet_sgd(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The JAX package's default ``optax.sgd(0.1, momentum=0.9)``: heavy-ball
    momentum ``m = 0.9 m + g``, ``p -= 0.1 m``."""
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, dampening=0.0,
                           nesterov=False)


def _data_axis(mesh: Optional[Mesh], axes) -> Optional[Axis]:
    """The axes of ``axes`` (a name or names) the mesh has, which split the
    batch; None (every rank) without a mesh."""
    if mesh is None:
        return None
    return sub_axis(mesh, (axes,) if isinstance(axes, str) else tuple(axes))


def _global_mean(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis``, differentiable: the
    backward sums the ranks' gradients, so the averaged gradient is the
    global loss's."""
    group = None if axis is None else axis.group
    n = basics.size() if axis is None else axis.size
    return dist_nn.all_reduce(t, op=dist.ReduceOp.SUM, group=group) / n


def _resnet_step(cfg, optimizer, compression, sync_bn, device, what, axis,
                 nonfinite_policy):
    dev = basics.resolve_device(device, what)
    make_inner = optimizer or resnet_sgd

    def init_fn(seed: int) -> ResNetState:
        model = _from_rank0(resnet_model.init(seed, cfg, device=dev))
        opt = DistributedOptimizer(make_inner(model.parameters()),
                                   compression=compression, axis=axis,
                                   nonfinite_policy=nonfinite_policy)
        return ResNetState(model, opt, 0)

    def step_fn(state: ResNetState, images, labels):
        multi = (basics.size() if axis is None else axis.size) > 1
        state.optimizer.zero_grad(set_to_none=True)
        loss, new_stats = resnet_model.loss_fn(
            state.model, images.to(dev), labels.to(dev),
            reduce=(lambda t: _global_mean(t, axis)) if multi and sync_bn
            else None)
        loss.backward()
        state.optimizer.step()
        if multi and not sync_bn:
            names = list(new_stats)
            new_stats = dict(zip(names, C.grouped_allreduce(
                [new_stats[n] for n in names], axis=axis)))
        resnet_model.write_stats(state.model, new_stats)
        return state._replace(step=state.step + 1), C.allreduce(
            loss.detach(), axis=axis)

    return step_fn, init_fn


def make_resnet_train_step(cfg: resnet_model.ResNetConfig,
                           optimizer: Optional[MakeOptimizer] = None, *,
                           mesh: Optional[Mesh] = None, device=None):
    """Data-parallel ResNet step with the global batch's batch-norm
    statistics: the JAX package's jit step.

    Returns ``(step_fn, init_fn)``.  ``optimizer`` builds the inner
    optimizer from the parameters (default :func:`resnet_sgd`).
    ``init_fn(seed) -> ResNetState`` makes the model from ``seed`` and gives
    every rank rank 0's parameters and statistics.  ``step_fn(state,
    images, labels) -> (state, loss)`` takes this rank's ``[B, H, W, 3]``
    images and ``[B]`` labels (every rank the same B): its slice of a
    batch split over ``dp`` of ``mesh`` (and replicated over its other
    axes), or over every rank without a mesh.  Each batch norm allreduces
    its per-channel mean and then its mean squared deviation over those
    ranks inside the forward, so the statistics, the loss and the averaged
    gradient are those of the global batch.  The model, its statistics and
    the optimizer are updated in place.  Needs ``hvd.init()``."""
    return _resnet_step(cfg, optimizer, Compression.none, True, device,
                        "make_resnet_train_step()", _data_axis(mesh, "dp"),
                        "off")


def make_resnet_train_step_hvd(cfg: resnet_model.ResNetConfig,
                               optimizer: Optional[MakeOptimizer] = None, *,
                               compression=Compression.none,
                               mesh: Optional[Mesh] = None, axis=("dp",),
                               device=None):
    """Classic-Horovod ResNet step: the JAX package's ``shard_map`` step.

    As :func:`make_resnet_train_step`, except that each rank's batch norms
    use its own slice's statistics, and after the step the new running
    statistics are averaged across the ranks (one fused allreduce).  With
    ``mesh``, the axes of ``axis`` that the mesh has split the batch (as
    one dimension) and carry every reduction: gradients, statistics and
    the loss; without one, every rank.  ``compression`` is the gradient
    allreduce's (:class:`~horovod_tpu_torch.ops.compression.Compression`);
    ``HVD_NONFINITE_POLICY`` arms its non-finite gradient guard."""
    return _resnet_step(cfg, optimizer, compression, False, device,
                        "make_resnet_train_step_hvd()",
                        _data_axis(mesh, axis), None)


def mnist_adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The JAX package's default ``optax.adam(1e-3)``: same betas, eps added
    outside the square root as optax does."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def make_mnist_train_step(optimizer: Optional[MakeOptimizer] = None, *,
                          mesh: Optional[Mesh] = None, device=None):
    """Data-parallel MNIST step.  Returns ``(step_fn, init_fn)``:
    ``init_fn(seed) -> TrainState`` and ``step_fn(state, images, labels)
    -> (state, loss)`` with ``[B, 28, 28, 1]`` images, this rank's slice of
    a batch split over ``dp`` of ``mesh`` (every rank without one), as the
    transformer's (default optimizer :func:`mnist_adam`).  Needs
    ``hvd.init()``."""
    dev = basics.resolve_device(device, "make_mnist_train_step()")
    make_inner = optimizer or mnist_adam
    axis = _data_axis(mesh, "dp")

    def init_fn(seed: int) -> TrainState:
        model = _from_rank0(mnist_model.init(seed, device=dev))
        return TrainState(model, DistributedOptimizer(
            make_inner(model.parameters()), axis=axis,
            nonfinite_policy="off"), 0)

    def step_fn(state: TrainState, images, labels):
        state.optimizer.zero_grad(set_to_none=True)
        loss = mnist_model.loss_fn(state.model, images.to(dev),
                                   labels.to(dev))
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), C.allreduce(
            loss.detach(), axis=axis)

    return step_fn, init_fn
