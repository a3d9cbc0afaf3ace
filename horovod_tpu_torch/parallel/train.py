"""Training steps: the port of ``horovod_tpu/parallel/train.py``
(``make_transformer_train_step``, data and sequence parallel over a mesh,
``make_resnet_train_step``, ``make_resnet_train_step_hvd`` and
``make_mnist_train_step``).

Every rank holds the whole model and its own slice of the batch.  One step
is forward, backward, one fused gradient allreduce through
:class:`DistributedOptimizer` (where the JAX package let GSPMD infer the
reduction over ``dp``), and the optimizer update.  Each step returns the
mean loss over the global batch.

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

from typing import Callable, Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import mnist as mnist_model
from horovod_tpu_torch.models import resnet as resnet_model
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel.mesh import Mesh
from horovod_tpu_torch.parallel.optimizer import DistributedOptimizer

MakeOptimizer = Callable[[Iterable[torch.nn.Parameter]],
                         torch.optim.Optimizer]


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: DistributedOptimizer
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
    model from ``seed`` and gives every rank rank 0's weights.
    ``step_fn(state, tokens, targets) -> (state, loss)`` takes this rank's
    ``[B/dp, S/sp]`` slice of the global batch, laid out ``P('dp', 'sp')``
    over ``mesh`` (``None``: pure data parallelism over every rank), and
    returns the mean loss over the global batch (an averaging allreduce of
    the ranks' mean losses, the JAX step's value for equal slices); the
    model and optimizer are updated in place.  With ``sp > 1`` the
    attention is sequence parallel (``cfg.attn_impl`` "ring" or "ulysses").

    Gradients are averaged over every rank of the mesh (dp x sp), and that
    is the gradient of the global mean loss: every rank holds the whole
    model and seeds its backward with its own mean loss L_r, and where a
    rank's loss reaches another rank's keys and values, the ring's
    ``ppermute`` (or Ulysses' all-to-all) backward has carried that
    gradient to the rank that computed them, so the ranks' gradients sum to
    that of sum_r L_r, and their mean is the gradient of the mean of the
    L_r, which is the global mean loss when the slices are equal.

    ``zero1=True`` (optimizer state sharded over dp) is not ported yet.
    Needs ``hvd.init()``."""
    if zero1:
        raise NotImplementedError(
            "zero1=True (ZeRO-1 optimizer-state sharding) is not ported "
            "yet; see ROADMAP.md, Queue 1")
    if mesh is not None:
        model_axes = {a: n for a, n in mesh.shape.items()
                      if a not in ("dp", "sp", "dcn") and n > 1}
        if model_axes:
            raise NotImplementedError(
                f"mesh axes {model_axes} (tensor, pipeline or expert "
                "parallelism) are not ported yet; see ROADMAP.md, Queue 1")
    dev = basics.resolve_device(device, "make_transformer_train_step()")
    make_inner = optimizer or default_optimizer

    def init_fn(seed: int) -> TrainState:
        model = _from_rank0(tfm.init(seed, cfg, device=dev))
        opt = DistributedOptimizer(make_inner(model.parameters()))
        return TrainState(model, opt, 0)

    def step_fn(state: TrainState, tokens, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(state.model, tokens.to(dev), targets.to(dev),
                           mesh=mesh)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), C.allreduce(loss.detach())

    return step_fn, init_fn


def _from_rank0(model: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers."""
    if basics.size() > 1:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                t.copy_(C.broadcast(t.detach(), root_rank=0))
    return model


def resnet_sgd(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The JAX package's default ``optax.sgd(0.1, momentum=0.9)``: heavy-ball
    momentum ``m = 0.9 m + g``, ``p -= 0.1 m``."""
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, dampening=0.0,
                           nesterov=False)


def _global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, differentiable: the backward sums
    the ranks' gradients, so the averaged gradient is the global loss's."""
    return dist_nn.all_reduce(t, op=dist.ReduceOp.SUM) / basics.size()


def _resnet_step(cfg, optimizer, compression, sync_bn, device, what):
    dev = basics.resolve_device(device, what)
    make_inner = optimizer or resnet_sgd

    def init_fn(seed: int) -> ResNetState:
        model = _from_rank0(resnet_model.init(seed, cfg, device=dev))
        opt = DistributedOptimizer(make_inner(model.parameters()),
                                   compression=compression)
        return ResNetState(model, opt, 0)

    def step_fn(state: ResNetState, images, labels):
        multi = basics.size() > 1
        state.optimizer.zero_grad(set_to_none=True)
        loss, new_stats = resnet_model.loss_fn(
            state.model, images.to(dev), labels.to(dev),
            reduce=_global_mean if multi and sync_bn else None)
        loss.backward()
        state.optimizer.step()
        if multi and not sync_bn:
            names = list(new_stats)
            new_stats = dict(zip(names, C.grouped_allreduce(
                [new_stats[n] for n in names])))
        resnet_model.write_stats(state.model, new_stats)
        return state._replace(step=state.step + 1), C.allreduce(loss.detach())

    return step_fn, init_fn


def make_resnet_train_step(cfg: resnet_model.ResNetConfig,
                           optimizer: Optional[MakeOptimizer] = None, *,
                           device=None):
    """Data-parallel ResNet step with the global batch's batch-norm
    statistics: the JAX package's jit step.

    Returns ``(step_fn, init_fn)``.  ``optimizer`` builds the inner
    optimizer from the parameters (default :func:`resnet_sgd`).
    ``init_fn(seed) -> ResNetState`` makes the model from ``seed`` and gives
    every rank rank 0's parameters and statistics.  ``step_fn(state,
    images, labels) -> (state, loss)`` takes this rank's ``[B, H, W, 3]``
    images and ``[B]`` labels (every rank the same B); each batch norm
    allreduces its per-channel mean and then its mean squared deviation
    inside the forward, so the statistics, the loss and the averaged
    gradient are those of the global batch.  The model, its statistics and
    the optimizer are updated in place.  Needs ``hvd.init()``."""
    return _resnet_step(cfg, optimizer, Compression.none, True, device,
                        "make_resnet_train_step()")


def make_resnet_train_step_hvd(cfg: resnet_model.ResNetConfig,
                               optimizer: Optional[MakeOptimizer] = None, *,
                               compression=Compression.none, device=None):
    """Classic-Horovod ResNet step: the JAX package's ``shard_map`` step.

    As :func:`make_resnet_train_step`, except that each rank's batch norms
    use its own slice's statistics, and after the step the new running
    statistics are averaged across the ranks (one fused allreduce).
    ``compression`` is the gradient allreduce's
    (:class:`~horovod_tpu_torch.ops.compression.Compression`)."""
    return _resnet_step(cfg, optimizer, compression, False, device,
                        "make_resnet_train_step_hvd()")


def mnist_adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The JAX package's default ``optax.adam(1e-3)``: same betas, eps added
    outside the square root as optax does."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def make_mnist_train_step(optimizer: Optional[MakeOptimizer] = None, *,
                          device=None):
    """Data-parallel MNIST step.  Returns ``(step_fn, init_fn)``:
    ``init_fn(seed) -> TrainState`` and ``step_fn(state, images, labels)
    -> (state, loss)`` with ``[B, 28, 28, 1]`` images, as the transformer's
    (default optimizer :func:`mnist_adam`).  Needs ``hvd.init()``."""
    dev = basics.resolve_device(device, "make_mnist_train_step()")
    make_inner = optimizer or mnist_adam

    def init_fn(seed: int) -> TrainState:
        model = _from_rank0(mnist_model.init(seed, device=dev))
        return TrainState(model, DistributedOptimizer(
            make_inner(model.parameters())), 0)

    def step_fn(state: TrainState, images, labels):
        state.optimizer.zero_grad(set_to_none=True)
        loss = mnist_model.loss_fn(state.model, images.to(dev),
                                   labels.to(dev))
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), C.allreduce(loss.detach())

    return step_fn, init_fn
