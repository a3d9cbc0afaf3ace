"""Data-parallel training step: the port of
``horovod_tpu/parallel/train.py::make_transformer_train_step``.

Every rank holds the whole model and its own slice of the batch.  One step
is forward, backward, one fused gradient allreduce through
:class:`DistributedOptimizer` (where the JAX package let GSPMD infer the
reduction over ``dp``), and the optimizer update.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel.optimizer import DistributedOptimizer


class TrainState(NamedTuple):
    model: tfm.Transformer
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
    optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]],
                                 torch.optim.Optimizer]] = None,
    *,
    device=None,
):
    """Returns ``(step_fn, init_fn)``.

    ``optimizer`` builds the inner optimizer from the parameters (default
    :func:`default_optimizer`).  ``init_fn(seed) -> TrainState`` makes the
    model from ``seed`` and gives every rank rank 0's weights.
    ``step_fn(state, tokens, targets) -> (state, loss)`` takes this rank's
    ``[B, S]`` slice of the batch and returns this rank's mean loss; the
    model and optimizer are updated in place.  Needs ``hvd.init()``."""
    dev = basics.resolve_device(device, "make_transformer_train_step()")
    make_inner = optimizer or default_optimizer

    def init_fn(seed: int) -> TrainState:
        model = tfm.init(seed, cfg, device=dev)
        if basics.size() > 1:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(C.broadcast(p.detach(), root_rank=0))
        opt = DistributedOptimizer(make_inner(model.parameters()))
        return TrainState(model, opt, 0)

    def step_fn(state: TrainState, tokens, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = tfm.loss_fn(state.model, tokens.to(dev), targets.to(dev))
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    return step_fn, init_fn
