"""Pipeline parallelism over the ``pp`` mesh axis: the port of
``horovod_tpu/parallel/pipeline.py`` (GPipe).

Stage ``s`` of ``P`` holds the contiguous layers ``[s·L/P, (s+1)·L/P)``
(its *cell*; :func:`pipeline_param_specs`, :func:`stage_layers`), each
with its ``tp`` and ``ep`` shards, and a replica of ``embed`` and
``ln_f``.  The batch is cut into ``M`` microbatches (``M`` defaults to
``P``), and the schedule runs ``M + P - 1`` ticks: at tick ``t`` stage
``s`` applies its cell to microbatch ``t - s`` and sends the result to
stage ``s + 1``; stage 0 takes the microbatches in, the last stage
collects the outputs.  The port skips a stage's compute on the bubble
ticks, where it holds no microbatch (the JAX package computes them and
discards the results, so the values are the same): each stage runs its
cell exactly ``M`` times a forward, and each layer's flash kernels launch
``P·M`` times over the pipeline where the unpipelined model launches
them once.

Where the JAX package differentiates through its ``lax.scan`` schedule,
the port runs the backward schedule explicitly (:class:`_GPipe`): the
forward keeps each cell's graph (every layer rematerialised through
``torch.utils.checkpoint``), and the backward walks the ticks in reverse,
each stage taking its microbatch's output gradient from the stage after
it (the last stage from the loss), back-propagating through its cell and
sending the input gradient to the stage before it.  Every send has a
matching receive at the same tick, so no rank waits on a collective that
another skips.

The rest follows the JAX package:

* the embedding is computed on every stage and consumed by stage 0; the
  gradient of its output enters the pipeline on stage 0 and is summed
  over ``pp`` (``copy_to_axis``), so every stage's ``embed`` gets the
  lookup's gradient once;
* ``ln_f`` and the vocabulary projection run after the last stage, on
  every stage, over the output broadcast from the last stage: their
  gradients are the same on every stage and are not summed over ``pp``;
* the aux loss is summed over the valid ticks of every stage and divided
  by ``M``;
* a cell sees no mesh but its ``tp``/``ep`` regions and the ``dp`` axis
  (``_layer(h, lp, cfg, None)`` under GSPMD): ring and Ulysses attention
  run dense.  Flash attention runs its kernels at every ``dp``: the JAX
  package runs it dense where ``dp > 1``, because GSPMD cannot partition
  a ``pallas_call`` over ``dp``, but each ``dp`` rank here holds its rows
  of the microbatch as its own tensors (the same values);
* data are ``P('dp', None)``: the sequence is not split over ``sp``, and
  ``sp`` and ``dcn`` ranks hold replicas.  Microbatch ``m`` is global
  rows ``[m·B/M, (m+1)·B/M)`` of the batch, as the JAX package's reshape
  of the dp-sharded batch makes it; each ``dp`` rank runs its ``1/dp`` of
  every microbatch (so the MoE capacity and routing are the microbatch's),
  which needs ``B/M`` divisible by ``dp``.

:func:`loopback_pipeline` runs the ``P`` stages' schedule in one process on
the whole model, as ``ring_attention.loopback_attention`` runs the sp
gang's, so one card runs the kernels at the pipeline's shapes.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import group_watch
from horovod_tpu_torch.parallel import ring_attention as ra
from horovod_tpu_torch.parallel.mesh import Axis, Mesh, mesh_axis_size, \
    sub_axis
from horovod_tpu_torch.parallel.optimizer import DistributedOptimizer


def pipeline_param_specs(cfg: tfm.TransformerConfig):
    """The JAX package's ``pipeline_param_specs``: ``param_specs`` of the
    stacked-layer tree, its layer axis over ``pp``."""
    specs = tfm.param_specs(cfg)
    specs["layers"] = {k: ("pp",) + v for k, v in specs["layers"].items()}
    return specs


def stage_layers(n_layers: int, mesh) -> range:
    """The layers the stage of this rank holds (every layer without a
    ``pp`` axis)."""
    pp = 1 if mesh is None else mesh_axis_size(mesh, "pp")
    if n_layers % pp:
        raise ValueError(f"n_layers={n_layers} must divide over pp={pp}")
    k = n_layers // pp
    s = 0 if mesh is None else mesh.coords.get("pp", 0)
    return range(s * k, (s + 1) * k)


# exchange(sends, receivers, direction) -> received: ``sends`` maps each
# held stage that sends this tick to its tensor, bound for stage
# s + direction; ``receivers`` lists the held stages that receive one from
# stage s - direction.  Returns {receiving stage: tensor}.
Exchange = Callable[[Dict[int, torch.Tensor], List[int], int],
                    Dict[int, torch.Tensor]]


class _Schedule(NamedTuple):
    """The pipeline as one process runs it: ``cells`` maps each stage it
    holds to ``(stage_fn, params)``; ``finish(out)`` makes the last
    stage's ``[M, ...]`` output (None on a process without it) every
    stage's."""

    cells: Dict[int, tuple]
    n_stages: int
    exchange: Exchange
    finish: Callable


def _forward(sched: _Schedule, x_mb: torch.Tensor):
    P, M = sched.n_stages, x_mb.shape[0]
    saved, out, buf = {}, [None] * M, {}
    aux = x_mb.new_zeros((), dtype=torch.float32)
    for t in range(M + P - 1):
        sends = {}
        for s, (fn, _) in sched.cells.items():
            m = t - s
            if not 0 <= m < M:
                continue  # a bubble tick: this stage holds no microbatch
            x = (x_mb[m] if s == 0 else buf.pop(s)).detach().requires_grad_()
            y, a = fn(x)
            saved[s, m] = (x, y, a)
            aux = aux + a.detach()
            if s == P - 1:
                out[m] = y.detach()
            else:
                sends[s] = y.detach()
        recv = [s for s in sched.cells if s > 0 and 0 <= t - (s - 1) < M]
        buf = sched.exchange(sends, recv, 1)
    last = torch.stack(out) if P - 1 in sched.cells else None
    return sched.finish(last), aux, saved


def _backward(sched: _Schedule, saved, d_out, d_aux, x_mb):
    P, M = sched.n_stages, x_mb.shape[0]
    dx_mb = torch.zeros_like(x_mb)
    grads = {s: [None] * len(params) for s, (_, params) in
             sched.cells.items()}
    dbuf = {}
    for t in reversed(range(M + P - 1)):
        sends = {}
        for s, (_, params) in sched.cells.items():
            m = t - s
            if not 0 <= m < M:
                continue
            x, y, a = saved.pop((s, m))
            outs = [y] + ([a] if a.requires_grad else [])
            douts = [d_out[m] if s == P - 1 else dbuf.pop(s)]
            douts += [d_aux] if a.requires_grad else []
            g = torch.autograd.grad(outs, [x] + list(params), douts,
                                    allow_unused=True)
            for i, gi in enumerate(g[1:]):
                if gi is not None:
                    acc = grads[s][i]
                    grads[s][i] = gi if acc is None else acc + gi
            if s == 0:
                dx_mb[m] = g[0]
            else:
                sends[s] = g[0]
        recv = [s for s in sched.cells
                if s < P - 1 and 0 <= t - (s + 1) < M]
        dbuf = sched.exchange(sends, recv, -1)
    return dx_mb, [g for s in sched.cells for g in grads[s]]


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node: its inputs are the microbatches
    and every held stage's parameters, its outputs the last stage's
    ``[M, ...]`` outputs (every stage's copy) and the held stages' summed
    aux losses."""

    @staticmethod
    def forward(ctx, sched, x_mb, *params):
        with torch.enable_grad():
            out, aux, saved = _forward(sched, x_mb)
        ctx.sched, ctx.saved = sched, saved
        ctx.save_for_backward(x_mb)
        return out, aux

    @staticmethod
    def backward(ctx, d_out, d_aux):
        (x_mb,) = ctx.saved_tensors
        dx_mb, dparams = _backward(ctx.sched, ctx.saved, d_out, d_aux, x_mb)
        ctx.saved = None
        return (None, dx_mb) + tuple(dparams)


def _gang_exchange(axis: Axis, like: torch.Tensor) -> Exchange:
    def exchange(sends, recv, direction):
        ops, got = [], {}
        for s, x in sends.items():
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  axis.ranks[s + direction],
                                  group=axis.group))
        for s in recv:
            got[s] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got[s],
                                  axis.ranks[s - direction],
                                  group=axis.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            group_watch.record(axis.ranks)
        return got

    return exchange


def _loopback_exchange(sends, recv, direction):
    return {s + direction: x for s, x in sends.items()}


# The process groups whose ranks have all joined one collective: NCCL
# creates a group's communicator at its first use, and a batch of sends and
# receives among some of its ranks cannot create it.
_joined = weakref.WeakSet()


def _join_once(axis: Axis) -> None:
    group = axis.group or dist.group.WORLD
    if group not in _joined:
        C.barrier(axis)
        _joined.add(group)


def gpipe(stage_fn, x_mb: torch.Tensor, axis: Axis, params=()):
    """Run ``stage_fn`` over the microbatches ``x_mb`` (``[M, ...]``)
    through the stages of ``axis``, this rank being the stage at its index.
    ``stage_fn(x) -> (y, aux)`` applies this stage's cell (``y`` shaped as
    ``x``), ``params`` are the tensors it differentiates.  Only stage 0's
    ``x_mb`` is read.  Returns ``([M, ...] outputs, total aux)``, both the
    same on every stage; differentiable (see the module docstring)."""
    P = axis.size

    def finish(out):
        return C.broadcast(torch.zeros_like(x_mb) if out is None else out,
                           root_rank=P - 1, axis=axis)

    params = list(params)
    sched = _Schedule({axis.index: (stage_fn, params)}, P,
                      _gang_exchange(axis, x_mb[0]), finish)
    _join_once(axis)
    out, aux = _GPipe.apply(sched, x_mb, *params)
    return out, C.reduce_from_axis(aux, axis)


def _cell_attention(cfg: tfm.TransformerConfig):
    """Attention inside a cell: the JAX package's dispatch with no mesh
    (flash at every dp; see the module docstring)."""
    if cfg.attn_impl == "flash":
        return functools.partial(flash_attention, causal=True)
    return functools.partial(ra.full_attention, causal=True)


def _stage_fn(blocks, cfg, attend, lay, remat):
    def fn(h):
        aux = h.new_zeros((), dtype=torch.float32)
        for blk in blocks:
            if remat:
                h, a = checkpoint(tfm._layer, h, blk, cfg, attend, 0, lay,
                                  None, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, a = tfm._layer(h, blk, cfg, attend, 0, lay)
            if a is not None:
                aux = aux + a
        return h, aux

    return fn


def _rows(batch: int, M: int, mesh) -> List[int]:
    """The global rows a ``dp`` rank runs, in microbatch order: its
    ``1/dp`` of each microbatch ``[m·B/M, (m+1)·B/M)``."""
    dp = 1 if mesh is None else mesh_axis_size(mesh, "dp")
    i = 0 if mesh is None else mesh.coords.get("dp", 0)
    if batch % M:
        raise ValueError(f"batch {batch} not divisible by {M} microbatches")
    if (batch // M) % dp:
        raise ValueError(f"a microbatch of {batch // M} rows does not split "
                         f"over dp={dp}")
    b = batch // M // dp
    return [m * (batch // M) + i * b + r for m in range(M) for r in range(b)]


def _microbatch_rows(x: torch.Tensor, M: int, mesh) -> torch.Tensor:
    """This rank's rows of the pipeline, from its ``P('dp', None)`` slice
    ``x`` of the global batch (gathered over ``dp``)."""
    dp = 1 if mesh is None else mesh_axis_size(mesh, "dp")
    rows = _rows(x.shape[0] * dp, M, mesh)
    if dp > 1:
        x = C.allgather(x, axis=mesh.axis("dp"))
    return x[torch.tensor(rows, device=x.device)]


def _pipelined(model: tfm.Transformer, tokens, M: int, mesh, n_stages,
               remat):
    """The pipelined forward: over the ``pp`` axis of ``mesh`` (this rank's
    stage model), or ``n_stages`` stages in this process (the whole
    model).  ``tokens`` are this rank's rows, in microbatch order."""
    cfg = model.cfg
    remat = cfg.remat if remat is None else remat
    lay = tfm._layout(mesh, data=("dp",))
    attend = _cell_attention(cfg)
    x = tfm._embed(model.embed, tokens, lay.tp).to(cfg.compute_dtype)
    B, S, D = x.shape
    x_mb = x.view(M, B // M, S, D)
    if mesh is not None:
        axis = mesh.axis("pp")
        params = list(model.layers.parameters())
        out, aux = gpipe(_stage_fn(model.layers, cfg, attend, lay, remat),
                         C.copy_to_axis(x_mb, axis), axis, params)
    else:
        k = cfg.n_layers // n_stages
        cells, params = {}, []
        for s in range(n_stages):
            blocks = model.layers[s * k:(s + 1) * k]
            cells[s] = (_stage_fn(blocks, cfg, attend, lay, remat),
                        list(blocks.parameters()))
            params += cells[s][1]
        sched = _Schedule(cells, n_stages, _loopback_exchange,
                          lambda out: out)
        out, aux = _GPipe.apply(sched, x_mb, *params)
    x = tfm._rmsnorm(out.reshape(B, S, D), model.ln_f)
    return (tfm.vocab_projection(C.copy_to_axis(x, lay.tp), model.embed),
            aux / M)


def _stages(cfg: tfm.TransformerConfig, mesh, n_stages) -> int:
    if (mesh is None) == (n_stages is None):
        raise ValueError("give either mesh (a gang over its pp axis) or "
                         "n_stages (every stage in this process)")
    P = mesh_axis_size(mesh, "pp") if mesh is not None else int(n_stages)
    if cfg.n_layers % P:
        raise ValueError(f"n_layers={cfg.n_layers} must divide over pp={P}")
    return P


def pipeline_apply(model: tfm.Transformer, tokens: torch.Tensor, mesh, *,
                   n_microbatches: Optional[int] = None,
                   remat: Optional[bool] = None):
    """Pipelined forward of a stage's model (:func:`init_stage`) over the
    ``pp`` axis of ``mesh``.  ``tokens`` are this rank's ``[B/dp, S]``
    slice of a ``P('dp', None)`` batch.  Returns ``(logits_fp32, aux)`` for
    the rows :func:`pipeline_rows` names, in that order (over ``tp`` the
    rank's vocabulary block); without ``pp > 1``, ``transformer.apply``."""
    P = _stages(model.cfg, mesh, None)
    if P <= 1:
        return tfm.apply(model, tokens, mesh=mesh, remat=remat)
    M = n_microbatches or P
    return _pipelined(model, _microbatch_rows(tokens, M, mesh), M, mesh,
                      None, remat)


def loopback_pipeline(model: tfm.Transformer, tokens: torch.Tensor,
                      n_stages: int, *, n_microbatches: Optional[int] = None,
                      remat: Optional[bool] = None):
    """Run the schedule of ``n_stages`` stages in this one process on the
    whole model (stage ``s`` its layers ``[s·L/P, (s+1)·L/P)``), on the
    whole ``[B, S]`` batch: ``(logits_fp32, aux)``.  The activations pass
    from stage to stage as tensors, so the kernels see the shapes they see
    in a gang, microbatch by microbatch."""
    P = _stages(model.cfg, None, n_stages)
    M = n_microbatches or P
    _rows(tokens.shape[0], M, None)
    return _pipelined(model, tokens, M, None, P, remat)


def pipeline_rows(batch: int, mesh, *, n_microbatches: Optional[int] = None
                  ) -> List[int]:
    """The rows of the global ``[batch, S]`` batch that this rank's
    :func:`pipeline_apply` returns logits for, in order: its ``1/dp`` of
    each microbatch (every row where ``dp`` is 1)."""
    M = n_microbatches or mesh_axis_size(mesh, "pp")
    return _rows(batch, M, mesh)


def pipeline_loss_fn(model: tfm.Transformer, tokens, targets, mesh=None, *,
                     n_stages: Optional[int] = None,
                     n_microbatches: Optional[int] = None,
                     aux_weight: float = 0.01):
    """Mean cross-entropy over this rank's rows of the pipelined forward
    plus ``aux_weight`` times its aux loss: over the ``pp`` axis of
    ``mesh`` (``tokens``/``targets`` this rank's ``P('dp', None)`` slice),
    or through :func:`loopback_pipeline` with ``n_stages``."""
    P = _stages(model.cfg, mesh, n_stages)
    M = n_microbatches or P
    tp = None
    if mesh is None:
        logits, aux = loopback_pipeline(model, tokens, P, n_microbatches=M)
    else:
        logits, aux = pipeline_apply(model, tokens, mesh, n_microbatches=M)
        if P > 1:
            targets = _microbatch_rows(targets, M, mesh)
        if mesh_axis_size(mesh, "tp") > 1:
            tp = mesh.axis("tp")
    return tfm.softmax_xent(logits, targets, tp) + aux_weight * aux


class PipelineTrainState(NamedTuple):
    model: tfm.Transformer
    optimizer: DistributedOptimizer
    step: int


def init_stage(seed: int, cfg: tfm.TransformerConfig, *, device=None,
               mesh: Optional[Mesh] = None) -> tfm.Transformer:
    """``transformer.init``'s model (the whole model drawn from ``seed``,
    this rank's ``tp``/``ep`` shard) keeping only the layers of this
    rank's stage (:func:`stage_layers`), renumbered from 0."""
    model = tfm.init(seed, cfg, device=device, mesh=mesh)
    keep = stage_layers(cfg.n_layers, mesh)
    model.layers = torch.nn.ModuleList(model.layers[i] for i in keep)
    return model


def make_pipeline_train_step(cfg: tfm.TransformerConfig, optimizer=None, *,
                             mesh: Optional[Mesh] = None,
                             n_stages: Optional[int] = None,
                             n_microbatches: Optional[int] = None,
                             device=None):
    """The pipelined twin of ``make_transformer_train_step``: returns
    ``(step_fn, init_fn)``.

    Over ``mesh``, each rank is the stage at its ``pp`` index and holds
    that stage's layers (:func:`init_stage`); ``step_fn(state, tokens,
    targets) -> (state, loss)`` takes this rank's ``[B/dp, S]`` slice of
    a ``P('dp', None)`` batch, runs :func:`pipeline_loss_fn`, averages the
    gradients over ``dp`` (the stages' layers are their own, and
    ``embed``/``ln_f`` already agree over ``pp``) and returns the loss of
    the global batch.  With ``n_stages`` and no mesh, the loopback: the
    whole model in this process, every stage's schedule run here
    (:func:`loopback_pipeline`), gradients averaged over every rank.
    ``optimizer`` builds the inner optimizer (default AdamW(1e-3, wd
    0.01)).  Needs ``hvd.init()``."""
    from horovod_tpu_torch.parallel import train

    P = _stages(cfg, mesh, n_stages)
    if mesh is not None:
        tfm.check_mesh(cfg, mesh)
    dev = basics.resolve_device(device, "make_pipeline_train_step()")
    make_inner = optimizer or train.default_optimizer

    def init_fn(seed: int) -> PipelineTrainState:
        axis = None if mesh is None else sub_axis(mesh, ("dp",))
        if mesh is None:
            model = tfm.init(seed, cfg, device=dev)
        else:
            model = init_stage(seed, cfg, device=dev, mesh=mesh)
        model = train._from_rank0(model, axis)
        opt = DistributedOptimizer(make_inner(model.parameters()), axis=axis,
                                   nonfinite_policy="off")
        return PipelineTrainState(model, opt, 0)

    def step_fn(state: PipelineTrainState, tokens, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = pipeline_loss_fn(
            state.model, tokens.to(dev), targets.to(dev), mesh,
            n_stages=None if mesh is not None else P,
            n_microbatches=n_microbatches)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), C.allreduce(
            loss.detach(), axis=state.optimizer.axis)

    return step_fn, init_fn
