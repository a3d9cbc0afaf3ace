"""Worker for the classic torch front-end's and the bridge's gangs
(``tests/test_torch_frontend.py``, ``tests/test_torch_bridge.py``).

    python tests/torch_port_frontend_worker.py <package> <cases> <out_dir>

``<package>`` is ``port`` (``import horovod_tpu_torch.torch as hvd``, with
no torch process group) or ``jax`` (``import horovod_tpu.torch as hvd``;
the caller sets ``HVD_TPU_CORE=py`` and ``JAX_PLATFORMS=cpu``).  The
rank, size and rendezvous come from ``HVD_*`` as the launcher sets them.
Every case (comma-separated in ``<cases>``) runs on inputs made from a
seed with numpy, the same bits in both packages, and the worker writes
each result as ``(dtype name, shape, bytes)`` to ``<out_dir>/rank<r>.pkl``,
with ``SCENARIO_OK <case>`` on stdout per case that ran.  The port rank
imports no JAX.  ``FRONTEND_DEVICE`` names a port rank's device (the
``card_*`` cases run on ``cuda:0``).
"""

import os
import pickle
import sys
import traceback
import warnings
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The front-end under test, bound by main() from the command line (the
# tests import this module for its seeded inputs alone).
PKG = hvd = ProcessSet = None


def _bind(pkg):
    global PKG, hvd, ProcessSet
    PKG = pkg
    if pkg == "jax":
        import horovod_tpu.torch as hvd
        from horovod_tpu.process_sets import ProcessSet
    else:
        import horovod_tpu_torch.torch as hvd
        from horovod_tpu_torch.process_sets import ProcessSet


def rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def tensor(key, shape, dtype="float32", scale=3.0):
    r = rng(*key)
    if dtype in ("int32", "int64"):
        return torch.from_numpy(r.integers(-20, 20, shape).astype(dtype))
    return torch.from_numpy((r.standard_normal(shape) * scale)
                            .astype(dtype))


def rec(out, key, t):
    if isinstance(t, (bool, int, float)):
        t = torch.tensor(t)
    t = t.detach().cpu().contiguous()
    out[key] = (str(t.dtype), tuple(t.shape), t.numpy().tobytes())


class MLP(torch.nn.Module):
    """A small MLP whose weights come from a numpy seed."""

    def __init__(self, seed, widths=(6, 8, 3)):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                layer.weight.copy_(tensor(("w", seed, i),
                                          tuple(layer.weight.shape),
                                          scale=0.5))
                layer.bias.copy_(tensor(("b", seed, i),
                                        tuple(layer.bias.shape), scale=0.1))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = torch.tanh(x)
        return x


def batch(rank, step, rows=4):
    return (tensor(("x", rank, step), (rows, 6)),
            tensor(("y", rank, step), (rows, 3)))


def loss_of(model, x, y):
    return ((model(x) - y) ** 2).mean()


def params(out, key, model):
    for n, p in model.named_parameters():
        rec(out, f"{key}.{n}", p)


# ---------------------------------------------------------------------------
# the front-end's cases


def case_ops(out):
    rank, size = hvd.rank(), hvd.size()
    for dt in ("float32", "float64", "float16", "int32", "int64"):
        x = tensor(("ar", dt, rank), (5, 7), dt)
        ops = [hvd.Sum, hvd.Min, hvd.Max, hvd.Product]
        if dt.startswith("float"):
            ops.append(hvd.Average)
        for op in ops:
            rec(out, f"allreduce.{dt}.{int(op)}",
                hvd.allreduce(x, op=op, name=f"ar.{dt}.{int(op)}"))
        if dt in ("float32", "float64"):
            rec(out, f"allreduce.scaled.{dt}",
                hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5,
                              postscale_factor=3.0, name=f"ar.sc.{dt}"))
        # in place: the caller's tensor is the result
        y = x.clone()
        ret = hvd.allreduce_(y, op=hvd.Sum, name=f"ar_.{dt}")
        rec(out, f"allreduce_.is_input.{dt}", ret is y)
        rec(out, f"allreduce_.{dt}", y)
        # async handles, synchronized out of order
        hs = [hvd.allreduce_async(x + i, op=hvd.Sum, name=f"ara.{dt}.{i}")
              for i in range(3)]
        for i in (2, 0, 1):
            rec(out, f"allreduce_async.{dt}.{i}", hvd.synchronize(hs[i]))
        y = x.clone()
        h = hvd.allreduce_async_(y, op=hvd.Max, name=f"ara_.{dt}")
        rec(out, f"allreduce_async_.is_input.{dt}", hvd.synchronize(h) is y)
        rec(out, f"allreduce_async_.{dt}", y)
        # grouped
        grp = [tensor(("grp", dt, rank, i), (3 + i,), dt) for i in range(3)]
        for i, t in enumerate(hvd.grouped_allreduce(grp, op=hvd.Sum,
                                                    name=f"grp.{dt}")):
            rec(out, f"grouped.{dt}.{i}", t)
        hs = hvd.grouped_allreduce_async(grp, op=hvd.Sum, name=f"grpa.{dt}")
        for i, h in enumerate(hs):
            rec(out, f"grouped_async.{dt}.{i}", hvd.synchronize(h))
        # ragged allgather
        g = tensor(("ag", dt, rank), (rank + 1, 3), dt)
        rec(out, f"allgather.{dt}", hvd.allgather(g, name=f"ag.{dt}"))
        rec(out, f"allgather_async.{dt}", hvd.synchronize(
            hvd.allgather_async(g, name=f"aga.{dt}")))
        # reducescatter at uneven rows
        rs = tensor(("rs", dt, rank), (7, 2), dt)
        rec(out, f"reducescatter.{dt}",
            hvd.reducescatter(rs, op=hvd.Sum, name=f"rs.{dt}"))
        rec(out, f"reducescatter_async.{dt}", hvd.synchronize(
            hvd.reducescatter_async(rs, op=hvd.Max, name=f"rsa.{dt}")))
        # broadcast from every root, and in place
        for root in range(size):
            rec(out, f"broadcast.{dt}.{root}",
                hvd.broadcast(x, root, name=f"bc.{dt}.{root}"))
        y = x.clone()
        rec(out, f"broadcast_.is_input.{dt}",
            hvd.broadcast_(y, size - 1, name=f"bc_.{dt}") is y)
        rec(out, f"broadcast_.{dt}", y)
        y = x.clone()
        hvd.synchronize(hvd.broadcast_async_(y, 0, name=f"bca_.{dt}"))
        rec(out, f"broadcast_async_.{dt}", y)
        # alltoall, equal and with splits
        a = tensor(("a2a", dt, rank), (2 * size, 2), dt)
        rec(out, f"alltoall.{dt}", hvd.alltoall(a, name=f"a2a.{dt}"))
        splits = [1 + (rank + j) % 2 for j in range(size)]
        a = tensor(("a2as", dt, rank), (sum(splits), 2), dt)
        got, recv = hvd.alltoall(a, splits=splits, name=f"a2as.{dt}")
        rec(out, f"alltoall_splits.{dt}", got)
        rec(out, f"alltoall_splits.recv.{dt}", recv)
    x = tensor(("fp16c", rank), (9,))
    rec(out, "compression.fp16",
        hvd.allreduce(x, op=hvd.Sum, name="fp16c",
                      compression=hvd.Compression.fp16))
    # auto names: the same counters in both packages
    rec(out, "autoname", hvd.allreduce(x, op=hvd.Sum))
    rec(out, "object", torch.tensor(hvd.broadcast_object(
        [rank, 7] if rank == 1 else None, root_rank=1)))
    hvd.barrier()


def case_grads(out):
    rank, size = hvd.rank(), hvd.size()
    w = tensor(("gw", rank), (4,))
    x = tensor(("gx", rank), (4,)).requires_grad_()
    (hvd.allreduce(x * w, op=hvd.Sum, name="g.ar") * w).sum().backward()
    rec(out, "allreduce.sum", x.grad)
    x = tensor(("gx2", rank), (4,)).requires_grad_()
    (hvd.allreduce(x, name="g.avg") * w).sum().backward()
    rec(out, "allreduce.avg", x.grad)
    x = tensor(("gag", rank), (2, 3)).requires_grad_()
    up = tensor(("gup", rank), (2 * size, 3))
    (hvd.allgather(x, name="g.ag") * up).sum().backward()
    rec(out, "allgather", x.grad)
    x = tensor(("gagr", rank), (rank + 1, 2)).requires_grad_()
    up = tensor(("gupr", rank), (sum(r + 1 for r in range(size)), 2))
    (hvd.allgather(x, name="g.ag.ragged") * up).sum().backward()
    rec(out, "allgather.ragged", x.grad)
    for root in range(size):
        x = tensor(("gbc", rank, root), (3,)).requires_grad_()
        (hvd.broadcast(x, root, name=f"g.bc.{root}") * w[:3]).sum() \
            .backward()
        rec(out, f"broadcast.{root}", x.grad)


def _train(model, opt, steps, passes=1, key="opt"):
    rank = hvd.rank()
    for s in range(steps):
        opt.zero_grad()
        for m in range(passes):
            x, y = batch(rank, (key, s, m))
            loss_of(model, x, y).backward()
        opt.step()


def case_optimizer(out):
    rank = hvd.rank()
    model = MLP(0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    _train(model, opt, 3)
    params(out, "sgd", model)
    # gradients accumulated locally over two backward passes a step
    model = MLP(1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    _train(model, opt, 2, passes=2, key="acc")
    params(out, "accumulate", model)
    # a third pass before step() is refused
    opt.zero_grad()
    for m in range(2):
        x, y = batch(rank, ("acc3", m))
        loss_of(model, x, y).backward()
    x, y = batch(rank, ("acc3", 2))
    try:
        loss_of(model, x, y).backward()
        rec(out, "accumulate.third_pass_refused", False)
    except AssertionError:
        rec(out, "accumulate.third_pass_refused", True)
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    # zero_grad() between backward() and step() is a race: refused
    model = MLP(2)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    x, y = batch(rank, "zg")
    loss_of(model, x, y).backward()
    try:
        opt.zero_grad()
        rec(out, "zero_grad_refused", False)
    except AssertionError:
        rec(out, "zero_grad_refused", True)
    # synchronize() then step() without skip_synchronize() warns;
    # within it, no warning
    opt.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        opt.step()
    rec(out, "step_after_synchronize_warns",
        any("skip_synchronize" in str(w.message) for w in caught))
    opt.zero_grad()
    loss_of(model, x, y).backward()
    opt.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with opt.skip_synchronize():
            opt.step()
    rec(out, "skip_synchronize_quiet", not caught)
    params(out, "zero_grad", model)
    # a parameter without a gradient this step is reduced from zeros
    model = MLP(3)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    x, y = batch(rank, "nograd")
    h = torch.tanh(model.layers[0](x))
    (h.sum() * 0.1).backward()  # layer 1 gets no gradient
    opt.step()
    params(out, "missing_grad", model)


def case_process_set(out):
    rank, size = hvd.rank(), hvd.size()
    pair = ProcessSet(list(range(size)))
    last = ProcessSet([size - 1])
    model = MLP(4)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), process_set=pair)
    _train(model, opt, 2, key="ps")
    params(out, "pair", model)
    if rank == size - 1:
        x = tensor(("ps1", rank), (5,))
        rec(out, "alone", hvd.allreduce(x, op=hvd.Sum, name="ps.alone",
                                        process_set=last))
    rec(out, "pair.allgather", hvd.allgather(
        tensor(("psag", rank), (2, 2)), name="ps.ag", process_set=pair))
    hvd.barrier()


def case_join(out):
    rank, size = hvd.rank(), hvd.size()
    for b in range(rank + 2):
        rec(out, f"join.{b}", hvd.allreduce(
            tensor(("jn", rank, b), (4,)), op=hvd.Sum, name=f"jn.{b}"))
    rec(out, "join.last", hvd.join())


def case_broadcast_state(out):
    rank = hvd.rank()
    # SGD with momentum, from unequal starts, the root's state empty: the
    # root makes it by a zero-gradient step
    model = MLP(10 + rank)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    params(out, "sgd.start", model)
    for i, st in sorted(opt.state_dict()["state"].items()):
        rec(out, f"sgd.momentum.{i}", st["momentum_buffer"])
    _train(model, opt, 2, key="bos.sgd")
    params(out, "sgd.trained", model)
    # Adam from unequal starts and unequal states: each rank steps alone
    # first (no engine), then the root's state wins
    model = MLP(20 + rank)
    inner = torch.optim.Adam(model.parameters(), lr=0.01)
    x, y = batch(rank, "bos.local")
    loss_of(model, x, y).backward()
    inner.step()
    inner.zero_grad()
    opt = hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=1)
    hvd.broadcast_optimizer_state(opt, root_rank=1)
    params(out, "adam.start", model)
    for i, st in sorted(opt.state_dict()["state"].items()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            rec(out, f"adam.{k}.{i}", st[k])
    rec(out, "adam.lr", opt.param_groups[0]["lr"])
    _train(model, opt, 2, key="bos.adam")
    params(out, "adam.trained", model)
    try:
        hvd.broadcast_optimizer_state(
            torch.optim.LBFGS(model.parameters()), root_rank=0)
        rec(out, "lbfgs_refused", False)
    except ValueError:
        rec(out, "lbfgs_refused", True)


def case_adasum(out):
    rank = hvd.rank()
    x = tensor(("ad", rank), (53,))
    rec(out, "allreduce", hvd.allreduce(x, op=hvd.Adasum, name="ad.ar"))
    model = torch.nn.Linear(13, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(tensor(("adw", rank), (1, 13)))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), op=hvd.Adasum)
    rec(out, "start", model.weight)  # rank 0's, broadcast at construction
    for s in range(2):
        model.weight.grad = tensor(("adg", rank, s), (1, 13))
        opt.step()
        rec(out, f"step{s}", model.weight)
        rec(out, f"grad{s}", model.weight.grad)
    try:
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1),
                                 op=hvd.Adasum, backward_passes_per_step=2)
        rec(out, "accumulate_refused", False)
    except ValueError:
        rec(out, "accumulate_refused", True)


# ---------------------------------------------------------------------------
# the bridge's cases (port ranks: custom ops under torch.compile; a JAX
# rank: horovod_tpu.ops.bridge under jit)


def case_bridge(out):
    from torch._dynamo.utils import counters

    from horovod_tpu_torch.ops import bridge

    rank, size = hvd.rank(), hvd.size()
    grads = [tensor(("bg", rank, i), s) for i, s in
             enumerate([(4, 3), (7,), (2, 2, 2), (1,)])]
    grads.append(tensor(("bgi", rank), (5,), "int32"))

    def reduce(gs):
        return bridge.grouped_allreduce(gs, name="br.grouped")

    compiled = torch.compile(reduce, fullgraph=True, backend="aot_eager")
    for i, t in enumerate(compiled(grads)):
        rec(out, f"grouped.compiled.{i}", t)
    for i, t in enumerate(bridge.grouped_allreduce(grads,
                                                   name="br.grouped")):
        rec(out, f"grouped.bridge_eager.{i}", t)
    for i, t in enumerate(hvd.grouped_allreduce(grads, name="br.grouped")):
        rec(out, f"grouped.eager.{i}", t)

    x = tensor(("bx", rank), (6, 4))
    mixed = torch.compile(lambda t: (
        bridge.allreduce(t, name="br.ar", op=hvd.Sum),
        bridge.allgather(t, name="br.ag"),
        bridge.broadcast(t, 1, name="br.bc"),
        bridge.alltoall(t, name="br.a2a"),
        bridge.barrier()), fullgraph=True, backend="aot_eager")
    for k, t in zip(("allreduce", "allgather", "broadcast", "alltoall",
                     "barrier"), mixed(x)):
        rec(out, f"{k}.compiled", t)
    rec(out, "allreduce.eager", hvd.allreduce(x, op=hvd.Sum, name="br.ar"))
    rec(out, "allgather.eager", hvd.allgather(x, name="br.ag"))
    rec(out, "broadcast.eager", hvd.broadcast(x, 1, name="br.bc"))
    rec(out, "alltoall.eager", hvd.alltoall(x, name="br.a2a"))
    # reducescatter at uneven rows: this rank's near-equal chunk
    for rows in (7, 8, 1):
        rs = tensor(("brs", rank, rows), (rows, 3))
        # The name as a default argument: a string stays a constant, where
        # an int that changes between compiles is traced as a symbol.
        fn = torch.compile(
            lambda t, nm=f"br.rs.{rows}": bridge.reducescatter(
                t, name=nm, op=hvd.Sum), fullgraph=True,
            backend="aot_eager")
        rec(out, f"reducescatter.compiled.{rows}", fn(rs))
        rec(out, f"reducescatter.eager.{rows}",
            hvd.reducescatter(rs, op=hvd.Sum, name=f"br.rs.{rows}"))

    # gradients by the JAX bridge's rules
    w = tensor(("bw", rank), (6, 4))

    def loss(t):
        a = bridge.allreduce(t, name="brg.ar", op=hvd.Average)
        g = bridge.allgather(t * 2, name="brg.ag")
        b = bridge.broadcast(t, 0, name="brg.bc")
        gs = bridge.grouped_allreduce([t, t * t], name="brg.grp",
                                      op=hvd.Sum)
        return ((a * w).sum() + (g[: 6 * size] ** 2).sum() * 0.5
                + (b * w).sum() + (gs[0] * w).sum() + gs[1].sum())

    t = tensor(("bt", rank), (6, 4)).requires_grad_()
    torch.compile(loss, fullgraph=True, backend="aot_eager")(t).backward()
    rec(out, "grad.compiled", t.grad)
    t2 = tensor(("bt", rank), (6, 4)).requires_grad_()
    loss(t2).backward()
    rec(out, "grad.bridge_eager", t2.grad)
    rec(out, "graph_breaks", sum(counters["graph_break"].values()))

    # torch.library.opcheck on each op, on the live gang
    from torch.library import opcheck

    ops = torch.ops.horovod_tpu_torch
    checks = {
        "allreduce": (tensor(("oc", rank), (3,)).requires_grad_(),
                      "oc.ar", int(hvd.Sum), 1.0, 1.0, None, 0),
        "grouped_allreduce": ([tensor(("oc1", rank), (3,))
                               .requires_grad_(),
                               tensor(("oc2", rank), (2, 2))],
                              "oc.grp", int(hvd.Average), None, 0),
        "allgather": (tensor(("oc3", rank), (2, 3)).requires_grad_(),
                      "oc.ag", 0),
        "broadcast": (tensor(("oc4", rank), (3,)).requires_grad_(),
                      "oc.bc", 0, 0),
        "reducescatter": (tensor(("oc5", rank), (5, 2)), "oc.rs",
                          int(hvd.Sum), 0),
        "alltoall": (tensor(("oc6", rank), (2 * size, 2)), "oc.a2a", 0),
        "barrier": (0,),
    }
    for name, args in checks.items():
        res = opcheck(getattr(ops, name).default, args)
        rec(out, f"opcheck.{name}", set(res.values()) == {"SUCCESS"})

    # under torch.func.vmap: a named error, not a hang
    try:
        torch.func.vmap(lambda v: bridge.allreduce(v, name="br.vmap"))(
            torch.ones(2, 3))
        rec(out, "vmap_refused", False)
    except TypeError as e:
        rec(out, "vmap_refused", "torch.func.vmap" in str(e))


def case_bridge_mixed(out):
    """The same grouped reduction from a JAX rank (``jit``) and a port rank
    (``torch.compile``), negotiated together under the same names."""
    rank = hvd.rank()
    grads = [tensor(("bm", rank, i), s).numpy() for i, s in
             enumerate([(4, 3), (7,), (2, 2, 2)])]
    if PKG == "jax":
        import jax

        from horovod_tpu.ops import bridge as jbridge

        outs = jax.jit(lambda gs: jbridge.grouped_allreduce(
            gs, name="mix.grouped"))([jax.numpy.asarray(g) for g in grads])
        outs = [torch.from_numpy(np.asarray(o)) for o in outs]
        single = torch.from_numpy(np.asarray(jax.jit(
            lambda t: jbridge.allreduce(t, name="mix.ar"))(grads[0])))
    else:
        from horovod_tpu_torch.ops import bridge

        outs = torch.compile(lambda gs: bridge.grouped_allreduce(
            gs, name="mix.grouped"), fullgraph=True, backend="aot_eager")(
            [torch.from_numpy(g) for g in grads])
        single = torch.compile(lambda t: bridge.allreduce(
            t, name="mix.ar"), fullgraph=True, backend="aot_eager")(
            torch.from_numpy(grads[0]))
    for i, t in enumerate(outs):
        rec(out, f"grouped.{i}", t)
    rec(out, "allreduce", single)


# ---------------------------------------------------------------------------
# on the card (port ranks sharing cuda:0; ``FRONTEND_DEVICE=cuda:0``)


def case_card_inplace(out):
    """In-place forms keep the caller's CUDA storage, and give the bits of
    the same op on host copies."""
    rank, dev = hvd.rank(), torch.device("cuda", 0)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        host = tensor(("ci", rank, tag), (4097,)).to(dt)
        for form, fn in (
                ("allreduce_", lambda t, nm: hvd.allreduce_(
                    t, op=hvd.Sum, name=nm)),
                ("allreduce_async_", lambda t, nm: hvd.synchronize(
                    hvd.allreduce_async_(t, op=hvd.Max, name=nm))),
                ("broadcast_", lambda t, nm: hvd.broadcast_(t, 1, name=nm)),
                ("broadcast_async_", lambda t, nm: hvd.synchronize(
                    hvd.broadcast_async_(t, 0, name=nm)))):
            x = host.to(dev)
            ptr = x.data_ptr()
            ret = fn(x, f"ci.{form}.{tag}")
            rec(out, f"{form}.{tag}.same_storage",
                ret is x and x.data_ptr() == ptr and x.device == dev
                and x.dtype == dt)
            y = host.clone()
            fn(y, f"ci.{form}.{tag}.host")
            bits = torch.int32 if dt == torch.float32 else torch.int16
            rec(out, f"{form}.{tag}.host_bits",
                torch.equal(x.cpu().view(bits), y.view(bits)))


def case_card_race(out):
    """A long backward on the card whose last layer's gradients are the
    first to finish: the hooks enqueue them while the earlier layers'
    kernels are still queued.  The averaged gradients must be the bits of
    the ranks' own gradients, taken without hooks, averaged afterwards."""
    rank, dev = hvd.rank(), torch.device("cuda", 0)
    width, depth, rows = 1024, 24, 8192
    gen = torch.Generator(device=dev).manual_seed(0)
    model = torch.nn.Sequential(*[torch.nn.Linear(width, width)
                                  for _ in range(depth)]).to(dev)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, device=dev, generator=gen)
                    / width ** 0.5)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0),
        named_parameters=model.named_parameters())
    torn = 0
    for it in range(4):
        g = torch.Generator(device=dev).manual_seed(100 * it + rank)
        x = torch.randn(rows, width, device=dev, generator=g)
        ps = list(model.parameters())
        local = torch.autograd.grad(model(x).square().mean(), ps)
        opt.zero_grad()
        model(x).square().mean().backward()  # the hooks fire here
        opt.synchronize()
        for i, (p, gl) in enumerate(zip(ps, local)):
            both = hvd.allgather(gl.unsqueeze(0), name=f"cr.{it}.{i}")
            want = ((both[0] + both[1]) / 2).cpu()
            if not torch.equal(p.grad.cpu().view(torch.int32),
                               want.view(torch.int32)):
                torn += 1
        with opt.skip_synchronize():
            opt.step()
    rec(out, "torn", torn)


def case_card_compile(out):
    """The compiled gradient reduction on cuda:0 (the default backend) is
    the eager grouped allreduce's bits, on the card."""
    from torch._dynamo.utils import counters

    from horovod_tpu_torch.ops import bridge

    rank, dev = hvd.rank(), torch.device("cuda", 0)
    grads = [tensor(("cc", rank, i), s).to(dev) for i, s in
             enumerate([(256, 64), (4097,), (3, 5, 7)])]
    fn = torch.compile(lambda gs: bridge.grouped_allreduce(
        gs, name="cc.grouped"), fullgraph=True)
    got = fn(grads)
    want = hvd.grouped_allreduce(grads, name="cc.grouped")
    rec(out, "on_card", all(t.device == dev for t in got))
    rec(out, "bits", all(torch.equal(a.cpu().view(torch.int32),
                                     b.cpu().view(torch.int32))
                         for a, b in zip(got, want)))
    rec(out, "graph_breaks", sum(counters["graph_break"].values()))


CASES = {k[len("case_"):]: v for k, v in list(globals().items())
         if k.startswith("case_")}


def main():
    _bind(sys.argv[1])
    torch.set_num_threads(1)
    cases, out_dir = sys.argv[2].split(","), sys.argv[3]
    if PKG == "jax":
        hvd.init()
    else:
        hvd.init(device=os.environ.get("FRONTEND_DEVICE", "cpu"),
                 backend="none")
    results, ok = {}, True
    try:
        for case in cases:
            try:
                out = {}
                CASES[case](out)
                results[case] = out
                print(f"SCENARIO_OK {case}", flush=True)
            except BaseException:
                traceback.print_exc()
                print(f"SCENARIO_FAIL {case}", flush=True)
                ok = False
                break
        with open(os.path.join(out_dir, f"rank{hvd.rank()}.pkl"),
                  "wb") as f:
            pickle.dump(results, f)
    finally:
        hvd.shutdown()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
