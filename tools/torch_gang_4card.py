#!/usr/bin/env python3
"""The port's multi-rank training paths on four NVIDIA cards of one host,
over NCCL, each held against its one-process twin.

    python3 tools/torch_gang_4card.py          # four cards, one rank each
    python3 tools/torch_gang_4card.py --cpu    # rehearsal: four gloo ranks,
                                               # a small model, no card
    python3 tools/torch_gang_4card.py --zero1-seeds 8,21,22
                                               # ZeRO-1 on more batches

One process per card (``hvd.init`` over ``tcp://127.0.0.1:<free port>``).
On the flagship of ``chip_smoke.py`` (vocab 32768, d_model 1024, 8 layers,
16 heads, d_ff 4096, seq 1024, global batch 8, bf16, flash, remat, weights
from seed 0):

1. the pipeline over ``{"pp": 4}`` with four microbatches
   (``make_pipeline_train_step(cfg, mesh=...)``): three steps on the batches
   of ``chip_smoke.py``'s pipelined phase, whose losses must be those of the
   loopback (``n_stages=4``, every stage on the rank's own card, the same
   weights and batches) within LOSS_TOL at step 0 and STEP_LOSS_TOL after;
   each rank's flash launches a step (its stage's two layers, four
   microbatches: 16 forward with the recompute, 8 dQ, 8 dK/dV); then five
   timed steps of each, the gang's and the loopback's medians printed side
   by side (the loopback runs the four stages one after the other on one
   card, the gang runs them on four);
2. the pipeline over ``{"dp": 2, "pp": 2}`` (two microbatches of four
   rows, each dp rank running two rows of each): three steps against the
   loopback of two stages on the same batches, at the same tolerances, and
   each rank's flash launches a step (four layers, two microbatches: 16,
   8, 8), so the cells run the kernels where dp > 1;
3. ZeRO-1 over ``{"dp": 4}`` (two rows a rank): two steps against
   ``zero1=False``.  Held: the losses within ZERO_RTOL; each parameter's
   averaged step-0 gradient (ZeRO-1's gathered from the ranks' pieces)
   within ZERO_GRAD_TOL; the parameters after step 1 within
   ZERO_STEP1_TOL and after step 2 within ZERO_STEP2_TOL, as
   ``|a - b| / |b|``; each rank's AdamW moments a quarter of the model.
   Printed: the parameter with the largest gap after each step, its
   elements that moved apart most, and the step-1 gradients' gap.  The
   batches are ``chip_smoke.py``'s from seed 8, and from each seed of
   ``--zero1-seeds`` where it is given;
4. Adasum over ``{"dp": 4}``: each rank's step-0 flagship gradient (fp32,
   its own seed's batch) through ``allreduce(op=Adasum)``, whose rounds are
   ``ppermute`` exchanges between the cards, against ``adasum_loopback`` on
   the four gradients gathered to every rank (within ADASUM_GAP) and, on
   rank 0, against the float64 oracle (within ``chip_smoke.ADASUM_TOL``);
5. the MoE flagship (8 experts, capacity 1.25) over ``{"ep": 2, "tp":
   2}``, and the flagship with ring attention over ``{"dp": 2, "sp": 2}``:
   three steps each against the one-process step on the same global
   batches, whose losses must agree within LOSS_TOL at step 0 and
   STEP_LOSS_TOL after.

The configuration, the batches (``chip_smoke._token_batches``: the input
pipeline) and the tolerances the two scripts share come from
``chip_smoke.py``.  Rank 0 prints the results and, last, ``{"ok": true, ...}``.  Exits
non-zero on a failed check, and where torch finds fewer than four cards
(without ``--cpu``).
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

RANKS = smoke.PP_STAGES
# ZeRO-1 against the replicated step, as |a - b| / |b| by parameter.  The
# gradient's mean is taken by a reduce-scatter instead of an allreduce
# (fp32 sums in another order), and AdamW's update is elementwise.
# ZERO_RTOL: the losses, as the JAX package's own ZeRO-1 test holds its
# two steps.  ZERO_GRAD_TOL: the step-0 mean gradients, which differ in
# their last bits (an H100 gang read 5.1e-8; PERF.md).  ZERO_STEP1_TOL: the
# parameters after step 1, read 5.6e-9: AdamW's first update is
# g / (|g| + eps), which last-bit changes of g move only where |g| is near
# eps (146 of 168 M elements moved, by an ulp or two).  A wrong update of
# one rank's piece moves a quarter of a parameter by up to the learning
# rate, a gap of 5e-4 or more (norm scales, near 1) and far more
# elsewhere.  ZERO_STEP2_TOL: the parameters after step 2, a backstop
# behind the step-1 check: the bf16 residual stream can round step 1's
# last-bit differences another way, and another batch read 1.146e-3.
ZERO_RTOL = 1e-5
ZERO_GRAD_TOL = 1e-6
ZERO_STEP1_TOL = 1e-6
ZERO_STEP2_TOL = 1e-2
# Adasum over the cards against the loopback of the same four vectors: the
# same arithmetic on the same values, up to the order of the fp32 sums of
# the dot products (a reduction over one row of [1, N] or of [4, N]).
ADASUM_GAP = 1e-6


def _cfg(tfm, cpu):
    """``chip_smoke.py``'s flagship; for the rehearsal, its narrow copy."""
    import dataclasses

    cfg = smoke._flagship_cfg(tfm)
    if cpu:
        cfg = dataclasses.replace(cfg, vocab_size=256, d_model=64,
                                  n_heads=4, d_ff=128, max_seq_len=32)
    return cfg


def _batches(cfg, n, dev, seed=7):
    """``chip_smoke.py``'s batches (``n`` of 8 rows, through the input
    pipeline) at ``cfg``'s sequence length and vocabulary."""
    return smoke._token_batches(dev, n, S=cfg.max_seq_len,
                                vocab=cfg.vocab_size, seed=seed)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _steps(step_fn, state, batches, torch, dev):
    losses, times = [], []
    for tokens, targets in batches:
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, targets)
        losses.append(float(loss))
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return state, losses, times


def run_pipeline(hvd, torch, cfg, dev, say, bad, axes, timed):
    """The pipelined step over ``axes`` against the loopback of as many
    stages on the same global batches: losses, and each rank's flash
    launches.  With ``timed``, five more steps of each: their medians."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import pipeline as pl
    from horovod_tpu_torch.parallel.mesh import make_mesh

    P = axes["pp"]
    tag = " x ".join(f"{k} {v}" for k, v in axes.items())
    data = _batches(cfg, 5, dev)
    mesh = make_mesh(axes)
    dp, i = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)

    def local(batches):  # this rank's P('dp', None) slice of each batch
        b = batches[0][0].shape[0] // dp
        return [(t[i * b:(i + 1) * b], y[i * b:(i + 1) * b])
                for t, y in batches]

    gang_step, gang_init = pl.make_pipeline_train_step(
        cfg, mesh=mesh, n_microbatches=P)
    loop_step, loop_init = pl.make_pipeline_train_step(
        cfg, n_stages=P, n_microbatches=P)
    # The loopback's optimizer reduces over every rank, which all hold the
    # same model and batch: the mean is each rank's own gradient.
    loop, loop_losses, _ = _steps(loop_step, loop_init(0), data[:3], torch,
                                  dev)
    fa.reset_launch_counts()
    gang, losses, _ = _steps(gang_step, gang_init(0), local(data[:3]), torch,
                             dev)
    counts = dict(fa.launches)
    diffs = [abs(a - b) for a, b in zip(losses, loop_losses)]
    say(f"pp ({tag}): gang losses {losses}; loopback of {P} stages "
        f"{loop_losses}; |gang - loopback| {[f'{d:.3e}' for d in diffs]} "
        f"(tol {smoke.LOSS_TOL} at step 0, {smoke.STEP_LOSS_TOL} after)")
    per = (cfg.n_layers // P) * P  # a rank's layers times the microbatches
    want = {"fwd": 2 * per * 3, "dq": per * 3, "dkv": per * 3, "split": 0}
    say(f"pp ({tag}): rank 0's flash launches over 3 steps {counts} (want "
        f"{want} on a card, on every rank)")
    if diffs[0] > smoke.LOSS_TOL or max(diffs[1:]) > smoke.STEP_LOSS_TOL \
            or not all(math.isfinite(x) for x in losses):
        bad.append(f"the pipelined gang over {tag} disagrees with the "
                   "loopback")
    if dev.type == "cuda" and counts != want:
        bad.append(f"pipeline over {tag}: launches {counts} != {want}")
    if not timed:
        return None
    _, _, gang_ms = _steps(gang_step, gang, local([data[4]]) * 5, torch, dev)
    _, _, loop_ms = _steps(loop_step, loop, [data[4]] * 5, torch, dev)
    say(f"pp ({tag}): step ms, gang {gang_ms}, loopback {loop_ms}; medians "
        f"{statistics.median(gang_ms):.2f} against "
        f"{statistics.median(loop_ms):.2f}")
    return statistics.median(gang_ms), statistics.median(loop_ms)


def _mean_grads(state, dp, C):
    """Each parameter's averaged gradient as the step left it: ZeRO-1's
    gathered over ``dp`` from the ranks' pieces, the others' whole."""
    opt, out = state.optimizer, {}
    pieces = getattr(opt, "pieces", {})
    for n, p in state.model.named_parameters():
        if n in pieces:
            d = opt.dims[n]
            out[n] = C.allgather(pieces[n].grad.movedim(d, 0).contiguous(),
                                 axis=dp).movedim(0, d)
        else:
            out[n] = p.grad.detach().clone()
    return out


def _gaps(got, want):
    """``{name: |got - want| / |want|}`` over two ``{name: tensor}``."""
    return {n: float((got[n] - w).norm() / w.norm().clamp_min(1e-30))
            for n, w in want.items()}


def _worst(gaps):
    n = max(gaps, key=gaps.get)
    return f"{n} {gaps[n]:.3e}"


def _apart(torch, name, got, want, grads, k=3):
    """The ``k`` elements of parameter ``name`` that moved apart most, with
    the replicated step's mean gradient there at steps 0 and 1."""
    d = (got[name] - want[name]).abs()
    top = torch.topk(d.reshape(-1), k).indices
    rows = []
    for j in top.tolist():
        at = tuple(int(x) for x in torch.unravel_index(
            torch.tensor(j), d.shape))
        rows.append(f"{name}{list(at)}: |delta| {float(d[at]):.3e}, value "
                    f"{float(want[name][at]):.4e}, mean grad step 0 "
                    f"{float(grads[0][name][at]):.3e}, step 1 "
                    f"{float(grads[1][name][at]):.3e}")
    n_apart = sum(int((got[n] != want[n]).sum()) for n in want)
    n_all = sum(w.numel() for w in want.values())
    return rows, n_apart, n_all


def run_zero1(hvd, torch, cfg, dev, say, bad, seed=8):
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": RANKS})
    dp, i = mesh.axis("dp"), mesh.coords["dp"]
    rows = [(t[2 * i:2 * i + 2], y[2 * i:2 * i + 2])
            for t, y in _batches(cfg, 2, dev, seed=seed)]
    out = {}
    for zero1 in (True, False):
        step_fn, init_fn = hvd.make_transformer_train_step(cfg, mesh=mesh,
                                                           zero1=zero1)
        state, losses, params, grads = init_fn(0), [], [], []
        for tokens, targets in rows:
            state, loss = step_fn(state, tokens, targets)
            losses.append(float(loss))
            params.append({n: p.detach().clone()
                           for n, p in state.model.named_parameters()})
            grads.append(_mean_grads(state, dp, C))
        share = sum(st["exp_avg"].numel() for st in
                    state.optimizer.inner.state.values()) / sum(
            p.numel() for p in state.model.parameters())
        out[zero1] = (losses, params, grads, share)
        del state
    (zl, zp, zg, zshare), (rl, rp, rg, rshare) = out[True], out[False]
    g0, g1 = _gaps(zg[0], rg[0]), _gaps(zg[1], rg[1])
    p1, p2 = _gaps(zp[0], rp[0]), _gaps(zp[1], rp[1])
    say(f"zero1: batches of seed {seed}")
    say(f"zero1: losses {zl} against zero1=False {rl}; moments a rank "
        f"{zshare:.4f} of the model (replicated: {rshare:.4f})")
    say(f"zero1: largest |zero1 - replicated| / |replicated| by parameter: "
        f"step-0 mean gradient {_worst(g0)} (tol {ZERO_GRAD_TOL}); "
        f"parameters after step 1 {_worst(p1)} (tol {ZERO_STEP1_TOL}); "
        f"step-1 mean gradient {_worst(g1)} (not held); parameters after "
        f"step 2 {_worst(p2)} (tol {ZERO_STEP2_TOL})")
    for step, gaps, params in ((1, p1, zp[0]), (2, p2, zp[1])):
        lines, n_apart, n_all = _apart(torch, max(gaps, key=gaps.get),
                                       params, rp[step - 1], rg)
        say(f"zero1: after step {step}, {n_apart} of {n_all} elements "
            f"differ; the largest: " + "; ".join(lines))
    if any(abs(a - b) > ZERO_RTOL * abs(b) for a, b in zip(zl, rl)):
        bad.append("ZeRO-1 losses disagree with the replicated step")
    for what, gaps, tol in (("step-0 mean gradients", g0, ZERO_GRAD_TOL),
                            ("parameters after step 1", p1, ZERO_STEP1_TOL),
                            ("parameters after step 2", p2, ZERO_STEP2_TOL)):
        if not max(gaps.values()) <= tol:
            bad.append(f"ZeRO-1 {what} disagree with the replicated step")
    if abs(zshare - 1.0 / RANKS) > 1e-9:
        bad.append(f"ZeRO-1 moments hold {zshare} of the model")


def run_adasum(hvd, torch, cfg, dev, say, bad):
    import numpy as np

    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel.mesh import make_mesh

    axis = make_mesh({"dp": RANKS}).axis("dp")
    model = tfm.init(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(100 + hvd.rank())
    tokens = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len),
                           device=dev, generator=gen)
    tfm.loss_fn(model, tokens, torch.roll(tokens, -1, dims=1)).backward()
    x = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    del model
    ms = []
    for _ in range(2):  # the first call also sets up NCCL's connections
        _sync(torch, dev)
        t0 = time.perf_counter()
        got = C.allreduce(x, op=hvd.Adasum, axis=axis)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    xs = C.allgather(x[None], axis=axis)
    want = adasum.adasum_loopback(xs)[0]
    gap = float((got - want).norm() / want.norm())
    say(f"adasum: {RANKS} ranks x {x.numel()} fp32 elements over "
        f"{axis.size} cards: first call {ms[0]:.1f} ms, second "
        f"{ms[1]:.1f} ms; |gang - loopback| / |loopback| {gap:.3e} (tol "
        f"{ADASUM_GAP})")
    if gap > ADASUM_GAP:
        bad.append("Adasum over the ranks disagrees with the loopback")
    if hvd.rank() == 0:
        oracle = adasum.adasum_reduce_numpy(list(xs.cpu().numpy()))
        g = got.cpu().numpy().astype(np.float64)
        rel = float(np.linalg.norm(g - oracle) / np.linalg.norm(oracle))
        say(f"adasum: |gang - float64 oracle| / |oracle| {rel:.3e} (tol "
            f"{smoke.ADASUM_TOL})")
        if rel > smoke.ADASUM_TOL:
            bad.append("Adasum over the ranks disagrees with the oracle")


def run_mesh(hvd, torch, cfg, dev, say, bad, axes):
    """``make_transformer_train_step`` over ``axes`` against the
    one-process step (no mesh) on the same global batches: three steps'
    losses.  ``{"ep": 2, "tp": 2}`` runs the MoE flagship (8 experts,
    capacity 1.25: four experts a rank, heads and d_ff split in two), every
    rank on the whole batch; ``{"dp": 2, "sp": 2}`` runs ring attention,
    each rank on its ``P('dp', 'sp')`` slice (four rows, half the
    sequence)."""
    import dataclasses

    from horovod_tpu_torch.parallel.mesh import make_mesh

    tag = " x ".join(f"{k} {v}" for k, v in axes.items())
    if "ep" in axes:
        cfg = dataclasses.replace(cfg, n_experts=8, capacity_factor=1.25)
    else:
        cfg = dataclasses.replace(cfg, attn_impl="ring")
    data = _batches(cfg, 3, dev)
    mesh = make_mesh(axes)
    dp, i = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    sp, j = mesh.shape.get("sp", 1), mesh.coords.get("sp", 0)

    def local(batches):  # this rank's P('dp', 'sp') slice of each batch
        b = batches[0][0].shape[0] // dp
        s = batches[0][0].shape[1] // sp
        return [(t[i * b:(i + 1) * b, j * s:(j + 1) * s],
                 y[i * b:(i + 1) * b, j * s:(j + 1) * s])
                for t, y in batches]

    gang_step, gang_init = hvd.make_transformer_train_step(cfg, mesh=mesh)
    one_step, one_init = hvd.make_transformer_train_step(
        dataclasses.replace(cfg, attn_impl="flash"))
    # The one-process step's optimizer reduces over every rank, which all
    # hold the same model and batch: the mean is each rank's own gradient.
    _, one_losses, _ = _steps(one_step, one_init(0), data, torch, dev)
    _, losses, _ = _steps(gang_step, gang_init(0), local(data), torch, dev)
    diffs = [abs(a - b) for a, b in zip(losses, one_losses)]
    say(f"mesh ({tag}): gang losses {losses}; one process {one_losses}; "
        f"|gang - one process| {[f'{d:.3e}' for d in diffs]} (tol "
        f"{smoke.LOSS_TOL} at step 0, {smoke.STEP_LOSS_TOL} after)")
    if diffs[0] > smoke.LOSS_TOL or max(diffs[1:]) > smoke.STEP_LOSS_TOL \
            or not all(math.isfinite(x) for x in losses):
        bad.append(f"the step over {tag} disagrees with one process")


def _worker(rank, port, cpu, out_path, zero1_seeds):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm

    if cpu:
        torch.set_num_threads(1)
    hvd.init(rank=rank, size=RANKS, local_rank=rank,
             device="cpu" if cpu else None,
             init_method=f"tcp://127.0.0.1:{port}")
    lines, bad = [], []
    if rank:  # rank 0 speaks for the gang (say, and the batches' line)
        sys.stdout = open(os.devnull, "w")

    def say(msg):
        if rank == 0:
            print(msg, flush=True)
            lines.append(msg)

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = hvd.device()
        cfg = _cfg(tfm, cpu)
        if not cpu:
            card = torch.cuda.get_device_name(dev)
            say(f"cards: {torch.cuda.device_count()} x {card}")
        gang_ms, loop_ms = run_pipeline(hvd, torch, cfg, dev, say, bad,
                                        {"pp": RANKS}, timed=True)
        run_pipeline(hvd, torch, cfg, dev, say, bad, {"dp": 2, "pp": 2},
                     timed=False)
        for seed in zero1_seeds:
            run_zero1(hvd, torch, cfg, dev, say, bad, seed)
        run_adasum(hvd, torch, cfg, dev, say, bad)
        run_mesh(hvd, torch, cfg, dev, say, bad, {"ep": 2, "tp": 2})
        run_mesh(hvd, torch, cfg, dev, say, bad, {"dp": 2, "sp": 2})
        # Every rank's failures reach rank 0.
        from horovod_tpu_torch.ops import collective as C

        n_bad = C.allreduce(torch.tensor([float(len(bad))], device=dev),
                            op=hvd.Sum)
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump({"failures": bad, "ranks_failing": float(n_bad[0]),
                           "pp_gang_ms": gang_ms, "pp_loopback_ms": loop_ms},
                          fh)
    finally:
        hvd.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    import tempfile

    import torch
    import torch.multiprocessing as mp

    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--zero1-seeds", default="8",
                    help="comma-separated seeds of ZeRO-1's batches")
    args = ap.parse_args()
    cpu = args.cpu
    seeds = [int(s) for s in args.zero1_seeds.split(",")]
    if not cpu and torch.cuda.device_count() < RANKS:
        print(f"torch finds {torch.cuda.device_count()} CUDA devices; this "
              f"needs {RANKS}", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "result.json")
        mp.start_processes(_worker, args=(_free_port(), cpu, out_path,
                                          seeds),
                           nprocs=RANKS, start_method="spawn", join=True)
        with open(out_path) as fh:
            result = json.load(fh)
    if result["failures"] or result["ranks_failing"]:
        print(f"FAILED: {result}", file=sys.stderr)
        return 1
    if not cpu:
        print(_card_line())
    print(json.dumps({"ok": True, "pp_gang_ms": result["pp_gang_ms"],
                      "pp_loopback_ms": result["pp_loopback_ms"]}))
    return 0


def _card_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
