"""Decoder-LM pretraining on a mesh of ranks: the twin of
``examples/jax_transformer_lm.py`` on the port.

The flagship's workflow through ``parallel.train.make_transformer_train_step``:
one training step whose parallelism comes from a named mesh of ranks
(``parallel.mesh.make_mesh``), one rank per card:

    dp  data parallel (gradients averaged over dp)
    tp  Megatron tensor parallel (QKV/FFN column-, projections row-sharded)
    sp  sequence parallel (ring attention when sp > 1)

with causal flash attention (the port's Hopper kernels) where neither tp
nor sp shards the heads or the sequence, and per-rank checkpoints with
resume (``utils.checkpoint.resume_or_init``), so that a preempted run, or
one relaunched by ``hvdrun-torch --max-restarts``, continues where it
left off.  Run on four cards, or four CPU processes:

    hvdrun-torch -np 4 python examples/torch_port/transformer_lm.py \\
        --tp 2 --sp 2
    hvdrun-torch -np 2 python examples/torch_port/transformer_lm.py \\
        --tp 2 --device cpu --fp32

``--dp`` defaults to the ranks the other axes leave.  The global batch is
laid out ``P('dp', 'sp')``: each rank takes its dp rows and sp block.
Uses a synthetic Zipf corpus (no download).
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import math
import statistics
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dp", type=int, default=-1,
                   help="-1: the ranks the other axes leave")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=256)
    p.add_argument("--vocab-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch (sharded over dp)")
    p.add_argument("--seq-len", type=int, default=64,
                   help="sequence length (sharded over sp)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--attn", default=None,
                   choices=["flash", "dense", "ring", "ulysses"],
                   help="attention (default: flash, ring where sp > 1)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--fp32", action="store_true",
                   help="compute in fp32 (default bf16)")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer state over dp (ZeRO-1)")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    args = p.parse_args()

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import train as train_mod
    from horovod_tpu_torch.utils import checkpoint as ckpt

    # The mesh's collectives run over a process group: publish its store
    # through the launcher's rendezvous, then form it (NCCL on the card).
    hvd.init_torch_distributed()
    hvd.init(device=args.device)
    dev = hvd.device()
    mesh = mesh_mod.make_mesh({"dp": args.dp, "tp": args.tp,
                               "sp": args.sp})
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if args.batch_size % dp:
        raise SystemExit("--batch-size must divide over dp")
    if args.seq_len % sp:
        raise SystemExit("--seq-len must divide over --sp")
    attn = args.attn or ("ring" if sp > 1 else "flash")
    cfg = tfm.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len,
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
        attn_impl=attn)

    step, init = train_mod.make_transformer_train_step(
        cfg, mesh=mesh, zero1=args.zero1, device=dev)
    state = init(0)
    # Every rank reads and writes its own shard file (tp, ZeRO-1).  A
    # fresh optimizer holds no moments yet, so the checkpoint is read as
    # it was written (no template) and loaded into the state.
    ckpt_path = (os.path.join(args.checkpoint_dir, "state")
                 if args.checkpoint_dir else None)
    if ckpt_path:
        tree = ckpt.resume_or_init(ckpt_path, lambda: None, mesh=mesh)
        if tree is not None:
            state = train_mod.load_state_tree(state, tree)
    start_step = state.step
    rank0 = hvd.rank() == 0
    if start_step and rank0:
        print(f"resumed from step {start_step}", flush=True)

    # Synthetic Zipf token stream, as the JAX example's.
    rs = np.random.RandomState(0)
    zipf = 1.0 / np.arange(1, args.vocab_size + 1)
    corpus = rs.choice(args.vocab_size, 200_000, p=zipf / zipf.sum())
    b_lo = mesh.coords["dp"] * (args.batch_size // dp)
    s_lo = mesh.coords["sp"] * (args.seq_len // sp)
    rows = slice(b_lo, b_lo + args.batch_size // dp)
    cols = slice(s_lo, s_lo + args.seq_len // sp)

    def batch(i):
        idx = (np.arange(args.batch_size)[:, None] * 977 +
               np.arange(args.seq_len + 1)[None, :] + i * 31) % (
                   len(corpus) - 1)
        toks = torch.from_numpy(corpus[idx].astype(np.int64))
        return toks[rows, :-1][:, cols], toks[rows, 1:][:, cols]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if rank0:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        if attn == "flash" and mesh.shape["tp"] > 1:
            # The JAX package's dispatch: flash where nothing shards.
            attn = "dense (flash runs where tp is 1)"
        print(f"mesh {mesh.shape} on {hvd.size()} rank(s), attention "
              f"{attn}, {str(cfg.compute_dtype).split('.')[1]}, device "
              f"{dev} ({name})", flush=True)
    launches0 = dict(fa.launches)
    step_ms = []
    last_saved = start_step
    t0 = time.perf_counter()
    for i in range(start_step, args.steps):
        tokens, targets = batch(i)
        ts = time.perf_counter()
        state, loss = step(state, tokens.to(dev), targets.to(dev))
        loss = float(loss)  # ends the step on the host
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if not math.isfinite(loss):
            raise SystemExit(f"step {i + 1}: non-finite loss {loss}")
        if rank0 and ((i + 1) % 10 == 0 or i + 1 == args.steps
                      or i == start_step):
            print(f"step {i + 1}: loss {loss:.4f}", flush=True)
        if ckpt_path and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(ckpt_path, train_mod.state_tree(state), mesh=mesh)
            last_saved = i + 1
    sync()
    dt = time.perf_counter() - t0
    done = args.steps - start_step
    if done > 0 and rank0:
        toks = done * args.batch_size * args.seq_len
        print(f"done: mesh={mesh.shape} ({hvd.size()} ranks), "
              f"{toks / dt:.0f} tokens/sec, step median "
              f"{statistics.median(step_ms):.3f} ms over {done} steps "
              f"(the first included)", flush=True)
        used = {k: n - launches0[k] for k, n in fa.launches.items()}
        print(f"flash kernel launches: {used}", flush=True)
    if ckpt_path:
        if last_saved != args.steps:
            ckpt.save(ckpt_path, train_mod.state_tree(state), mesh=mesh)
        if rank0:
            print(f"checkpoint at step {state.step}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
