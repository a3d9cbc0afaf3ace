"""Distributed skip-gram word2vec with sparse embedding gradients, on the
port: the twin of ``examples/jax_word2vec.py``.

Skip-gram with an NCE loss whose embedding gradients are sparse (only the
rows the batch touched), combined across ranks through
``hvd.sparse_allreduce`` (an allgather of values and indices, never
densified: the reference's IndexedSlices path); the dense NCE-bias
gradient rides the ordinary allreduce, so both data planes appear in one
script.  Run:

    hvdrun-torch -np 4 python examples/torch_port/word2vec.py
    hvdrun-torch -np 2 python examples/torch_port/word2vec.py --device cpu

Uses a synthetic Zipf-distributed corpus (no download).
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd


def make_batches(rs, corpus, batch_size, window, n_neg, vocab):
    """Yield (centers, contexts, negatives) skip-gram batches forever."""
    n = len(corpus)
    while True:
        centers = rs.randint(window, n - window, batch_size)
        offs = rs.randint(1, window + 1, batch_size)
        signs = rs.choice([-1, 1], batch_size)
        contexts = corpus[centers + offs * signs]
        negatives = rs.randint(0, vocab, (batch_size, n_neg))
        yield corpus[centers], contexts, negatives


def nce_loss(emb_rows, w_rows, b_rows):
    """Noise-contrastive loss on gathered rows only.

    ``emb_rows``: [B, D] center embeddings; ``w_rows``: [B, 1+K, D] output
    vectors for the true context (slot 0) and K negatives; ``b_rows``:
    [B, 1+K] biases.  Gradients with respect to these gathered rows stay
    sparse in the vocabulary dimension."""
    logits = torch.einsum("bd,bkd->bk", emb_rows, w_rows) + b_rows
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1.0
    return F.binary_cross_entropy_with_logits(
        logits, labels, reduction="none").sum(1).mean()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--vocab-size", type=int, default=2000)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--num-neg", type=int, default=8)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--corpus-len", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    args = p.parse_args()

    # The eager engine carries every collective: no process group.
    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()

    # Synthetic corpus: Zipf-ish token stream with local correlation so
    # skip-gram has structure to learn; each rank reads its own shard.
    rs = np.random.RandomState(1234 + rank)
    zipf = 1.0 / np.arange(1, args.vocab_size + 1)
    corpus = rs.choice(args.vocab_size, args.corpus_len, p=zipf / zipf.sum())
    # Correlate neighbours: every odd position copies a near-by token id.
    corpus[1::2] = np.minimum(
        corpus[:-1:2] + rs.randint(0, 3, len(corpus[1::2])),
        args.vocab_size - 1)

    gen = torch.Generator().manual_seed(0)
    V, D = args.vocab_size, args.embedding_dim
    emb = (torch.rand(V, D, generator=gen) * 2 - 1).to(dev)
    nce_w = (torch.randn(V, D, generator=gen) / np.sqrt(D)).to(dev)
    nce_b = torch.zeros(V, device=dev)
    # Horovod idiom #1: identical initial state everywhere.
    emb, nce_w, nce_b = hvd.broadcast_parameters((emb, nce_w, nce_b),
                                                 root_rank=0)

    def apply_sparse(param, values, indices):
        param.index_add_(0, torch.as_tensor(indices, device=dev),
                         torch.as_tensor(values, device=dev),
                         alpha=-args.lr)

    batches = make_batches(rs, corpus, args.batch_size, args.window,
                           args.num_neg, V)
    t0 = time.time()
    for step in range(args.steps):
        centers, contexts, negatives = next(batches)
        cands = np.concatenate([contexts[:, None], negatives], axis=1)
        c_t = torch.from_numpy(centers).to(dev)
        k_t = torch.from_numpy(cands).to(dev)
        rows = [emb[c_t].requires_grad_(), nce_w[k_t].requires_grad_(),
                nce_b[k_t].requires_grad_()]
        loss = nce_loss(*rows)
        g_emb, g_w, g_b = torch.autograd.grad(loss, rows)

        # Horovod idiom #2, sparse flavour: combine only the touched rows.
        v, i = hvd.sparse_allreduce(g_emb, c_t, op=hvd.Average,
                                    name="grad.emb")
        apply_sparse(emb, v, i)
        flat = k_t.reshape(-1)
        v, i = hvd.sparse_allreduce(g_w.reshape(-1, D), flat,
                                    op=hvd.Average, name="grad.nce_w")
        apply_sparse(nce_w, v, i)
        # The bias gradient is tiny: send it dense through the normal path.
        dense_gb = torch.zeros(V, device=dev).index_add_(
            0, flat, g_b.reshape(-1))
        dense_gb = hvd.allreduce(dense_gb, op=hvd.Average, name="grad.nce_b")
        nce_b -= args.lr * torch.as_tensor(dense_gb, device=dev)

        if step % 100 == 0:
            avg = hvd.allreduce(loss.detach(), op=hvd.Average,
                                name="metric.loss")
            if rank == 0:
                print(f"step {step}: nce loss {float(avg):.4f}", flush=True)
    if rank == 0:
        rate = args.steps * args.batch_size * size / (time.time() - t0)
        print(f"done: {rate:.0f} words/sec across {size} process(es) on "
              f"{dev}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
