"""Continuous-batching LM serving on the gang, on the port: the twin of
``examples/serve_lm.py`` (``horovod_tpu_torch.serving.ServingLoop``).

Every rank runs this same script: rank 0 opens the HTTP front door and
drives admissions; all ranks step the same greedy decode in lockstep off
the broadcast batch deltas.  The model is a small decoder with random
weights from a seed, so every rank holds the same ones without a
broadcast.  ``--tp N`` serves it tensor-parallel over a mesh of the
ranks (``ServingLoop(mesh={"tp": N})``: NCCL with one rank per card,
gloo where ranks share one).  Serve on a gang of two and query it::

    hvdrun-torch -np 2 --serve-port 8100 -- \\
        python examples/torch_port/serve_lm.py
    curl -s localhost:8100/generate \\
        -d '{"prompt": [3, 14, 15], "max_new_tokens": 24}'
    curl -s localhost:8100/stats

Or with a built-in closed-loop client, which posts N prompts of seeded
random tokens, lengths and reply lengths, holds every reply to a
``DecodeEngine`` decoding the prompt alone (at tp 1) and requires the
replies to differ between requests, then exits::

    python examples/torch_port/serve_lm.py --selftest 8
    python examples/torch_port/serve_lm.py --selftest 8 --device cpu

Greedy decode is deterministic, so resubmitting a prompt returns the same
tokens, also after a gang re-form replays it (``attempts`` > 1).
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import json
import threading

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 (default fp32)")
    p.add_argument("--cache-len", type=int, default=128,
                   help="serving KV cache length (caps prompt+new)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width over the ranks")
    p.add_argument("--port", type=int, default=None,
                   help="front-door port (default HVD_SERVE_PORT, "
                        "0 = ephemeral)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="decode slots (default HVD_SERVE_MAX_BATCH)")
    p.add_argument("--selftest", type=int, default=0, metavar="N",
                   help="run N closed-loop requests from this process, "
                        "check and print them, and exit (instead of "
                        "serving forever)")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    args = p.parse_args()

    os.environ.setdefault("HVD_TPU_CORE", "py")  # serving requirement

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.basics import resolve_device
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serving import DecodeEngine, ServingLoop

    dev = resolve_device(args.device, "serve_lm.py")
    cfg = tfm.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.cache_len,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        attn_impl="flash", remat=False)
    model = tfm.init(0, cfg, device=dev)

    ready = threading.Event()
    port_box = {}

    def on_ready(port):
        port_box["port"] = port
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        print(f"serving on http://127.0.0.1:{port}/generate from {dev} "
              f"({name}), tp {args.tp}", flush=True)
        ready.set()

    # The loop initializes the runtime itself (with a process group for
    # the mesh); the launcher's HVD_RANK says which rank this is.
    loop = ServingLoop(model, cfg, device=dev, port=args.port,
                       max_batch=args.max_batch, cache_len=args.cache_len,
                       mesh={"tp": args.tp} if args.tp > 1 else None,
                       on_ready=on_ready)
    # Prompts and reply lengths from a seed, so that rows that mixed, a
    # wrong slot or a stale cache would change a reply.
    rs = np.random.RandomState(0)
    prompts, n_new = [], []
    for _ in range(args.selftest):
        n = int(rs.randint(3, max(4, args.cache_len // 4)))
        prompts.append([int(t) for t in rs.randint(0, cfg.vocab_size, n)])
        n_new.append(int(rs.randint(4, 17)))
    replies = {}

    if args.selftest and int(os.environ.get("HVD_RANK", "0")) == 0:
        def client():
            import http.client

            ready.wait()
            conns = []
            for i, prompt in enumerate(prompts):
                c = http.client.HTTPConnection("127.0.0.1",
                                               port_box["port"])
                c.request("POST", "/generate", json.dumps(
                    {"prompt": prompt, "max_new_tokens": n_new[i]}))
                conns.append((i, c))
            for i, c in conns:
                body = json.loads(c.getresponse().read())
                replies[i] = body["tokens"]
                print(f"request {i}: {body['tokens']}", flush=True)
                c.close()
            loop.stop()

        threading.Thread(target=client, daemon=True).start()

    loop.run()
    if replies and args.tp == 1:
        # Each reply against the prompt decoded alone in slot 0 of an
        # engine of the loop's shape: rows never mix, so bit for bit.
        engine = DecodeEngine(model, cfg, max_batch=loop.max_batch,
                              cache_len=args.cache_len, device=dev)
        bad = []
        for i, prompt in enumerate(prompts):
            toks = [engine.prefill(0, prompt)]
            for _ in range(n_new[i] - 1):
                toks.append(int(engine.step()[0]))
            engine.clear(0)
            if toks != replies.get(i):
                bad.append(i)
        if bad:
            raise SystemExit(f"selftest: replies {bad} differ from "
                             "DecodeEngine's alone")
        if len(prompts) > 1 and len({tuple(replies[i][:4])
                                     for i in replies}) < 2:
            raise SystemExit("selftest: every reply starts the same, so "
                             "the check cannot tell requests apart")
        print(f"selftest: {len(prompts)} replies equal to DecodeEngine's "
              f"alone, bit for bit", flush=True)
    elif args.selftest and int(os.environ.get("HVD_RANK", "0")) == 0:
        if len(replies) != len(prompts):
            raise SystemExit(f"selftest: {len(replies)} of {len(prompts)} "
                             "replies")
    hvd.shutdown()


if __name__ == "__main__":
    main()
