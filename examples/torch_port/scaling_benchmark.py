"""Weak-scaling efficiency benchmark on the port: the twin of
``examples/scaling_benchmark.py``.

The reference's headline claim is scaling efficiency: throughput at N
devices over N times the throughput at one.  The JAX script widens a mesh
over one process's devices; the port's mesh spans ranks, so this one
launches a gang of N ranks for each count (through
``horovod_tpu_torch.runner.run.run``, the launcher's function mode), one
per card, each holding the per-device batch constant and running the
port's ``make_resnet_train_step_hvd`` over ``make_mesh({"dp": N})``:
gradients averaged over the ranks' process group (NCCL on cards).

    python examples/torch_port/scaling_benchmark.py --devices 1,2,4
    python examples/torch_port/scaling_benchmark.py --devices 1,2 \\
        --model tiny --device cpu

On the CPU the numbers reflect the host's cores, not a link.  The last
line is one JSON object with the efficiency per count.
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import json


def parse_args():
    p = argparse.ArgumentParser(
        description="Weak-scaling efficiency benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "resnet101", "tiny"])
    p.add_argument("--batch-per-device", type=int, default=32)
    p.add_argument("--devices", default="",
                   help="comma-separated rank counts (default: 1,2,4,... "
                        "up to every card)")
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: its card)")
    return p.parse_args()


def measure(opts):
    """One rank of a gang: the step's seconds per iteration."""
    import time

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import train as train_mod

    # The function mode starts the runtime with no process group; the
    # mesh's collectives need one.
    dev = hvd.device()
    hvd.shutdown()
    hvd.init_torch_distributed()
    hvd.init(device=dev)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    if opts["model"] == "tiny":
        cfg = resnet.ResNetConfig(blocks=(1, 1, 1, 1), width=8,
                                  num_classes=100,
                                  compute_dtype=torch.float32)
        size = 32
    else:
        cfg = {"resnet50": resnet.resnet50_config,
               "resnet101": resnet.resnet101_config}[opts["model"]]()
        size = 224
    mesh = mesh_mod.make_mesh({"dp": hvd.size()})
    step, init = train_mod.make_resnet_train_step_hvd(
        cfg, mesh=mesh, device=dev,
        compression=Compression.fp16 if opts["fp16"] else Compression.none)
    state = init(0)
    rs = np.random.RandomState(hvd.rank())
    b = opts["batch"]
    images = torch.from_numpy(
        rs.rand(b, size, size, 3).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rs.randint(0, cfg.num_classes, (b,))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(opts["warmup"]):
        state, loss = step(state, images, labels)
    sync()
    secs = []
    for _ in range(opts["iters"]):
        t0 = time.perf_counter()
        for _ in range(opts["per_iter"]):
            state, loss = step(state, images, labels)
        sync()
        secs.append(time.perf_counter() - t0)
    return {"secs": secs, "loss": float(loss), "device": str(dev),
            "name": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu"}


def main():
    args = parse_args()
    from horovod_tpu_torch.runner.run import run as hvd_run

    if args.devices:
        counts = [int(c) for c in args.devices.split(",")]
    else:
        import torch

        n_cards = torch.cuda.device_count()
        if not n_cards:
            raise SystemExit("no card: pass --devices and --device cpu")
        counts, c = [], 1
        while c <= n_cards:
            counts.append(c)
            c *= 2
    opts = {"model": args.model, "batch": args.batch_per_device,
            "warmup": args.num_warmup_batches,
            "per_iter": args.num_batches_per_iter,
            "iters": args.num_iters, "fp16": args.fp16_allreduce}
    results = {}
    for n in counts:
        per_rank = hvd_run(measure, (opts,), np=n, device=args.device)
        # The gang steps together: an iteration ends with its slowest rank.
        secs = [max(r["secs"][i] for r in per_rank)
                for i in range(args.num_iters)]
        rate = sum(n * args.batch_per_device * args.num_batches_per_iter / s
                   for s in secs) / len(secs)
        results[n] = rate
        r0 = per_rank[0]
        print(f"{n:4d} rank(s): {rate:10.1f} img/sec total, "
              f"{rate / n:10.1f} img/sec/device (loss {r0['loss']:.4f}; "
              f"{r0['device']}, {r0['name']})", flush=True)

    base = counts[0]
    table = {}
    for n in counts:
        eff = results[n] / (results[base] * n / base)
        table[n] = round(eff, 4)
        print(f"scaling efficiency {base}->{n}: {eff * 100:.1f}%")
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": table[counts[-1]],
        "unit": f"fraction_of_linear_{base}to{counts[-1]}",
        "per_count": table,
        "img_per_sec": {str(k): round(v, 1) for k, v in results.items()},
    }))


if __name__ == "__main__":
    main()
