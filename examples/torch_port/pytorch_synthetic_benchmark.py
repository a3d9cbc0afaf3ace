"""ResNet-50 synthetic benchmark, PyTorch edition, on the port.

The twin of ``examples/pytorch_synthetic_benchmark.py``: the reference's
defaults (ResNet-50, batch 32, 10 warmup batches, 10 iters of 10 batches),
its ``--fp16-allreduce`` toggle and its img/sec ± CI output, with the
port's ResNet-50 (``horovod_tpu_torch.models.resnet``, bf16 compute) and
the classic ``horovod_tpu_torch.torch`` ``DistributedOptimizer``.  Run:

    hvdrun-torch -np 4 python examples/torch_port/pytorch_synthetic_benchmark.py
    python examples/torch_port/pytorch_synthetic_benchmark.py \\
        --device cpu --model tiny

Each rank runs on its card, ``cuda:<local_rank>``, unless ``--device``
names another; the times end in a synchronize of that device.
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import math
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd_core
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import resnet


def parse_args():
    p = argparse.ArgumentParser(
        description="PyTorch synthetic benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "tiny"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    return p.parse_args()


def main():
    args = parse_args()
    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd_core.device()
    if dev.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // size))

    if args.model == "tiny":
        cfg = resnet.ResNetConfig(blocks=(1, 1, 1, 1), width=8,
                                  num_classes=100,
                                  compute_dtype=torch.float32)
        img_size = 32
    else:
        cfg = resnet.resnet50_config()
        img_size = 224
    model = resnet.init(0, cfg, device=dev)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01)
    compression = hvd.Compression.fp16 if args.fp16_allreduce \
        else hvd.Compression.none
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    gen = torch.Generator().manual_seed(rank)
    data = torch.randn(args.batch_size, img_size, img_size, 3,
                       generator=gen).to(dev)
    target = torch.randint(0, cfg.num_classes, (args.batch_size,),
                           generator=gen).to(dev)

    def benchmark_step():
        optimizer.zero_grad()
        loss, new_stats = resnet.loss_fn(model, data, target)
        loss.backward()
        optimizer.step()
        resnet.write_stats(model, new_stats)
        return loss

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if rank == 0:
        print(f"Model: {args.model}")
        print(f"Batch size: {args.batch_size}")
        print(f"Number of processes: {size}")
        print(f"Device: {dev}"
              + (f" ({torch.cuda.get_device_name(dev)})"
                 if dev.type == "cuda" else ""))
        print("Running warmup...", flush=True)
    for _ in range(args.num_warmup_batches):
        loss = benchmark_step()
    sync()

    if rank == 0:
        print("Running benchmark...", flush=True)
    img_secs = []
    for x in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = benchmark_step()
        sync()
        dt = time.perf_counter() - t0
        img_sec = args.batch_size * args.num_batches_per_iter / dt
        if rank == 0:
            print(f"Iter #{x}: {img_sec:.1f} img/sec per device",
                  flush=True)
        img_secs.append(img_sec)

    # Output format parity: the reference's results block.
    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    last = float(hvd.allreduce(loss.detach(), op=hvd.Average,
                               name="metric.loss"))
    if rank == 0:
        print(f"Img/sec per device: {img_sec_mean:.1f} "
              f"+-{img_sec_conf:.1f}")
        print(f"Total img/sec on {size} device(s): "
              f"{size * img_sec_mean:.1f} +-{size * img_sec_conf:.1f}")
        print(f"last loss {last:.4f}", flush=True)
    hvd.shutdown()
    if not math.isfinite(last):
        raise SystemExit(f"non-finite loss {last}")


if __name__ == "__main__":
    main()
