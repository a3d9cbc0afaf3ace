"""ResNet-50 synthetic benchmark on the port: the twin of
``examples/jax_synthetic_benchmark.py``.

The reference's defaults (ResNet-50, batch 32, 10 warmup batches, 10
iters of 10 batches), its ``--fp16-allreduce`` toggle and its img/sec ± CI
output.  Two modes:

* default (one process): the compiled regime, the port's
  ``parallel.train.make_resnet_train_step_hvd`` (the JAX package's
  ``shard_map`` step) on this process's card, with a process group of one;
* under ``hvdrun-torch -np N`` (``HVD_SIZE`` > 1): the classic regime,
  one process per card, the gradients allreduced through the eager
  engine (all submitted, then synchronized, so that the engine fuses
  them).

    python examples/torch_port/synthetic_benchmark.py
    hvdrun-torch -np 4 python examples/torch_port/synthetic_benchmark.py
    python examples/torch_port/synthetic_benchmark.py --device cpu \\
        --model tiny

The JAX script's ``--bridge`` mode (the whole step jitted, the reduction
through the host-callback bridge) has no twin here: the port's bridge is
``horovod_tpu_torch.ops.bridge`` under ``torch.compile``.
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


def parse_args():
    p = argparse.ArgumentParser(
        description="PyTorch port synthetic benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "resnet101", "resnet152",
                            "resnet18", "tiny"])
    p.add_argument("--batch-size", type=int, default=32,
                   help="input batch size per device")
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="compress gradient allreduce to 16 bit")
    p.add_argument("--image-size", type=int, default=0,
                   help="override input resolution (0 = 224, or 32 for "
                        "--model tiny)")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    return p.parse_args()


def build_model(args):
    from horovod_tpu_torch.models import resnet

    if args.model == "tiny":
        cfg = resnet.ResNetConfig(blocks=(1, 1, 1, 1), width=8,
                                  num_classes=100,
                                  compute_dtype=torch.float32)
        size = args.image_size or 32
    else:
        cfg = {"resnet50": resnet.resnet50_config,
               "resnet101": resnet.resnet101_config,
               "resnet152": resnet.resnet152_config,
               "resnet18": resnet.resnet18_config}[args.model]()
        size = args.image_size or 224
    return cfg, size


def log(rank, msg):
    if rank == 0:
        print(msg, flush=True)


def timed_loop(args, dev, one_batch, rate_scale, rank):
    """Warm up, then time ``num_iters`` iterations; returns the per-device
    rates and the last loss."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(args.num_warmup_batches):
        loss = one_batch()
    sync()
    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = one_batch()
        sync()
        dt = time.perf_counter() - t0
        rate = args.batch_size * args.num_batches_per_iter / dt
        log(rank, f"Iter #{i}: {rate * rate_scale:.1f} img/sec total")
        img_secs.append(rate)
    return img_secs, loss


def run_compiled(args):
    """One process on its card: the compiled regime's step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import train as train_mod

    hvd.init(device=args.device)
    dev = hvd.device()
    cfg, size = build_model(args)
    if args.fp16_allreduce:
        log(0, "--fp16-allreduce: one process has no gradient allreduce "
               "to compress")
    step, init = train_mod.make_resnet_train_step_hvd(cfg, device=dev)
    box = {"state": init(0)}
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(args.batch_size, size, size, 3,
                        generator=gen).to(dev)
    labels = torch.randint(0, cfg.num_classes, (args.batch_size,),
                           generator=gen).to(dev)

    def one_batch():
        box["state"], loss = step(box["state"], images, labels)
        return loss

    log(0, f"Model: {args.model}  Batch size: {args.batch_size} "
           f"x 1 device(s), compiled mode on {device_name(dev)}")
    img_secs, loss = timed_loop(args, dev, one_batch, 1, 0)
    report(img_secs, 1, 0, float(loss))
    hvd.shutdown()


def run_classic(args):
    """N processes under hvdrun-torch, the engine's allreduce."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    hvd.init(device=args.device, backend="none")
    rank, nproc = hvd.rank(), hvd.size()
    dev = hvd.device()
    cfg, size = build_model(args)
    model = resnet.init(0, cfg, device=dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    gen = torch.Generator().manual_seed(rank)
    images = torch.rand(args.batch_size, size, size, 3,
                        generator=gen).to(dev)
    labels = torch.randint(0, cfg.num_classes, (args.batch_size,),
                           generator=gen).to(dev)
    compression = hvd.Compression.fp16 if args.fp16_allreduce \
        else hvd.Compression.none

    def one_batch():
        loss, new_stats = resnet.loss_fn(model, images, labels)
        grads = torch.autograd.grad(loss, params)
        handles = [hvd.allreduce_async(g, op=hvd.Average, name=f"grad.{i}",
                                       compression=compression)
                   for i, g in enumerate(grads)]
        with torch.no_grad():
            for p, h in zip(params, handles):
                p.sub_(0.01 * torch.as_tensor(hvd.synchronize(h),
                                              device=dev))
        resnet.write_stats(model, new_stats)
        return loss

    log(rank, f"Model: {args.model}  Batch size: {args.batch_size} "
              f"x {nproc} process(es), classic mode on "
              f"{device_name(dev)}")
    img_secs, loss = timed_loop(args, dev, one_batch, nproc, rank)
    last = float(hvd.allreduce(loss.detach(), op=hvd.Average,
                               name="metric.loss"))
    report(img_secs, nproc, rank, last)
    hvd.shutdown()


def device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else str(dev)


def report(img_secs, n_devices, rank, loss):
    # Output format parity: tensorflow2_synthetic_benchmark.py:119-130.
    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    if rank == 0:
        print(f"Img/sec per device: {img_sec_mean:.1f} "
              f"+-{img_sec_conf:.1f}")
        print(f"Total img/sec on {n_devices} device(s): "
              f"{n_devices * img_sec_mean:.1f} "
              f"+-{n_devices * img_sec_conf:.1f}")
        print(f"last loss {loss:.4f}", flush=True)
    if not math.isfinite(loss):
        raise SystemExit(f"non-finite loss {loss}")


def main():
    args = parse_args()
    if int(os.environ.get("HVD_SIZE", "1")) > 1:
        run_classic(args)
    else:
        run_compiled(args)


if __name__ == "__main__":
    main()
