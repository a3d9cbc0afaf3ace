"""ImageNet-style ResNet-50 training with PyTorch, classic Horovod recipe,
on the port.

The twin of ``examples/pytorch_imagenet_resnet50.py`` on
``horovod_tpu_torch.torch`` and the port's ResNet-50
(``horovod_tpu_torch.models.resnet``): LR scaled by world size with
gradual warmup, gradient allreduce with optional fp16 compression and
gradient accumulation (``backward_passes_per_step``), broadcast of
parameters and optimizer state from rank 0, metric averaging across
ranks, and rank-0-only checkpoints with resume.  Run:

    hvdrun-torch -np 8 python examples/torch_port/pytorch_imagenet_resnet50.py

Synthetic ImageNet-shaped data keeps the example hermetic; use
``--image-size 32 --width 8 --device cpu`` for a quick run without a card.
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd_core
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import resnet


def parse_args():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--base-lr", type=float, default=0.0125,
                   help="per-worker LR (scaled by world size)")
    p.add_argument("--warmup-epochs", type=float, default=1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--batches-per-allreduce", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--width", type=int, default=64,
                   help="stem width (64 = real ResNet-50)")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--fp32", action="store_true",
                   help="compute in fp32 (default bf16)")
    p.add_argument("--checkpoint-format", default="",
                   help="e.g. ckpt/checkpoint-{epoch}.pt")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    return p.parse_args()


def main():
    args = parse_args()
    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd_core.device()

    cfg = resnet.resnet50_config(
        num_classes=args.num_classes, width=args.width,
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16)
    model = resnet.init(42, cfg, device=dev)
    # The reference recipe: each step consumes batch_size *
    # batches_per_allreduce samples (one backward of batch_size each,
    # one allreduce at the end), so LR scales by the total batch
    # parallelism size * batches_per_allreduce.
    n_acc = args.batches_per_allreduce
    allreduce_batch = args.batch_size * n_acc
    lr_scaler = size * n_acc
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=args.base_lr * lr_scaler,
                                momentum=args.momentum,
                                weight_decay=args.wd)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=n_acc)

    # Resume: rank 0 restores, then broadcast puts everyone in agreement.
    start_epoch = 0
    if args.checkpoint_format and rank == 0:
        for e in range(args.epochs, 0, -1):
            path = args.checkpoint_format.format(epoch=e - 1)
            if os.path.exists(path):
                ck = torch.load(path, map_location=dev, weights_only=True)
                model.load_state_dict(ck["model"])
                optimizer.load_state_dict(ck["optimizer"])
                start_epoch = e
                print(f"resumed from epoch {e}", flush=True)
                break
    start_epoch = int(hvd.broadcast(
        torch.tensor([start_epoch]), root_rank=0, name="resume.epoch")[0])
    # Horovod recipe step 2: one initial state everywhere.
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    rs = np.random.RandomState(1234 + rank)  # per-rank data shard
    steps_total = args.steps_per_epoch

    def adjust_lr(epoch, step):
        # Gradual warmup (the "facebook 1-hour" schedule) then 30/60/80
        # decay, exactly the reference example's recipe.
        ep = epoch + step / steps_total
        if ep < args.warmup_epochs:
            mult = (ep * (size - 1) / args.warmup_epochs + 1) / size
        else:
            mult = 10 ** -sum(ep >= e for e in (30, 60, 80))
        for group in optimizer.param_groups:
            group["lr"] = args.base_lr * lr_scaler * mult

    for epoch in range(start_epoch, args.epochs):
        epoch_loss = 0.0
        for step in range(steps_total):
            adjust_lr(epoch, step)
            data = torch.from_numpy(rs.rand(
                allreduce_batch, args.image_size, args.image_size,
                3).astype(np.float32)).to(dev)
            target = torch.from_numpy(rs.randint(
                0, args.num_classes, (allreduce_batch,))).to(dev)
            optimizer.zero_grad()
            # One backward per batch_size sub-batch; each sub-loss is
            # divided by the accumulation count so the accumulated
            # gradient is the mean over the whole allreduce batch (the
            # reference recipe's loss.div_).
            step_loss = 0.0
            for i in range(0, allreduce_batch, args.batch_size):
                loss, new_stats = resnet.loss_fn(
                    model, data[i:i + args.batch_size],
                    target[i:i + args.batch_size])
                step_loss += float(loss.detach())
                (loss / n_acc).backward()
                resnet.write_stats(model, new_stats)
            epoch_loss += step_loss / n_acc
            optimizer.step()
        # Horovod recipe step 3: average metrics across ranks.
        avg = hvd.allreduce(torch.tensor([epoch_loss / steps_total]),
                            op=hvd.Average, name=f"metric.{epoch}")
        if rank == 0:
            print(f"epoch {epoch}: loss {float(avg[0]):.4f} on {dev}",
                  flush=True)
            # Recipe step 4: rank-0-only checkpoint.
            if args.checkpoint_format:
                path = args.checkpoint_format.format(epoch=epoch)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                torch.save({"model": model.state_dict(),
                            "optimizer": optimizer.state_dict(),
                            "epoch": epoch}, path)
    hvd.shutdown()


if __name__ == "__main__":
    main()
