"""ImageNet ResNet-50 with MXNet/Gluon, classic Horovod recipe, on the
port.

The twin of ``examples/mxnet_imagenet_resnet50.py`` on
``horovod_tpu_torch.mxnet``: LR scaled by world size with warmup,
``DistributedTrainer`` (the gradient allreduce inside ``trainer.step``),
``broadcast_parameters`` from rank 0, rank-0 checkpoints.  MXNet is
end-of-life upstream; where it is not installed the script exits with a
message saying so.

    hvdrun-torch -np 8 python \
        examples/torch_port/mxnet_imagenet_resnet50.py
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse

import numpy as np


def parse_args():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=float, default=1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--save-frequency", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    return p.parse_args()


def main():
    args = parse_args()
    try:
        import mxnet as mx
        from mxnet import autograd, gluon
    except ImportError:
        raise SystemExit(
            "mxnet is not installed (the project is EOL upstream). "
            "The horovod_tpu_torch.mxnet front-end logic is covered by "
            "tests/test_torch_mxnet.py under a stand-in module; use "
            "examples/torch_port/pytorch_imagenet_resnet50.py or "
            "keras_imagenet_resnet50.py for runnable training.")

    import horovod_tpu_torch.mxnet as hvd

    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()

    net = gluon.model_zoo.vision.resnet50_v2(
        classes=1000, pretrained=False)
    net.initialize(mx.init.MSRAPrelu())
    net.hybridize()

    params = net.collect_params()
    trainer = hvd.DistributedTrainer(
        params, "sgd",
        {"learning_rate": args.base_lr * size,
         "momentum": args.momentum, "wd": args.wd})
    hvd.broadcast_parameters(params, root_rank=0)

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(1234 + rank)
    for epoch in range(args.epochs):
        total = 0.0
        for step in range(args.steps_per_epoch):
            # Gradual warmup, as in the torch twin.
            ep = epoch + step / args.steps_per_epoch
            if ep < args.warmup_epochs:
                mult = (ep * (size - 1) / args.warmup_epochs + 1) / size
            else:
                mult = 10 ** -sum(ep >= e for e in (30, 60, 80))
            trainer.set_learning_rate(args.base_lr * size * mult)

            data = mx.nd.array(rs.rand(
                args.batch_size, 3, args.image_size, args.image_size))
            label = mx.nd.array(rs.randint(0, 1000, (args.batch_size,)))
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(args.batch_size)
            total += float(loss.mean().asscalar())
        if rank == 0:
            print(f"epoch {epoch}: loss {total / args.steps_per_epoch:.4f}")
            if args.save_frequency and (epoch + 1) % args.save_frequency == 0:
                net.save_parameters(f"resnet50-{epoch}.params")
    hvd.shutdown()


if __name__ == "__main__":
    main()
