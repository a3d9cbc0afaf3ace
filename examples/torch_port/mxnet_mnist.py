"""MNIST with MXNet/Gluon, classic Horovod recipe, on the port.

The twin of ``examples/mxnet_mnist.py`` on ``horovod_tpu_torch.mxnet``:
``hvd.DistributedTrainer`` around a plain SGD trainer, LR scaled by world
size, ``broadcast_parameters`` from rank 0, per-rank data shards, rank-0
evaluation.  MXNet is end-of-life upstream; where it is not installed
the script exits with a message saying so.

    hvdrun-torch -np 4 python examples/torch_port/mxnet_mnist.py
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    args = p.parse_args()

    try:
        import mxnet as mx
        from mxnet import autograd, gluon
    except ImportError:
        raise SystemExit(
            "mxnet is not installed (the project is EOL upstream). "
            "The horovod_tpu_torch.mxnet front-end logic is covered by "
            "tests/test_torch_mxnet.py under a stand-in module; use "
            "examples/torch_port/pytorch_mnist.py or keras_mnist.py "
            "for runnable training.")

    import horovod_tpu_torch.mxnet as hvd

    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(16, 3, activation="relu"),
            gluon.nn.MaxPool2D(2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(64, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize()

    params = net.collect_params()
    # Reference idioms: scale LR by workers, wrap the trainer, broadcast
    # the initial parameters from rank 0.
    trainer = hvd.DistributedTrainer(
        params, "sgd", {"learning_rate": args.lr * size, "momentum": 0.9})
    hvd.broadcast_parameters(params, root_rank=0)

    # Synthetic MNIST shard per rank (fixed linear teacher for labels).
    rs = np.random.RandomState(1234 + rank)
    x = rs.rand(args.samples, 1, 28, 28).astype("float32")
    teacher = np.random.RandomState(0).randn(784, 10)
    y = (x.reshape(-1, 784) @ teacher).argmax(-1)

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    steps = args.samples // args.batch_size
    for epoch in range(args.epochs):
        total, correct = 0.0, 0
        for step in range(steps):
            sl = slice(step * args.batch_size, (step + 1) * args.batch_size)
            data, label = mx.nd.array(x[sl]), mx.nd.array(y[sl])
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(args.batch_size)
            total += float(loss.mean().asscalar())
            correct += int((out.argmax(-1).asnumpy() == y[sl]).sum())
        acc = hvd.allreduce(
            np.float32(correct / (steps * args.batch_size)),
            name="train.acc")
        if rank == 0:
            print(f"epoch {epoch}: loss {total / steps:.4f} "
                  f"acc {float(np.ravel(acc)[0]):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
