"""Distributed MNIST with PyTorch, classic Horovod workflow, on the port.

The twin of ``examples/pytorch_mnist.py`` (and of ``examples/jax_mnist.py``'s
four-line workflow) on ``horovod_tpu_torch.torch``: scale the learning
rate by world size, wrap the optimizer in the hook-driven
``DistributedOptimizer``, broadcast parameters and optimizer state from
rank 0, average the epoch's loss across ranks.  The same seeds and data as
the original, so on the CPU the two print the same losses.  Run:

    hvdrun-torch -np 4 python examples/torch_port/pytorch_mnist.py
    python examples/torch_port/pytorch_mnist.py --device cpu

(``hvdrun-torch`` is ``python -m horovod_tpu_torch.runner.run``.)  Each
rank trains on its card, ``cuda:<local_rank>``, unless ``--device`` names
another.  Synthetic MNIST-shaped data keeps the example hermetic.
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
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd_core
import horovod_tpu_torch.torch as hvd


class Net(nn.Module):
    # Same topology as the reference example's model.
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.reshape(-1, 320)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: its card)")
    args = p.parse_args()

    # The classic front-end runs on the eager engine: no process group.
    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd_core.device()
    torch.manual_seed(42 + rank)

    rs = np.random.RandomState(1234 + rank)
    images = rs.rand(4096, 1, 28, 28).astype(np.float32)
    teacher = np.random.RandomState(0).randn(28 * 28, 10)
    labels = (images.reshape(-1, 784) @ teacher).argmax(-1)

    # Initialized on the CPU, as the original, then moved.
    model = Net().to(dev)
    # Horovod idiom: scale the learning rate by the number of workers.
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr * size,
                                momentum=0.5)
    compression = hvd.Compression.fp16 if args.fp16_allreduce \
        else hvd.Compression.none
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    for epoch in range(args.epochs):
        model.train()
        for step in range(args.steps_per_epoch):
            idx = rs.randint(0, len(images), args.batch_size)
            x = torch.from_numpy(images[idx]).to(dev)
            y = torch.from_numpy(labels[idx]).to(dev)
            optimizer.zero_grad()
            loss = F.nll_loss(model(x), y)
            loss.backward()
            optimizer.step()
        # Metric averaging across workers, like the reference's
        # metric_average helper.
        avg = hvd.allreduce(loss.detach(), op=hvd.Average,
                            name="metric.loss")
        if rank == 0:
            print(f"epoch {epoch}: loss {float(avg):.4f} on {dev}",
                  flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
