"""Distributed MNIST, TensorFlow 2 edition, on the port.

The twin of ``examples/tensorflow2_mnist.py`` on
``horovod_tpu_torch.tensorflow``: the classic four-line workflow on a
``tf.GradientTape`` loop (init, shard the data by rank, wrap the tape in
``DistributedGradientTape``, broadcast variables after the first step),
the collectives on the port's eager engine.  The same seeds and data as
the original, so the two print the same losses.  Run:

    hvdrun-torch -np 4 python examples/torch_port/tensorflow2_mnist.py \
        --device cpu

TensorFlow runs on the host; ``--device`` is the device the port's
runtime is initialized on (default: the rank's card).  Synthetic
MNIST-shaped data keeps the example hermetic.
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


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    args = p.parse_args()

    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()

    # Synthetic MNIST: a fixed linear teacher makes the loss meaningfully
    # decreasable; each rank gets its own shard (seeded by rank).
    rs = np.random.RandomState(1234 + rank)
    images = rs.rand(4096, 28, 28, 1).astype(np.float32)
    teacher = np.random.RandomState(0).randn(28 * 28, 10)
    labels = (images.reshape(-1, 784) @ teacher).argmax(-1)

    model = tf.keras.Sequential([
        tf.keras.layers.Input((28, 28, 1)),
        tf.keras.layers.Conv2D(8, 3, activation="relu"),
        tf.keras.layers.GlobalAveragePooling2D(),
        tf.keras.layers.Dense(10),
    ])
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(
        from_logits=True)
    # Horovod idiom: scale LR by the number of workers.
    opt = tf.keras.optimizers.Adam(args.lr * size)

    @tf.function
    def train_step(x, y, first_batch):
        with tf.GradientTape() as tape:
            logits = model(x, training=True)
            loss = loss_fn(y, logits)
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    t0 = time.time()
    for step in range(args.steps):
        idx = rs.randint(0, len(images), args.batch_size)
        loss = train_step(tf.constant(images[idx]),
                          tf.constant(labels[idx]), step == 0)
        if step == 0:
            # Horovod idiom: broadcast initial state after the first
            # step, when every variable exists (BroadcastGlobalVariables).
            hvd.broadcast_variables(model.variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)
        if step % 50 == 0:
            avg = hvd.allreduce(loss, op=hvd.Average,
                                name=f"metric.loss.{step}")
            if rank == 0:
                print(f"step {step}: loss {float(avg):.4f}")
    if rank == 0:
        rate = args.steps * args.batch_size * size / (time.time() - t0)
        print(f"done: {rate:.0f} images/sec across {size} process(es)")
    hvd.shutdown()


if __name__ == "__main__":
    main()
