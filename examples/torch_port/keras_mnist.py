"""Distributed Keras MNIST in classic Horovod style, on the port.

The twin of ``examples/keras_mnist.py`` on ``horovod_tpu_torch.keras``
(the reference's ``keras_mnist.py`` and ``keras_mnist_advanced.py``):
``hvd.DistributedOptimizer`` around the user's optimizer, LR scaled by
``hvd.size()`` with warmup, ``BroadcastGlobalVariablesCallback``,
``MetricAverageCallback`` and rank-0-only checkpoints.  Run:

    hvdrun-torch -np 4 python examples/torch_port/keras_mnist.py \
        --device cpu

Keras runs on the host; ``--device`` is the device the port's runtime is
initialized on (default: the rank's card).  Synthetic MNIST-shaped data
keeps the example hermetic.
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import math

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    args = p.parse_args()

    os.environ.setdefault("KERAS_BACKEND", "tensorflow")
    import keras

    import horovod_tpu_torch.keras as hvd

    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()

    # Reference idiom: scale epochs down as workers scale up.
    epochs = int(math.ceil(args.epochs / size))

    # Synthetic MNIST shard per rank, labeled by a fixed linear teacher so
    # accuracy is meaningfully learnable.
    rs = np.random.RandomState(1234 + rank)
    x = rs.rand(args.samples, 28, 28, 1).astype("float32")
    teacher = np.random.RandomState(0).randn(784, 10)
    y = keras.utils.to_categorical(
        (x.reshape(-1, 784) @ teacher).argmax(-1), 10)

    model = keras.Sequential([
        keras.layers.Input((28, 28, 1)),
        keras.layers.Conv2D(16, 3, activation="relu"),
        keras.layers.MaxPooling2D(2),
        keras.layers.Flatten(),
        keras.layers.Dense(64, activation="relu"),
        keras.layers.Dense(10, activation="softmax"),
    ])

    # Reference idiom: scale LR by the number of workers, wrap with the
    # distributed optimizer, warm the scaled LR up over the first epochs.
    opt = keras.optimizers.SGD(learning_rate=0.01 * size, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt)

    model.compile(loss="categorical_crossentropy", optimizer=opt,
                  metrics=["accuracy"])

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=1,
            steps_per_epoch=math.ceil(args.samples / args.batch_size),
            verbose=rank == 0),
    ]
    # Reference idiom: only rank 0 writes checkpoints.
    if args.checkpoint_dir and rank == 0:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        callbacks.append(keras.callbacks.ModelCheckpoint(
            os.path.join(args.checkpoint_dir, "checkpoint-{epoch}.keras")))

    model.fit(x, y, batch_size=args.batch_size, epochs=epochs,
              callbacks=callbacks, verbose=2 if rank == 0 else 0)

    score = model.evaluate(x, y, verbose=0)
    avg_acc = hvd.allreduce(np.float32(score[1]), name="eval.acc")
    if rank == 0:
        print(f"accuracy (avg over {size} ranks): "
              f"{float(np.ravel(avg_acc)[0]):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
