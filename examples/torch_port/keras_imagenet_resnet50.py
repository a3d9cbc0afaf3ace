"""Distributed Keras ResNet-50 in classic Horovod style, on the port.

The twin of ``examples/keras_imagenet_resnet50.py`` on
``horovod_tpu_torch.keras``: ResNet-50, LR scaled by ``hvd.size()`` with
a warmup and stepwise-decay schedule, ``hvd.DistributedOptimizer``
(optionally fp16-compressed), broadcast from rank 0, metric averaging and
rank-0-only checkpoints.  Run:

    hvdrun-torch -np 4 python \
        examples/torch_port/keras_imagenet_resnet50.py --device cpu

Keras runs on the host; ``--device`` is the device the port's runtime is
initialized on (default: the rank's card).  The default image count is
small, so that a run finishes in minutes on a CPU; raise
``--samples``/``--image-size`` for a real one.
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
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--fp16-allreduce", action="store_true", default=False,
                   help="use fp16 compression during allreduce")
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    args = p.parse_args()

    os.environ.setdefault("KERAS_BACKEND", "tensorflow")
    import keras

    import horovod_tpu_torch.keras as hvd

    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()

    # Synthetic ImageNet-shaped shard per rank; brightness encodes the
    # class so the loss is meaningfully learnable in a smoke run.
    rs = np.random.RandomState(1234 + rank)
    labels = rs.randint(0, args.num_classes, (args.samples,))
    x = (rs.rand(args.samples, args.image_size, args.image_size, 3) * 0.2
         + labels[:, None, None, None] / args.num_classes).astype("float32")
    y = keras.utils.to_categorical(labels, args.num_classes)

    model = keras.applications.ResNet50(
        weights=None, input_shape=(args.image_size, args.image_size, 3),
        classes=args.num_classes)

    # Reference idioms: LR scaled by workers, warmup, stepwise decay
    # (keras_imagenet_resnet50.py:87-100), distributed optimizer.
    base_lr = 0.0125
    opt = keras.optimizers.SGD(learning_rate=base_lr * size, momentum=0.9)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    opt = hvd.DistributedOptimizer(opt, compression=compression)
    model.compile(loss="categorical_crossentropy", optimizer=opt,
                  metrics=["accuracy"])

    steps_per_epoch = math.ceil(args.samples / args.batch_size)
    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=1, steps_per_epoch=steps_per_epoch,
            verbose=rank == 0),
        hvd.callbacks.LearningRateScheduleCallback(
            start_epoch=1, multiplier=1.0),
    ]
    if args.checkpoint_dir and rank == 0:  # rank-0-only checkpointing
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        callbacks.append(keras.callbacks.ModelCheckpoint(
            os.path.join(args.checkpoint_dir,
                         "checkpoint-{epoch}.weights.h5"),
            save_weights_only=True))

    model.fit(x, y, batch_size=args.batch_size, epochs=args.epochs,
              callbacks=callbacks, verbose=2 if rank == 0 else 0)

    score = model.evaluate(x, y, verbose=0)
    if rank == 0:
        print(f"final loss {score[0]:.4f} acc {score[1]:.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
