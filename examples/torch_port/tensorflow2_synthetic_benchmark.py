"""Synthetic benchmark, TensorFlow 2 edition, on the port.

The twin of ``examples/tensorflow2_synthetic_benchmark.py`` on
``horovod_tpu_torch.tensorflow``: the reference's defaults (ResNet-50,
batch 32, 10 warmup batches, 10 iters of 10 batches), its
``--fp16-allreduce`` toggle and its "Img/sec per device" mean ± CI
output.  The gradient allreduce rides the port's eager engine through
``DistributedGradientTape``: the classic, host-side regime (TensorFlow
runs on the host; the card's regime is ``synthetic_benchmark.py``).

    hvdrun-torch -np 2 python \
        examples/torch_port/tensorflow2_synthetic_benchmark.py \
        --device cpu --model tiny
"""

from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: put the repo root on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse
import timeit

import numpy as np


def parse_args():
    p = argparse.ArgumentParser(
        description="TensorFlow2 synthetic benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "tiny"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--device", default=None,
                   help="the device this rank's runtime is initialized on "
                        "(default: its card; TensorFlow runs on the host)")
    return p.parse_args()


def main():
    args = parse_args()

    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init(device=args.device, backend="none")
    rank, size = hvd.rank(), hvd.size()

    if args.model == "tiny":
        image_size = 32
        model = tf.keras.Sequential([
            tf.keras.layers.Input((image_size, image_size, 3)),
            tf.keras.layers.Conv2D(8, 3, activation="relu"),
            tf.keras.layers.GlobalAveragePooling2D(),
            tf.keras.layers.Dense(100),
        ])
    else:
        image_size = 224
        model = tf.keras.applications.ResNet50(weights=None)

    opt = tf.keras.optimizers.SGD(0.01)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(
        from_logits=True)

    rs = np.random.RandomState(0)
    data = tf.constant(
        rs.rand(args.batch_size, image_size, image_size, 3)
        .astype(np.float32))
    target = tf.constant(rs.randint(0, 100, (args.batch_size,)))

    @tf.function
    def benchmark_step():
        with tf.GradientTape() as tape:
            probs = model(data, training=True)
            loss = loss_fn(target, probs)
        tape = hvd.DistributedGradientTape(tape, compression=compression)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))

    def log(s):
        if rank == 0:
            print(s)

    log(f"Model: {args.model}")
    log(f"Batch size: {args.batch_size}")
    log(f"Number of devices: {size}")

    # Warm up (and broadcast initial state after the first step, per the
    # reference's BroadcastGlobalVariablesCallback placement).
    benchmark_step()
    hvd.broadcast_variables(model.variables, root_rank=0)
    hvd.broadcast_variables(opt.variables, root_rank=0)
    for _ in range(args.num_warmup_batches - 1):
        benchmark_step()

    img_secs = []
    for x in range(args.num_iters):
        time = timeit.timeit(benchmark_step,
                             number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / time
        log(f"Iter #{x}: {img_sec:.1f} img/sec per device")
        img_secs.append(img_sec)

    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    log(f"Img/sec per device: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
    log(f"Total img/sec on {size} device(s): "
        f"{size * img_sec_mean:.1f} +-{size * img_sec_conf:.1f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
