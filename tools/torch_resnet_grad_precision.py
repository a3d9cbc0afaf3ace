#!/usr/bin/env python3
"""How far a freshly initialized ResNet-50's step-0 gradients move with the
compute precision, on one NVIDIA card.

    python3 tools/torch_resnet_grad_precision.py

The model of ``chip_smoke.py``'s ResNet-50 phase (``resnet50_config()``,
weights from seed 0, batch 32 of 224x224 images from seed 2, TF32 off) is
run forward and backward once in bf16 (twice), fp32 (twice) and fp64, and
each parameter's gradient is compared with the fp64 one and with its own
repeat.  Prints, for each residual block (and the stem and head), the
largest |g - g_ref| / |g_ref| over its parameters and the smallest cosine
between the bf16 and fp64 gradients.  This is why ``chip_smoke.py`` holds
the bf16 gradients below the head to the fp32 twin only loosely.  Exits
non-zero where torch finds no CUDA device.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

PAIRS = (("bf16", "fp64"), ("fp32", "fp64"), ("bf16", "bf16 again"),
         ("fp32", "fp32 again"), ("bf16", "fp32"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from horovod_tpu_torch.models import resnet as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = rn.resnet50_config()
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand(32, 224, 224, 3, device=dev, generator=gen)
    labels = torch.randint(0, cfg.num_classes, (32,), device=dev,
                           generator=gen)

    def grads(dtype):
        model = rn.init(0, dataclasses.replace(cfg, compute_dtype=dtype),
                        device=dev)
        if dtype == torch.float64:
            model = model.double()
        loss, _ = rn.loss_fn(model, images.to(dtype), labels)
        loss.backward()
        return loss.item(), {n: p.grad.double()
                             for n, p in model.named_parameters()}

    runs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("bf16 again",
                                                   torch.bfloat16),
                        ("fp32", torch.float32), ("fp32 again",
                                                  torch.float32),
                        ("fp64", torch.float64)):
        t0 = time.perf_counter()
        runs[name] = grads(dtype)
        torch.cuda.synchronize()
        print(f"{name:10s} loss {runs[name][0]:.9f} "
              f"({time.perf_counter() - t0:.1f} s)")

    names = list(runs["fp64"][1])
    groups = list(dict.fromkeys(n.split(".")[0] for n in names))
    print("largest |g - g_ref| / |g_ref| over each group's parameters, for "
          "g vs g_ref: " + ", ".join(f"{a} vs {b}" for a, b in PAIRS)
          + "; then the smallest cos(bf16, fp64)")
    for g in groups:
        members = [n for n in names if n.split(".")[0] == g]
        gaps = [max(float((runs[a][1][n] - runs[b][1][n]).norm()
                          / runs[b][1][n].norm()) for n in members)
                for a, b in PAIRS]
        cos = min(float(torch.nn.functional.cosine_similarity(
            runs["bf16"][1][n].flatten(), runs["fp64"][1][n].flatten(),
            dim=0)) for n in members)
        print(f"  {g:14s} " + " ".join(f"{v:9.2e}" for v in gaps)
              + f"  {cos:6.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
