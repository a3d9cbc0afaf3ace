"""Small MNIST convnet: the port of ``horovod_tpu/models/mnist.py``.

Two 3x3 convs, each followed by ReLU and a 2x2 max-pool, then two dense
layers; fp32 parameters, compute in bf16 and fp32 logits.  Parameters carry
the JAX tree's names: ``conv1``/``b1``, ``conv2``/``b2`` (convs OIHW, the
JAX package's are HWIO), ``fc1``/``fb1`` and ``fc2``/``fb2`` (``[in,
out]`` as in JAX).  ``fc1`` reads the pooled activation flattened in
``H, W, C`` order, as the JAX package's NHWC reshape does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.models.resnet import softmax_xent, to_device


class MNIST(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Parameter(torch.empty(32, 1, 3, 3))
        self.b1 = nn.Parameter(torch.zeros(32))
        self.conv2 = nn.Parameter(torch.empty(64, 32, 3, 3))
        self.b2 = nn.Parameter(torch.zeros(64))
        self.fc1 = nn.Parameter(torch.empty(7 * 7 * 64, 128))
        self.fb1 = nn.Parameter(torch.zeros(128))
        self.fc2 = nn.Parameter(torch.empty(128, 10))
        self.fb2 = nn.Parameter(torch.zeros(10))

    def forward(self, images, dtype=torch.bfloat16):
        return apply(self, images, dtype)


def init(seed: int, *, device=None) -> MNIST:
    """A model with random weights from ``seed``, the JAX package's recipe
    (its random numbers differ): He-normal fan-out convs, He-normal fan-in
    dense layers, zero biases.  Drawn on the CPU."""
    dev = resolve_device(device, "mnist.init()")
    model = MNIST()
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for w in (model.conv1, model.conv2):
            cout, _, kh, kw = w.shape
            w.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)), generator=gen)
        for w in (model.fc1, model.fc2):
            w.normal_(0.0, math.sqrt(2.0 / w.shape[0]), generator=gen)
    return to_device(model, dev)


def apply(model: MNIST, images: torch.Tensor, dtype=torch.bfloat16):
    """``images``: ``[N, 28, 28, 1]`` float in [0, 1].  Returns fp32
    logits ``[N, 10]``."""
    x = images.to(dtype).permute(0, 3, 1, 2)

    def conv(x, w, b):
        y = F.conv2d(x, w.to(dtype), padding=1)
        return F.relu(y + b.to(dtype)[:, None, None])

    x = F.max_pool2d(conv(x, model.conv1, model.b1), 2, 2)
    x = F.max_pool2d(conv(x, model.conv2, model.b2), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ model.fc1.to(dtype) + model.fb1.to(dtype))
    return x.float() @ model.fc2 + model.fb2


def loss_fn(model: MNIST, images, labels) -> torch.Tensor:
    return softmax_xent(apply(model, images), labels)
