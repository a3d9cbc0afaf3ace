"""ResNet v1.5 family: the port of ``horovod_tpu/models/resnet.py``.

The benchmark-parity model (``bench.py`` times ResNet-50 first).  fp32
parameters and batch-norm statistics, compute in ``cfg.compute_dtype``
(bf16 by default), fp32 logits.  Parameters and statistics carry the JAX
tree's names (``stem_conv``, ``stage{s}_block{b}.conv1``, ``...bn1.scale``,
``...bn1.mean``); the statistics are buffers.  Conv weights are OIHW (the
JAX package's are HWIO; ``models/convert.py`` maps them), the head is
``[cin, num_classes]`` as in the JAX tree.

Images arrive ``[N, H, W, 3]`` as in the JAX API and are read as an NCHW
view with ``channels_last`` strides (no copy); on the card the conv weights
are ``channels_last`` too, so cuDNN runs its NHWC kernels.

Batch norm keeps the JAX package's semantics rather than ``nn.BatchNorm2d``'s:
the batch variance is the biased one (ddof 0) for normalization and for the
running update (momentum 0.9 on the old value); ``inv = rsqrt(var + eps) *
scale`` and ``shift = bias - mean * inv`` are folded in fp32 and cast once,
and ``x * inv + shift`` runs in the activation dtype.  A training forward
*returns* the new statistics and leaves the buffers as they were: the caller
writes them once (:func:`write_stats`), so a remat block run again in the
backward pass does not update them twice.

The JAX package's space-to-depth stem (``stem_s2d``) is a TPU layout trick
that computes the 7x7 stride-2 conv; the port runs that conv directly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.basics import resolve_device

_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5

Stats = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ResNetConfig:
    """Stage layout per the classic v1 family.  ``basic=True`` selects the
    two-conv basic block (ResNet-18/34); False the 1-3-1 bottleneck.
    ``remat`` recomputes each residual block in the backward pass."""

    blocks: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    basic: bool = False
    compute_dtype: Any = torch.bfloat16
    remat: bool = False


def resnet50_config(num_classes: int = 1000, **kw) -> ResNetConfig:
    return ResNetConfig(blocks=(3, 4, 6, 3), num_classes=num_classes, **kw)


def resnet101_config(num_classes: int = 1000, **kw) -> ResNetConfig:
    return ResNetConfig(blocks=(3, 4, 23, 3), num_classes=num_classes, **kw)


def resnet152_config(num_classes: int = 1000, **kw) -> ResNetConfig:
    return ResNetConfig(blocks=(3, 8, 36, 3), num_classes=num_classes, **kw)


def resnet18_config(num_classes: int = 1000, **kw) -> ResNetConfig:
    return ResNetConfig(blocks=(2, 2, 2, 2), num_classes=num_classes,
                        basic=True, **kw)


class BatchNorm(nn.Module):
    """One batch norm's parameters (``scale``, ``bias``) and running
    statistics (``mean``, ``var`` buffers), all fp32."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


def _conv_weight(cin: int, cout: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k))


class Block(nn.Module):
    """One residual block: ``conv1``/``bn1``, ``conv2``/``bn2`` (and
    ``conv3``/``bn3`` in a bottleneck), and ``proj_conv``/``proj_bn`` where
    the shortcut needs a projection."""

    def __init__(self, cin: int, cmid: int, cout: int, stride: int,
                 basic: bool):
        super().__init__()
        self.stride = stride
        self.basic = basic
        if basic:
            self.conv1 = _conv_weight(cin, cmid, 3)
            self.bn1 = BatchNorm(cmid)
            self.conv2 = _conv_weight(cmid, cout, 3)
            self.bn2 = BatchNorm(cout)
        else:
            self.conv1 = _conv_weight(cin, cmid, 1)
            self.bn1 = BatchNorm(cmid)
            self.conv2 = _conv_weight(cmid, cmid, 3)
            self.bn2 = BatchNorm(cmid)
            self.conv3 = _conv_weight(cmid, cout, 1)
            self.bn3 = BatchNorm(cout)
        self.has_proj = cin != cout or stride != 1
        if self.has_proj:
            self.proj_conv = _conv_weight(cin, cout, 1)
            self.proj_bn = BatchNorm(cout)


class ResNet(nn.Module):
    """The model: ``stem_conv``/``stem_bn``, ``stage{s}_block{b}`` and the
    fp32 head ``head_w``/``head_b``.  ``forward(images, train)`` returns
    ``(logits_fp32, new_stats)``."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = _conv_weight(3, cfg.width, 7)
        self.stem_bn = BatchNorm(cfg.width)
        self.block_names = []
        cin = cfg.width
        expansion = 1 if cfg.basic else 4
        for si, nblocks in enumerate(cfg.blocks):
            cmid = cfg.width * (2 ** si)
            cout = cmid * expansion
            for bi in range(nblocks):
                name = f"stage{si}_block{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                self.add_module(name, Block(cin, cmid, cout, stride,
                                            cfg.basic))
                self.block_names.append(name)
                cin = cout
        self.head_w = nn.Parameter(torch.empty(cin, cfg.num_classes))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def blocks(self):
        return [getattr(self, n) for n in self.block_names]

    def forward(self, images, train: bool = False):
        return apply(self, images, train)


def init(seed: int, cfg: ResNetConfig, *, device=None) -> ResNet:
    """A model with random weights from ``seed``, the JAX package's recipe
    (its random numbers differ): He-normal fan-out convs, batch norms at
    scale 1 and bias 0 with running mean 0 and variance 1, the head uniform
    in ±1/sqrt(cin) with zero bias.  Drawn on the CPU in the JAX package's
    order, so every device and rank gets the same weights."""
    dev = resolve_device(device, "resnet.init()")
    model = ResNet(cfg)
    gen = torch.Generator().manual_seed(int(seed))

    def he(w):
        cout, _, kh, kw = w.shape
        w.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)), generator=gen)

    with torch.no_grad():
        he(model.stem_conv)
        for blk in model.blocks():
            for name in ("conv1", "conv2", "conv3", "proj_conv"):
                if hasattr(blk, name):
                    he(getattr(blk, name))
        bound = 1.0 / math.sqrt(model.head_w.shape[0])
        model.head_w.uniform_(-bound, bound, generator=gen)
    return to_device(model, dev)


def to_device(model: nn.Module, dev: torch.device) -> nn.Module:
    """``model`` on ``dev``; on the card its conv weights take
    ``channels_last`` strides, the layout of cuDNN's NHWC kernels."""
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _conv(x, w, stride, dtype):
    """Symmetric pad ``(k - 1) // 2`` as the JAX package's ``_conv``."""
    return F.conv2d(x, w.to(dtype), stride=stride,
                    padding=w.shape[-1] // 2)


def _wide(x):
    """``x`` in fp32, or as it is where it is wider (an fp64 model)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bn(x, bn: BatchNorm, train: bool, reduce: Optional[Callable]):
    """Functional batch norm over an NCHW activation; returns ``(y,
    new_stats)`` with ``new_stats`` None in inference.

    Training statistics are fp32 over N, H and W; ``reduce``, where given,
    maps this rank's per-channel mean to the global one (synchronized batch
    norm): the mean is reduced first, then the mean squared deviation from
    it.  Gradients flow through the mean and the variance."""
    new = None
    if train:
        xf = _wide(x)
        if reduce is None:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        else:
            mean = reduce(xf.mean(dim=(0, 2, 3)))
            var = reduce((xf - mean[:, None, None]).square()
                         .mean(dim=(0, 2, 3)))
        m, v = mean.detach(), var.detach()
        new = (_BN_MOMENTUM * bn.mean + (1 - _BN_MOMENTUM) * m,
               _BN_MOMENTUM * bn.var + (1 - _BN_MOMENTUM) * v)
    else:
        mean, var = bn.mean, bn.var
    inv = torch.rsqrt(var + _BN_EPS) * bn.scale
    shift = bn.bias - mean * inv
    y = x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    return y, new


def _block(x, blk: Block, train: bool, dtype, reduce):
    """One residual block; returns ``(y, [(bn name, new_stats), ...])``."""
    stats = []

    def bn(y, name):
        y, new = _bn(y, getattr(blk, name), train, reduce)
        stats.append((name, new))
        return y

    shortcut = x
    if blk.has_proj:
        shortcut = bn(_conv(x, blk.proj_conv, blk.stride, dtype), "proj_bn")
    if blk.basic:
        y = F.relu(bn(_conv(x, blk.conv1, blk.stride, dtype), "bn1"))
        y = bn(_conv(y, blk.conv2, 1, dtype), "bn2")
    else:
        y = F.relu(bn(_conv(x, blk.conv1, 1, dtype), "bn1"))
        # v1.5: the stride sits on the 3x3, not the 1x1.
        y = F.relu(bn(_conv(y, blk.conv2, blk.stride, dtype), "bn2"))
        y = bn(_conv(y, blk.conv3, 1, dtype), "bn3")
    return F.relu(y + shortcut), stats


def apply(model: ResNet, images: torch.Tensor, train: bool = False, *,
          reduce: Optional[Callable] = None) -> Tuple[torch.Tensor, Stats]:
    """Forward pass.  ``images``: ``[N, H, W, 3]`` float.  Returns
    ``(logits_fp32 [N, num_classes], new_stats)``: in training, the new
    running ``mean``/``var`` of every batch norm keyed by buffer name (the
    buffers themselves are not touched), else ``{}``.  ``reduce`` makes
    the batch statistics global (see :func:`_bn`)."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    new_stats: Stats = {}

    def record(prefix, stats):
        for name, new in stats:
            if new is not None:
                new_stats[f"{prefix}{name}.mean"] = new[0]
                new_stats[f"{prefix}{name}.var"] = new[1]

    x = images.to(dtype).permute(0, 3, 1, 2)
    x, new = _bn(_conv(x, model.stem_conv, 2, dtype), model.stem_bn, train,
                 reduce)
    record("", [("stem_bn", new)])
    x = F.max_pool2d(F.relu(x), 3, 2, padding=1)
    for name, blk in zip(model.block_names, model.blocks()):
        if cfg.remat:
            x, stats = checkpoint(_block, x, blk, train, dtype, reduce,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, stats = _block(x, blk, train, dtype, reduce)
        record(f"{name}.", stats)
    x = _wide(x).mean(dim=(2, 3))
    return x @ model.head_w + model.head_b, new_stats


def softmax_xent(logits, labels):
    """Mean softmax cross-entropy of fp32 logits against integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


def loss_fn(model: ResNet, images, labels, *,
            reduce: Optional[Callable] = None) -> Tuple[torch.Tensor, Stats]:
    """Softmax cross-entropy of a training forward; returns ``(loss,
    new_stats)``."""
    logits, new_stats = apply(model, images, train=True, reduce=reduce)
    return softmax_xent(logits, labels), new_stats


@torch.no_grad()
def write_stats(model: nn.Module, new_stats: Stats) -> None:
    """Copy ``new_stats`` (as returned by :func:`apply`) into the model's
    buffers."""
    for name, value in new_stats.items():
        model.get_buffer(name).copy_(value)
