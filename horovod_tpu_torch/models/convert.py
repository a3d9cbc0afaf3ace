"""Weight conversion between the JAX package's parameter trees and the
port's ``state_dict``.

Transformer: the JAX tree (``horovod_tpu.models.transformer.init``) stacks
every layer parameter along a leading ``[L, ...]`` axis; the port keeps one
module per layer.  The per-layer layouts are the same, so conversion is a
slice along that axis.  Given a mesh, both directions keep this rank's
shard, cut by ``transformer.param_specs`` (numpy or tensor slicing); with
``pipeline=True`` also the layers of its ``pp`` stage, renumbered from 0
(``pipeline.pipeline_param_specs``: the stacked axis over ``pp``).

ResNet and MNIST: the JAX trees nest by name (``params["stage0_block0"]
["bn1"]["scale"]``) and the port's keys join the same names with dots
(``stage0_block0.bn1.scale``); ResNet's batch statistics
(``batch_stats[...]["mean"]``) are the port's buffers of the same names.
Conv weights are HWIO in JAX and OIHW in the port; dense weights keep the
JAX layout ``[in, out]``.

Both sides hold numpy arrays (on the JAX side) and tensors (on the port's
side); no JAX import is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel.mesh import shard

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_in", "w_gate",
              "w_out")
# The Switch MoE FFN's layer parameters (``n_experts > 0``).
MOE_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "w_in",
                  "w_gate", "w_out")


def _specs(moe: bool):
    return tfm.param_specs(tfm.TransformerConfig(n_experts=int(moe)))


def _layer_keys(names) -> Tuple[str, ...]:
    keys = MOE_LAYER_KEYS if "router" in names else LAYER_KEYS
    extra = set(names) - set(keys)
    if extra:
        raise ValueError(f"unknown layer parameters {sorted(extra)}")
    return keys


def _stacked_specs(moe: bool, pipeline: bool):
    """Specs of the stacked tree: the layer axis over ``pp`` with
    ``pipeline``, whole without."""
    specs = _specs(moe)
    lead = "pp" if pipeline else None
    specs["layers"] = {k: (lead,) + v for k, v in specs["layers"].items()}
    return specs


def params_from_jax(tree: Dict[str, Any], mesh=None, *,
                    pipeline: bool = False) -> Dict[str, torch.Tensor]:
    """``{"embed", "layers": {k: [L, ...]}, "ln_f"}`` of numpy arrays →
    the port's ``state_dict`` (fp32 CPU tensors); with ``mesh`` (anything
    with ``shape`` and ``coords``), this rank's shard of it, and with
    ``pipeline`` its stage's layers."""
    layers = tree["layers"]
    keys = _layer_keys(layers)
    specs = _stacked_specs("router" in keys, pipeline)

    def t(a, spec):
        a = np.array(a, dtype=np.float32)
        if mesh is not None:
            a = shard(a, spec, mesh)
        return torch.from_numpy(np.ascontiguousarray(a))

    sd = {"embed": t(tree["embed"], specs["embed"]),
          "ln_f": t(tree["ln_f"], specs["ln_f"])}
    for k in keys:
        stacked = t(layers[k], specs["layers"][k])
        for i in range(stacked.shape[0]):
            sd[f"layers.{i}.{k}"] = stacked[i].clone()
    return dict(sorted(sd.items(), key=lambda kv: _order(kv[0], keys)))


def _order(key: str, keys) -> Tuple:
    """``state_dict`` order: embed, ln_f, the layers in turn."""
    if key.startswith("layers."):
        _, i, k = key.split(".")
        return (2, int(i), keys.index(k))
    return (0 if key == "embed" else 1, 0, 0)


def params_to_jax(state_dict: Dict[str, torch.Tensor], mesh=None, *,
                  pipeline: bool = False) -> Dict[str, Any]:
    """The port's ``state_dict`` (or a dict of gradients keyed the same
    way) → the JAX package's stacked tree of numpy arrays; with ``mesh``,
    this rank's shard of that tree (``state_dict`` whole), and with
    ``pipeline`` its stage's layers."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict
                       if k.startswith("layers."))
    keys = _layer_keys({k.split(".")[-1] for k in state_dict
                        if k.startswith("layers.")})
    specs = _stacked_specs("router" in keys, pipeline)

    def a(x, spec):
        x = x.detach().to("cpu", torch.float32).numpy()
        return x if mesh is None else shard(x, spec, mesh)

    layers = {k: a(torch.stack([state_dict[f"layers.{i}.{k}"]
                                for i in range(n_layers)]),
                   specs["layers"][k])
              for k in keys}
    return {"embed": a(state_dict["embed"], specs["embed"]), "layers": layers,
            "ln_f": a(state_dict["ln_f"], specs["ln_f"])}


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _nested_from_jax(*trees: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sd = {}
    for tree in trees:
        for key, a in _flatten(tree):
            a = np.array(a, dtype=np.float32)
            if a.ndim == 4:  # HWIO -> OIHW
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            sd[key] = torch.from_numpy(a)
    return sd


def _nested_to_jax(state_dict: Dict[str, torch.Tensor],
                   stat_names=()) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:  # OIHW -> HWIO
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        *path, leaf = key.split(".")
        node = stats if leaf in stat_names else params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return params, stats


def resnet_params_from_jax(params: Dict[str, Any],
                           batch_stats: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet ``(params, batch_stats)`` of numpy arrays
    → the port's ``state_dict`` (fp32 CPU tensors)."""
    return _nested_from_jax(params, batch_stats)


def resnet_params_to_jax(state_dict: Dict[str, torch.Tensor]
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ResNet ``state_dict`` (or a dict of gradients keyed the
    same way) → ``(params, batch_stats)`` trees of numpy arrays."""
    return _nested_to_jax(state_dict, stat_names=("mean", "var"))


def mnist_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's MNIST params of numpy arrays → the port's
    ``state_dict`` (fp32 CPU tensors)."""
    return _nested_from_jax(params)


def mnist_params_to_jax(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The port's MNIST ``state_dict`` (or its gradients) → the JAX
    package's params of numpy arrays."""
    return _nested_to_jax(state_dict)[0]
