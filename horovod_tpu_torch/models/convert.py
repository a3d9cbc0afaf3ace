"""Weight conversion between the JAX package's transformer parameters and
the port's ``state_dict``.

The JAX tree (``horovod_tpu.models.transformer.init``) stacks every layer
parameter along a leading ``[L, ...]`` axis; the port keeps one module per
layer.  The per-layer layouts are the same, so conversion is a slice along
that axis.  Both sides hold numpy arrays (on the JAX side) and tensors (on
the port's side); no JAX import is needed.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_in", "w_gate",
              "w_out")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"embed", "layers": {k: [L, ...]}, "ln_f"}`` of numpy arrays →
    the port's ``state_dict`` (fp32 CPU tensors)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    layers = tree["layers"]
    extra = set(layers) - set(LAYER_KEYS)
    if extra:
        raise NotImplementedError(
            f"layer parameters {sorted(extra)} (MoE) are not ported yet")
    n_layers = np.shape(layers["wq"])[0]
    sd = {"embed": t(tree["embed"]), "ln_f": t(tree["ln_f"])}
    for i in range(n_layers):
        for k in LAYER_KEYS:
            sd[f"layers.{i}.{k}"] = t(np.asarray(layers[k])[i])
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` (or a dict of gradients keyed the same
    way) → the JAX package's stacked tree of numpy arrays."""
    def a(x):
        return x.detach().to("cpu", torch.float32).numpy()

    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict
                       if k.startswith("layers."))
    layers = {k: np.stack([a(state_dict[f"layers.{i}.{k}"])
                           for i in range(n_layers)])
              for k in LAYER_KEYS}
    return {"embed": a(state_dict["embed"]), "layers": layers,
            "ln_f": a(state_dict["ln_f"])}
