"""Weight bridge: a JAX package Flax param tree -> the port's modules.

The tree comes as nested dicts of numpy arrays (``jax.device_get`` of the
``params`` collection); this module imports no JAX. The port's modules
carry the flax names, so a torch parameter name maps to a flax path by
turning ModuleList indices ``layers.3`` into ``layers_3`` and the leaf
name by the module's type:

- ``Dense`` (nn.Dense and nn.DenseGeneral): ``kernel`` -> ``weight``, the
  kernel flattened to (in, out) and transposed, so q/k/v kernels
  (D, H, Dh) become (H*Dh, D) and the out kernel (H, Dh, D) becomes
  (D, H*Dh); ``bias`` flattened, (H, Dh) -> (H*Dh,);
- ``Conv2d``: ``kernel`` HWIO -> ``weight`` OIHW;
- ``LayerNorm``: ``scale`` -> ``weight``; ``Embed``: ``embedding`` ->
  ``weight``;
- any other parameter (``cls_token``, ``pos_embed``, LayerScale gains,
  the stacked ``experts_*`` of ``MOELayer``) keeps its name and layout.

A torch parameter without a flax leaf, a flax leaf that no parameter
takes, or a shape that does not match raises.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.models.layers import Dense, LayerNorm
from vivqa_tpu_torch.ops.embedding import Embed

_LEAF = {  # (module type, torch leaf) -> flax leaf
    (Dense, "weight"): "kernel",
    (nn.Conv2d, "weight"): "kernel",
    (LayerNorm, "weight"): "scale",
    (Embed, "weight"): "embedding",
}


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/kernel": array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _convert(module: nn.Module, leaf: str, arr: np.ndarray,
             shape: torch.Size) -> np.ndarray:
    if isinstance(module, Dense) and leaf == "weight":
        return arr.reshape(shape[1], shape[0]).T
    if isinstance(module, Dense) and leaf == "bias":
        return arr.reshape(-1)
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return arr.transpose(3, 2, 0, 1)
    return arr


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a Flax param tree into ``model`` in place; returns ``model``."""
    flat = flatten_params(params)
    used, missing = set(), []
    modules = dict(model.named_modules())
    with torch.no_grad():
        for mod_name, module in modules.items():
            for leaf, p in module.named_parameters(recurse=False):
                flax_leaf = next((fl for (t, tl), fl in _LEAF.items()
                                  if isinstance(module, t) and tl == leaf),
                                 leaf)
                flax_mod = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", mod_name)
                path = "/".join(s for s in (flax_mod.replace(".", "/"),
                                            flax_leaf) if s)
                if path not in flat:
                    missing.append(path)
                    continue
                arr = _convert(module, leaf, flat[path], p.shape)
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{path}: flax shape {flat[path].shape} -> "
                        f"{arr.shape}, port expects {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.ascontiguousarray(
                    arr, dtype=np.float32)))
                used.add(path)
    unused = sorted(set(flat) - used)
    if missing or unused:
        raise ValueError(f"flax params do not match the port: missing "
                         f"{missing}, unused {unused}")
    return model
