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
- ``Conv2d``: ``kernel`` HWIO -> ``weight`` OIHW; ``Conv1d`` (the
  segmentation expert's convolutions over the token axis): ``kernel``
  (K, in, out) -> ``weight`` (out, in, K);
- ``LayerNorm``: ``scale`` -> ``weight``; ``Embed``: ``embedding`` ->
  ``weight``;
- any other parameter (``cls_token``, ``pos_embed``, LayerScale gains,
  the stacked ``experts_*`` of ``MOELayer``, the specialized experts'
  query slots, ``order_embed`` and ``relation_embeddings``) keeps its
  name and layout.

A ``ModuleDict`` key is a path segment like any other, so the VQA-MoE's
``experts`` dict of ``vision_0``, ``specialized_3_ocr``... maps onto the
flax names ``experts/vision_0``, ``experts/specialized_3_ocr``. The
knowledge modules carry the flax names too (``knowledge_attn/k_proj``,
``knowledge_attn/context_attn/{query,key,value,out}``, ``knowledge_proj``,
``knowledge_ln``; ``ContextAttention``'s ``k_proj``, ``q_proj``,
``attn/*`` and ``ln``; ``RAGFusion``'s ``merge`` and ``gate``), so they
map by the same rules.

A torch parameter without a flax leaf, a flax leaf that no parameter
takes, or a shape that does not match raises. Only the ``params``
collection maps: buffers (the decoder's sinusoidal ``pos_table``) are
not parameters, and flax's ``cache`` collection has its counterpart in
``models/decoder.py:DecodeCache``, built at run time.

The inverse, ``flax_paths`` and ``to_flax``, names each torch parameter by
its flax path and lays a tensor of its shape (a parameter, its gradient,
its update) out as the flax leaf, so that tests compare the port with a
``jax.grad`` tree leaf by leaf, and the optimizer's weight-decay mask
matches the flax paths as the JAX package's does.
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
    (nn.Conv1d, "weight"): "kernel",
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
    if isinstance(module, nn.Conv1d) and leaf == "weight":
        return arr.transpose(2, 1, 0)
    return arr


def _to_flax_layout(module: nn.Module, leaf: str, arr: np.ndarray,
                    flax_shape: tuple) -> np.ndarray:
    """The inverse of ``_convert``: torch layout -> the flax leaf's."""
    if isinstance(module, Dense) and leaf == "weight":
        return arr.T.reshape(flax_shape)
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return arr.transpose(2, 3, 1, 0)
    if isinstance(module, nn.Conv1d) and leaf == "weight":
        return arr.transpose(2, 1, 0)
    return arr.reshape(flax_shape)


def _named_leaves(model: nn.Module):
    """(torch name, flax path, module, torch leaf, parameter) for every
    parameter of ``model``."""
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            flax_leaf = next((fl for (t, tl), fl in _LEAF.items()
                              if isinstance(module, t) and tl == leaf), leaf)
            flax_mod = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", mod_name)
            path = "/".join(s for s in (flax_mod.replace(".", "/"),
                                        flax_leaf) if s)
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            yield name, path, module, leaf, p


def flax_paths(model: nn.Module) -> dict[str, str]:
    """torch parameter name -> flax path ("text_encoder/layers_0/...")."""
    return {name: path for name, path, *_ in _named_leaves(model)}


def to_flax(model: nn.Module, tensors: Mapping[str, torch.Tensor],
            flax_shapes: Mapping[str, tuple]) -> dict[str, np.ndarray]:
    """Tensors keyed by torch parameter name (each of its parameter's
    shape) -> f32 arrays keyed by flax path, in the flax layout.
    ``flax_shapes`` (path -> shape, e.g. from ``flatten_params`` of the
    reference tree) restores the (D, H, Dh) form of DenseGeneral kernels.
    A name missing from ``tensors`` is left out."""
    out = {}
    for name, path, module, leaf, _ in _named_leaves(model):
        if name in tensors:
            arr = tensors[name].detach().float().cpu().numpy()
            out[path] = _to_flax_layout(module, leaf, arr,
                                        tuple(flax_shapes[path]))
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a Flax param tree into ``model`` in place; returns ``model``."""
    flat = flatten_params(params)
    used, missing = set(), []
    with torch.no_grad():
        for _, path, module, leaf, p in _named_leaves(model):
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
