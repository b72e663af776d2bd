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
- ``LayerNorm`` and ``GroupNorm``: ``scale`` -> ``weight``; ``Embed``:
  ``embedding`` -> ``weight``;
- any other parameter (``cls_token``, ``pos_embed``, LayerScale gains,
  the stacked ``experts_*`` of ``MOELayer`` and the bias-free ones of
  ``SparseMOELayer``, the specialized experts' query slots,
  ``order_embed`` and ``relation_embeddings``, ResNet's ``FrozenAffine``
  ``scale`` and ``bias``, Swin's ``rel_pos_bias``, DeBERTa's
  ``rel_embeddings``, the ``query_tokens`` of the Q-Former and of
  ``VisionTokenEmbedding``, single-stream's ``modality_embed``) keeps
  its name and layout.

A ``ModuleDict`` key is a path segment like any other, so the VQA-MoE's
``experts`` dict of ``vision_0``, ``specialized_3_ocr``... maps onto the
flax names ``experts/vision_0``, ``experts/specialized_3_ocr``; a
``ModuleList`` index is one too, so the hierarchical MoE's ``group.1``
maps onto ``group_1`` and its ``group_router`` by name. Modules whose
flax names hold an index (ResNet's ``stage2_block0``, Swin's
``stage1_block1`` and ``merge0``, the zoo's ``stage0_conv``) are
attributes of those names. The
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

For the optimizers: ``flax_layouts`` gives each parameter's flax leaf
shape without a reference tree (a ``MultiHeadDotProductAttention``'s
query/key/value kernels are (D, H, Dh) and its out kernel (H, Dh, D), as
flax's DenseGeneral), and ``to_flax_view`` / ``from_flax_view`` turn a
tensor into that layout and back as views, so that adafactor factors the
dimensions of the flax leaf; ``check_one_to_one`` holds the port's leaves
1:1 with flax's (LAMB's trust ratio is a norm per leaf);
``optax_state_arrays`` reads an optax optimizer state (μ, ν, the
momentum trace or EMA, adafactor's factored rows and columns, the
lookahead's slow copy, as numpy) by flax path, and
``optimizer_state_from_flax`` lays those out as the port's optimizer
state.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.models.layers import (Dense, GroupNorm, LayerNorm,
                                           MultiHeadDotProductAttention)
from vivqa_tpu_torch.ops.embedding import Embed

_LEAF = {  # (module type, torch leaf) -> flax leaf
    (Dense, "weight"): "kernel",
    (nn.Conv2d, "weight"): "kernel",
    (nn.Conv1d, "weight"): "kernel",
    (LayerNorm, "weight"): "scale",
    (GroupNorm, "weight"): "scale",
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


# -- layouts for the optimizers ---------------------------------------------
def _flax_shape(parent, role: str, module: nn.Module, leaf: str,
                shape: torch.Size) -> tuple:
    """The flax leaf shape of parameter ``leaf`` of ``module``, the child
    ``role`` of ``parent``."""
    if isinstance(module, Dense):
        out_f, in_f = module.weight.shape
        heads = (parent.num_heads
                 if isinstance(parent, MultiHeadDotProductAttention)
                 else 0)
        if heads and role in ("query", "key", "value"):
            return ((in_f, heads, out_f // heads) if leaf == "weight"
                    else (heads, out_f // heads))
        if heads and role == "out" and leaf == "weight":
            return (heads, in_f // heads, out_f)
        return (in_f, out_f) if leaf == "weight" else (out_f,)
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if isinstance(module, nn.Conv1d) and leaf == "weight":
        o, i, k = shape
        return (k, i, o)
    return tuple(shape)


def flax_layouts(model: nn.Module) -> dict[str, tuple]:
    """torch parameter name -> (module, torch leaf, flax leaf shape)."""
    modules = dict(model.named_modules())
    out = {}
    for name, _, module, leaf, p in _named_leaves(model):
        mod_name = name.rsplit(".", 1)[0] if "." in name else ""
        parent_name, _, role = mod_name.rpartition(".")
        out[name] = (module, leaf, _flax_shape(
            modules.get(parent_name), role, module, leaf, p.shape))
    return out


def to_flax_view(layout: tuple, t: torch.Tensor) -> torch.Tensor:
    """A tensor of its parameter's shape, viewed in the flax layout."""
    module, leaf, flax_shape = layout
    if isinstance(module, Dense) and leaf == "weight":
        return t.T.reshape(flax_shape)
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return t.permute(2, 3, 1, 0)
    if isinstance(module, nn.Conv1d) and leaf == "weight":
        return t.permute(2, 1, 0)
    return t.reshape(flax_shape)


def from_flax_view(layout: tuple, t: torch.Tensor,
                   shape: torch.Size) -> torch.Tensor:
    """The inverse of ``to_flax_view``: flax layout -> the parameter's."""
    module, leaf, _ = layout
    if isinstance(module, Dense) and leaf == "weight":
        return t.reshape(shape[1], shape[0]).T
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return t.permute(3, 2, 0, 1)
    if isinstance(module, nn.Conv1d) and leaf == "weight":
        return t.permute(2, 1, 0)
    return t.reshape(shape)


def check_one_to_one(model: nn.Module,
                     flax_shapes: Mapping[str, tuple] | None = None) -> None:
    """Raise unless every parameter is one flax leaf of as many elements
    and no two share a path; with ``flax_shapes`` (path -> shape of the
    reference tree), also unless the paths and shapes are the same."""
    layouts = flax_layouts(model)
    paths = flax_paths(model)
    seen = {}
    for name, path in paths.items():
        if path in seen:
            raise ValueError(f"{name} and {seen[path]} share flax leaf {path}")
        seen[path] = name
        p = dict(model.named_parameters())[name]
        if int(np.prod(layouts[name][2])) != p.numel():
            raise ValueError(f"{name}: {tuple(p.shape)} is not flax leaf "
                             f"{layouts[name][2]}")
    if flax_shapes is not None:
        mine = {paths[n]: tuple(l[2]) for n, l in layouts.items()}
        ref = {k: tuple(v) for k, v in flax_shapes.items()}
        if mine != ref:
            diff = sorted(set(mine.items()) ^ set(ref.items()))
            raise ValueError(f"port leaves are not flax's: {diff[:6]}")


# fields of optax states that hold one array per parameter (or, for
# adafactor's factored leaves, per row or column)
_STATE_FIELDS = ("mu", "nu", "trace", "ema", "v_row", "v_col", "v", "slow")


def _is_leafless(x) -> bool:
    """optax's MaskedNode (an empty NamedTuple) and empty containers."""
    return isinstance(x, tuple) and len(x) == 0


def optax_state_arrays(opt_state) -> dict:
    """An optax state (after ``jax.device_get``: NamedTuples, dicts, numpy)
    -> {field: {flax path: array}} for the fields of ``_STATE_FIELDS``
    (the lookahead's ``slow`` is a dict key), and ``count``: the largest
    step count in it. Frozen leaves (MaskedNode) are left out."""
    out: dict = {"count": 0}

    def walk(x, field=None):
        if field in _STATE_FIELDS and isinstance(x, Mapping):
            flat = {}

            def leaves(tree, prefix=""):
                for k, v in tree.items():
                    path = f"{prefix}/{k}" if prefix else str(k)
                    if isinstance(v, Mapping):
                        leaves(v, path)
                    elif not _is_leafless(v):
                        flat[path] = np.asarray(v)
            leaves(x)
            out.setdefault(field, {}).update(flat)
            return
        if field == "count" and np.ndim(x) == 0:
            out["count"] = max(out["count"], int(np.asarray(x)))
            return
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), f)
        elif isinstance(x, Mapping):
            for k, v in x.items():
                walk(v, k)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(opt_state)
    return out


def optimizer_state_from_flax(model: nn.Module, arrays: Mapping
                              ) -> dict:
    """``optax_state_arrays`` -> {field: {torch name: f32 tensor}}: the
    per-parameter fields laid out as their parameter, adafactor's
    ``v_row`` / ``v_col`` (and a factored leaf's (1,) placeholders) kept
    in the flax layout, as the port's adafactor keeps them."""
    layouts = flax_layouts(model)
    params = dict(model.named_parameters())
    by_path = {path: name for name, path in flax_paths(model).items()}
    out: dict = {"count": int(arrays.get("count", 0))}
    for field, flat in arrays.items():
        if field == "count":
            continue
        dest = out.setdefault(field, {})
        for path, arr in flat.items():
            name = by_path[path]
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if field not in ("v_row", "v_col") and \
                    tuple(arr.shape) == tuple(layouts[name][2]):
                t = from_flax_view(layouts[name], t,
                                   params[name].shape).contiguous()
            dest[name] = t
    return out
