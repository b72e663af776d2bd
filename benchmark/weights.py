"""Weights made from the seed, by parameter name, for the program and the
reference alike.

One ``torch.randn`` call on the device fills a flat float32 buffer with
a generator seeded from the run's seed; each parameter is a slice of it,
scaled by its law:

- tables (token, position and type embeddings, the class token):
  normal(0, 0.02);
- LayerNorm scales (a ``weight`` of a module named ``ln*``):
  1 + normal(0, 0.02); other one-axis leaves (biases, LayerNorm
  offsets): normal(0, 0.02);
- kernels: normal(0, 1 / sqrt(fan_in)), fan_in the second axis of a
  matrix (out, in) or of stacked experts (E, in, out), and the product
  of every axis but the first of a convolution (O, I, k, k).
"""

from __future__ import annotations

import math
import re

import torch

from benchmark.reference.layers import fold_in

WEIGHT_STREAM = 1
TABLE = re.compile(r"(^|\.)((token|pos|type)_embed|cls_token)(\.|$)")


def law(name: str, shape: tuple) -> tuple:
    """(std, offset) of the parameter ``name`` of ``shape``."""
    parts = name.split(".")
    if TABLE.search(name):
        return 0.02, 0.0
    if len(shape) == 1:
        is_scale = parts[-1] == "weight" and len(parts) > 1 \
            and parts[-2].startswith("ln")
        return 0.02, 1.0 if is_scale else 0.0
    fan_in = shape[1] if len(shape) in (2, 3) else math.prod(shape[1:])
    return 1.0 / math.sqrt(fan_in), 0.0


def make_weights(named_shapes: list, seed: int, device) -> dict:
    """{name: float32 tensor} for ``named_shapes`` [(name, shape), ...];
    the same seed, names and shapes give the same tensors."""
    total = sum(math.prod(s) for _, s in named_shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(seed, WEIGHT_STREAM))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        std, base = law(name, tuple(shape))
        out[name] = flat[offset:offset + n].view(shape).mul_(std).add_(base)
        offset += n
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters by name; every
    parameter must be given, with its shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(params) - set(weights))[:5]
        extra = sorted(set(weights) - set(params))[:5]
        raise ValueError(f"weights and parameters differ: missing "
                         f"{missing}, unknown {extra}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: parameter {tuple(p.shape)}, weights "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
