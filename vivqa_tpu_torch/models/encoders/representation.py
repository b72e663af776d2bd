"""The representation zoo (counterpart of
vivqa_tpu/models/encoders/representation.py): image and text embedding
modules, each returning {"pooled", "tokens"}.

- ``RegionBasedVisionEmbedding``: three stride-2 conv blocks, the map
  average-pooled to a grid of pseudo-regions, plus a projection of each
  region's normalised box (x1, y1, x2, y2, area);
- ``MultiResolutionFeatures``: a conv pyramid with lateral 1x1s and a
  top-down FPN (nearest upsampling), every level pooled to a 4x4 grid;
- ``VisionTokenEmbedding``: learnable query tokens that cross-attend into
  the conv map (through ``flash_attention``, 4 heads);
- ``create_image_representation`` and ``create_text_embedding`` (the
  BERT-family kinds adjust ``type_vocab_size``; "deberta" builds
  ``DeBERTaEncoder``).

As in the JAX package the three image modules compute in bf16 whatever
the config's dtype. Pixels are NHWC, the maps NCHW inside. Two flax
rules are kept: the conv blocks and the FPN's 3x3 smoothing use flax's
"SAME" padding, which for a stride-2 3x3 convolution over an even size
pads (0, 1), not (1, 1) (``same_pads``: XLA's low and high pad per
axis); and ``jax.image.resize(method="nearest")`` samples at half-pixel
centres, which is ``F.interpolate(mode="nearest-exact")``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.config import (TextEncoderConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.models.encoders.text import TextEncoder
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, GroupNorm,
                                           LayerNorm,
                                           MultiHeadDotProductAttention,
                                           gelu_tanh)

_DTYPE = torch.bfloat16


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """flax ``nn.Conv`` with "SAME" padding, in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, k, stride=stride, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (hl, hh), (wl, wh) = (same_pads(n, k, s) for n in x.shape[2:])
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(F.pad(x.to(self.dtype), (wl, wh, hl, hh)),
                        self.weight.to(self.dtype), b, s)


def grid_boxes(grid: int) -> np.ndarray:
    """Normalized (x1, y1, x2, y2, area) per pseudo-region."""
    boxes = []
    for i in range(grid):
        for j in range(grid):
            x1, y1 = j / grid, i / grid
            x2, y2 = (j + 1) / grid, (i + 1) / grid
            boxes.append([x1, y1, x2, y2, (x2 - x1) * (y2 - y1)])
    return np.asarray(boxes, np.float32)


def _pool_to_grid(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, g, g) by average pooling,
    g = min(grid, H, W)."""
    B, C, H, W = x.shape
    g = min(grid, H, W)
    gh, gw = H // g, W // g
    x = x[:, :, :gh * g, :gw * g].reshape(B, C, g, gh, g, gw)
    return x.mean(dim=(3, 5))


class _ConvStages(nn.Module):
    """Stride-2 conv blocks ``stage{i}_conv`` (3x3, no bias, SAME) ->
    ``stage{i}_gn`` (GroupNorm of min(32, width) groups) -> relu."""

    def __init__(self, widths):
        super().__init__()
        self.stages = len(widths)
        cin = 3
        for i, width in enumerate(widths):
            self.add_module(f"stage{i}_conv", SameConv(cin, width, 3, 2,
                                                       False, _DTYPE))
            self.add_module(f"stage{i}_gn", GroupNorm(width, min(32, width),
                                                      _DTYPE))
            cin = width

    def block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self, f"stage{i}_gn")(
            getattr(self, f"stage{i}_conv")(x)))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = pixel_values.to(_DTYPE).permute(0, 3, 1, 2)
        for i in range(self.stages):
            x = self.block(i, x)
        return x


class RegionBasedVisionEmbedding(_ConvStages):
    """Grid pseudo-regions + bbox spatial features."""

    def __init__(self, config: VisualEncoderConfig, grid: int = 7):
        w = config.resnet_width
        super().__init__((w, 2 * w, 4 * w))
        self.config, self.grid = config, grid
        self.spatial_proj = Dense(5, 4 * w, dtype=_DTYPE)
        self.ln = LayerNorm(4 * w, _DTYPE)
        if config.output_dim:
            self.projection = Dense(4 * w, config.output_dim, dtype=_DTYPE)

    def forward(self, pixel_values: torch.Tensor,
                rng: DropoutRNG | None = None) -> dict:
        regions = _pool_to_grid(super().forward(pixel_values), self.grid)
        B, C, g = regions.shape[:3]
        feats = regions.flatten(2).transpose(1, 2)           # (B, g*g, C)
        boxes = torch.from_numpy(grid_boxes(g)).to(feats.device, _DTYPE)
        spatial = self.spatial_proj(boxes.expand(B, g * g, 5))
        tokens = self.ln(feats + spatial)
        if self.config.output_dim:
            tokens = self.projection(tokens)
        return {"pooled": tokens.mean(dim=1), "tokens": tokens}


class MultiResolutionFeatures(_ConvStages):
    """Conv pyramid + lateral/top-down FPN; tokens are every level pooled
    to a 4x4 grid, concatenated, LayerNormed."""

    def __init__(self, config: VisualEncoderConfig, fpn_dim: int = 256,
                 num_levels: int = 3):
        w = config.resnet_width
        widths = [w * 2 ** i for i in range(num_levels)]
        super().__init__(widths)
        self.config, self.fpn_dim, self.num_levels = config, fpn_dim, \
            num_levels
        for i, width in enumerate(widths):
            self.add_module(f"lateral{i}", SameConv(width, fpn_dim, 1,
                                                    dtype=_DTYPE))
        for i in range(num_levels):
            self.add_module(f"smooth{i}", SameConv(fpn_dim, fpn_dim, 3,
                                                   dtype=_DTYPE))
        self.ln = LayerNorm(fpn_dim, _DTYPE)
        if config.output_dim:
            self.projection = Dense(fpn_dim, config.output_dim, dtype=_DTYPE)

    def forward(self, pixel_values: torch.Tensor,
                rng: DropoutRNG | None = None) -> dict:
        x = pixel_values.to(_DTYPE).permute(0, 3, 1, 2)
        feats = []
        for i in range(self.stages):
            x = self.block(i, x)
            feats.append(x)
        fpn = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.num_levels - 2, -1, -1):
            fpn[i] = fpn[i] + F.interpolate(fpn[i + 1],
                                            size=fpn[i].shape[2:],
                                            mode="nearest-exact")
        levels = [_pool_to_grid(getattr(self, f"smooth{i}")(f), 4)
                  .flatten(2).transpose(1, 2) for i, f in enumerate(fpn)]
        tokens = self.ln(torch.cat(levels, dim=1))
        if self.config.output_dim:
            tokens = self.projection(tokens)
        return {"pooled": tokens.mean(dim=1), "tokens": tokens}


class VisionTokenEmbedding(_ConvStages):
    """Learnable query tokens cross-attend into the conv feature map
    (Perceiver/BLIP-2 style)."""

    def __init__(self, config: VisualEncoderConfig, num_tokens: int = 32,
                 num_layers: int = 2):
        w = config.resnet_width
        super().__init__((w, 2 * w, 4 * w))
        C = 4 * w
        self.config, self.num_layers = config, num_layers
        self.query_tokens = nn.Parameter(torch.empty(1, num_tokens, C))
        for i in range(num_layers):
            self.add_module(f"ln_q{i}", LayerNorm(C, _DTYPE))
            self.add_module(f"cross_attn{i}", MultiHeadDotProductAttention(
                C, 4, dtype=_DTYPE))
            self.add_module(f"ln_m{i}", LayerNorm(C, _DTYPE))
            self.add_module(f"mlp{i}_wi", Dense(C, 4 * C, dtype=_DTYPE))
            self.add_module(f"mlp{i}_wo", Dense(4 * C, C, dtype=_DTYPE))
        self.ln = LayerNorm(C, _DTYPE)
        if config.output_dim:
            self.projection = Dense(C, config.output_dim, dtype=_DTYPE)

    def forward(self, pixel_values: torch.Tensor,
                rng: DropoutRNG | None = None) -> dict:
        x = super().forward(pixel_values)
        feat = x.flatten(2).transpose(1, 2)                  # (B, H*W, C)
        q = self.query_tokens.expand(feat.shape[0], -1, -1).to(feat.dtype)
        for i in range(self.num_layers):
            y = getattr(self, f"ln_q{i}")(q)
            q = q + getattr(self, f"cross_attn{i}")(y, feat, None, rng)
            y = gelu_tanh(getattr(self, f"mlp{i}_wi")(
                getattr(self, f"ln_m{i}")(q)))
            q = q + getattr(self, f"mlp{i}_wo")(y)
        tokens = self.ln(q)
        if self.config.output_dim:
            tokens = self.projection(tokens)
        return {"pooled": tokens.mean(dim=1), "tokens": tokens}


_IMAGE_REPRESENTATIONS = {
    "region_based": RegionBasedVisionEmbedding,
    "vit": None,                    # resolved to ViTEncoder below
    "multi_resolution": MultiResolutionFeatures,
    "vision_token": VisionTokenEmbedding,
}


def create_image_representation(kind: str, config: VisualEncoderConfig,
                                **kwargs) -> nn.Module:
    if kind == "vit":
        from vivqa_tpu_torch.models.encoders.vit import ViTEncoder
        return ViTEncoder(config)
    if _IMAGE_REPRESENTATIONS.get(kind) is None:
        raise ValueError(f"unknown image representation '{kind}' "
                         f"(choices: {tuple(_IMAGE_REPRESENTATIONS)})")
    return _IMAGE_REPRESENTATIONS[kind](config, **kwargs)


TEXT_EMBEDDING_KINDS = ("bert", "roberta", "deberta", "phobert", "generic")


def create_text_embedding(kind: str, config: TextEncoderConfig) -> nn.Module:
    """Unknown names fall back to the generic transformer embedding."""
    if kind not in TEXT_EMBEDDING_KINDS:
        kind = "generic"
    if kind == "deberta":
        from vivqa_tpu_torch.models.encoders.deberta import (DeBERTaConfig,
                                                             DeBERTaEncoder)
        return DeBERTaEncoder(DeBERTaConfig(
            vocab_size=config.vocab_size, hidden_dim=config.hidden_dim,
            num_layers=config.num_layers, num_heads=config.num_heads,
            mlp_ratio=config.mlp_ratio, max_length=config.max_length,
            pooling=config.pooling, dropout=config.dropout,
            output_dim=config.output_dim, dtype=config.dtype))
    if kind in ("roberta", "phobert"):
        config = config.replace(type_vocab_size=1)
    elif kind == "bert":
        config = config.replace(type_vocab_size=max(2, config.type_vocab_size))
    return TextEncoder(config)
