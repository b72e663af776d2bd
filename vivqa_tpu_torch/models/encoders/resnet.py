"""ResNet visual encoder, bottleneck-v1.5 (counterpart of
vivqa_tpu/models/encoders/resnet.py).

The public input is NHWC ``(B, H, W, 3)`` as everywhere in the port; the
convolutions run NCHW inside. Convolutions are torch-style (padding k//2
on each side, no bias), the stem's max pool is 3/2 with a 1-pixel pad of
-inf (``F.max_pool2d(x, 3, 2, 1)``, as the JAX module pads explicitly).
``resnet_norm="group"`` normalises with flax's GroupNorm (32 groups, f32
statistics by E[x^2] - E[x]^2, eps 1e-6; ``layers.GroupNorm``, not
``torch.nn.GroupNorm``); ``"frozen_bn"`` with ``FrozenAffine``, a
per-channel scale and bias (folded BatchNorm statistics). A block has
``downsample`` and ``downsample_norm`` only where its shape changes (the
first block of each stage). Tokens are the final map's H*W positions in
row-major order, ``pooled`` their mean.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.config import VisualEncoderConfig
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, GroupNorm,
                                           to_dtype)


def resnet_out_dim(cfg: VisualEncoderConfig) -> int:
    """The last stage's width: 4 * width * 2^(stages - 1)."""
    return 4 * cfg.resnet_width * 2 ** (len(cfg.resnet_stages) - 1)


class FrozenAffine(nn.Module):
    """Per-channel scale and bias over NCHW activations."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)[:, None, None] \
            + self.bias.to(x.dtype)[:, None, None]


def _norm(kind: str, channels: int, dtype: torch.dtype) -> nn.Module:
    if kind == "frozen_bn":
        return FrozenAffine(channels, dtype)
    return GroupNorm(channels, 32, dtype)


class _Conv(nn.Conv2d):
    """A bias-free torch-style convolution in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                        self.stride, self.padding)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1,
                 norm: str = "group", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = 4 * features
        self.conv1 = _Conv(cin, features, 1, 1, dtype)
        self.norm1 = _norm(norm, features, dtype)
        self.conv2 = _Conv(features, features, 3, strides, dtype)
        self.norm2 = _norm(norm, features, dtype)
        self.conv3 = _Conv(features, out, 1, 1, dtype)
        self.norm3 = _norm(norm, out, dtype)
        self.downsample = self.downsample_norm = None
        if cin != out or strides != 1:
            self.downsample = _Conv(cin, out, 1, strides, dtype)
            self.downsample_norm = _norm(norm, out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x if self.downsample is None else \
            self.downsample_norm(self.downsample(x))
        return F.relu(residual + y)


class ResNetEncoder(nn.Module):
    def __init__(self, config: VisualEncoderConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype = to_dtype(cfg.dtype)
        w = cfg.resnet_width
        self.stem = _Conv(3, w, 7, 2, dtype)
        self.stem_norm = _norm(cfg.resnet_norm, w, dtype)
        self.blocks = []                # flax names, in order
        cin, features = w, w
        for stage, blocks in enumerate(cfg.resnet_stages):
            for b in range(blocks):
                name = f"stage{stage}_block{b}"
                self.add_module(name, Bottleneck(
                    cin, features, 2 if (b == 0 and stage > 0) else 1,
                    cfg.resnet_norm, dtype))
                self.blocks.append(name)
                cin = 4 * features
            features *= 2
        if cfg.output_dim:
            self.projection = Dense(cin, cfg.output_dim, bias=False,
                                    dtype=dtype)

    def forward(self, pixel_values: torch.Tensor,
                rng: DropoutRNG | None = None) -> dict:
        """pixel_values: (B, H, W, 3) NHWC."""
        x = pixel_values.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_norm(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        tokens = x.flatten(2).transpose(1, 2)              # (B, H*W, C)
        pooled = tokens.mean(dim=1)
        if self.config.output_dim:
            pooled, tokens = self.projection(pooled), self.projection(tokens)
        return {"pooled": pooled, "tokens": tokens}
