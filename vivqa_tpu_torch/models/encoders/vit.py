"""Vision Transformer visual encoder (counterpart of
vivqa_tpu/models/encoders/vit.py), both ``vit_style`` values.

The public input stays NHWC ``(B, H, W, 3)`` as in the JAX package; the
patch embedding is one strided convolution.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.config import VisualEncoderConfig
from vivqa_tpu_torch.models.layers import (Dense, EncoderLayer, LayerNorm,
                                           to_dtype)


class ViTEncoder(nn.Module):
    def __init__(self, config: VisualEncoderConfig):
        super().__init__()
        cfg = config
        if cfg.image_size < cfg.patch_size or cfg.image_size % cfg.patch_size:
            raise ValueError(
                f"image_size={cfg.image_size} must be a positive multiple of "
                f"patch_size={cfg.patch_size}")
        self.config = cfg
        self.dtype = to_dtype(cfg.dtype)
        D = cfg.hidden_dim
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, D, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, D))
        if cfg.vit_style == "clip":
            self.ln_pre = LayerNorm(D, self.dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(D, cfg.num_heads, int(D * cfg.mlp_ratio),
                         dtype=self.dtype, activation=cfg.activation,
                         layer_scale_init=cfg.layer_scale_init)
            for _ in range(cfg.num_layers))
        self.ln_final = LayerNorm(D, self.dtype)
        if cfg.output_dim:
            self.projection = Dense(D, cfg.output_dim, bias=False,
                                    dtype=self.dtype)

    def forward(self, pixel_values: torch.Tensor) -> dict:
        """pixel_values: (B, H, W, 3) NHWC."""
        cfg, dtype = self.config, self.dtype
        B = pixel_values.shape[0]
        w = self.patch_embed
        x = F.conv2d(pixel_values.to(dtype).permute(0, 3, 1, 2),
                     w.weight.to(dtype), w.bias.to(dtype),
                     stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)                  # (B, n_patches, D)
        cls = self.cls_token.expand(B, 1, cfg.hidden_dim).to(dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        if cfg.vit_style == "clip":
            x = self.ln_pre(x)
        for layer in self.layers:
            x = layer(x)
        if cfg.vit_style == "clip":
            # the final LN normalizes the pooled path only (HF CLIP parity)
            pooled, tokens = self.ln_final(x[:, 0]), x[:, 1:]
        else:
            x = self.ln_final(x)
            pooled, tokens = x[:, 0], x[:, 1:]
        if cfg.output_dim:
            pooled, tokens = self.projection(pooled), self.projection(tokens)
        return {"pooled": pooled, "tokens": tokens}
