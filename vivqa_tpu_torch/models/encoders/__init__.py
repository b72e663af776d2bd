"""Encoder factories (counterpart of vivqa_tpu/models/encoders/__init__.py).

The ViT family (vit, clip, dino) and the text family are ported; ResNet
and Swin wait for ROADMAP.md Queue A item 13.
"""

from __future__ import annotations

from torch import nn

from vivqa_tpu_torch.models.config import (TextEncoderConfig,
                                           VisualEncoderConfig,
                                           TEXT_BACKBONES, VISUAL_BACKBONES)
from vivqa_tpu_torch.models.encoders.text import TextEncoder
from vivqa_tpu_torch.models.encoders.vit import ViTEncoder


def create_visual_encoder(config: VisualEncoderConfig) -> nn.Module:
    if config.backbone not in VISUAL_BACKBONES:
        raise ValueError(f"unknown visual backbone '{config.backbone}' "
                         f"(choices: {VISUAL_BACKBONES})")
    if config.backbone in ("vit", "clip", "dino"):
        return ViTEncoder(config)
    raise NotImplementedError(
        f"visual backbone '{config.backbone}' is not ported yet "
        "(ROADMAP.md Queue A item 13)")


def create_text_encoder(config: TextEncoderConfig) -> nn.Module:
    if config.backbone not in TEXT_BACKBONES:
        raise ValueError(f"unknown text backbone '{config.backbone}' "
                         f"(choices: {TEXT_BACKBONES})")
    return TextEncoder(config)


__all__ = ["ViTEncoder", "TextEncoder", "create_visual_encoder",
           "create_text_encoder"]
