"""Encoder factories (counterpart of vivqa_tpu/models/encoders/__init__.py).

Every visual backbone of the JAX package (the ViT family: vit, clip,
dino; resnet; swin) and the text family. The representation zoo and
DeBERTa are built by ``representation.create_image_representation`` and
``create_text_embedding``, as in the JAX package.
"""

from __future__ import annotations

from torch import nn

from vivqa_tpu_torch.models.config import (TextEncoderConfig,
                                           VisualEncoderConfig,
                                           TEXT_BACKBONES, VISUAL_BACKBONES)
from vivqa_tpu_torch.models.encoders.resnet import (ResNetEncoder,
                                                    resnet_out_dim)
from vivqa_tpu_torch.models.encoders.swin import SwinEncoder, swin_out_dim
from vivqa_tpu_torch.models.encoders.text import TextEncoder
from vivqa_tpu_torch.models.encoders.vit import ViTEncoder


def create_visual_encoder(config: VisualEncoderConfig) -> nn.Module:
    if config.backbone not in VISUAL_BACKBONES:
        raise ValueError(f"unknown visual backbone '{config.backbone}' "
                         f"(choices: {VISUAL_BACKBONES})")
    if config.backbone in ("vit", "clip", "dino"):
        return ViTEncoder(config)
    if config.backbone == "resnet":
        return ResNetEncoder(config)
    return SwinEncoder(config)


def visual_out_dim(config: VisualEncoderConfig) -> int:
    """The width of the visual encoder's tokens and pooled vector (flax
    infers it at the first call; the port builds the next layer from
    it): the projection's, else the backbone's own."""
    if config.output_dim:
        return config.output_dim
    if config.backbone == "resnet":
        return resnet_out_dim(config)
    if config.backbone == "swin":
        return swin_out_dim(config)
    return config.hidden_dim


def create_text_encoder(config: TextEncoderConfig) -> nn.Module:
    if config.backbone not in TEXT_BACKBONES:
        raise ValueError(f"unknown text backbone '{config.backbone}' "
                         f"(choices: {TEXT_BACKBONES})")
    return TextEncoder(config)


__all__ = ["ViTEncoder", "ResNetEncoder", "SwinEncoder", "TextEncoder",
           "create_visual_encoder", "create_text_encoder", "visual_out_dim"]
