"""Fusion factory (counterpart of vivqa_tpu/models/fusion/__init__.py).

MCAN is ported; the other fusion types wait for ROADMAP.md Queue A
item 13.
"""

from __future__ import annotations

from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig, FUSION_TYPES
from vivqa_tpu_torch.models.fusion.mcan import AttFlat, MCANFusion

_ALIASES = {"cross-attention": "cross_attention", "q_former": "qformer",
            "vilt": "single_stream", "joint": "single_stream"}


def create_fusion(config: FusionConfig, visual_dim: int,
                  text_dim: int) -> nn.Module:
    kind = _ALIASES.get(config.fusion_type, config.fusion_type)
    if kind not in FUSION_TYPES:
        raise ValueError(f"unknown fusion '{config.fusion_type}' "
                         f"(choices: {FUSION_TYPES})")
    if kind == "mcan":
        return MCANFusion(config, visual_dim, text_dim)
    raise NotImplementedError(
        f"fusion '{kind}' is not ported yet (ROADMAP.md Queue A item 13)")


__all__ = ["create_fusion", "MCANFusion", "AttFlat"]
