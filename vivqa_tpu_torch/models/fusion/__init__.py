"""Fusion factory (counterpart of vivqa_tpu/models/fusion/__init__.py).

MCAN and the four basic fusions (concat, add, bilinear,
cross-attention) are ported; mutan, qformer and single_stream wait for
ROADMAP.md Queue A item 13.
"""

from __future__ import annotations

from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig, FUSION_TYPES
from vivqa_tpu_torch.models.fusion.basic import (AddFusion, BilinearFusion,
                                                 ConcatFusion,
                                                 CrossAttentionFusion)
from vivqa_tpu_torch.models.fusion.mcan import AttFlat, MCANFusion

_FUSIONS = {"concat": ConcatFusion, "add": AddFusion,
            "bilinear": BilinearFusion,
            "cross_attention": CrossAttentionFusion, "mcan": MCANFusion}
_ALIASES = {"cross-attention": "cross_attention", "q_former": "qformer",
            "vilt": "single_stream", "joint": "single_stream"}


def create_fusion(config: FusionConfig, visual_dim: int,
                  text_dim: int) -> nn.Module:
    kind = _ALIASES.get(config.fusion_type, config.fusion_type)
    if kind not in FUSION_TYPES:
        raise ValueError(f"unknown fusion '{config.fusion_type}' "
                         f"(choices: {FUSION_TYPES})")
    if kind in _FUSIONS:
        return _FUSIONS[kind](config, visual_dim, text_dim)
    raise NotImplementedError(
        f"fusion '{kind}' is not ported yet (ROADMAP.md Queue A item 13)")


__all__ = ["create_fusion", "ConcatFusion", "AddFusion", "BilinearFusion",
           "CrossAttentionFusion", "MCANFusion", "AttFlat"]
