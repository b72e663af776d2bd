"""Fusion factory (counterpart of vivqa_tpu/models/fusion/__init__.py).

All eight fusions of the JAX package: concat, add, bilinear,
cross-attention, MCAN, MuTAN, Q-Former and single-stream, each built
from the config and the two encoders' output widths.
"""

from __future__ import annotations

from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig, FUSION_TYPES
from vivqa_tpu_torch.models.fusion.basic import (AddFusion, BilinearFusion,
                                                 ConcatFusion,
                                                 CrossAttentionFusion)
from vivqa_tpu_torch.models.fusion.mcan import AttFlat, MCANFusion
from vivqa_tpu_torch.models.fusion.mutan import MuTANFusion
from vivqa_tpu_torch.models.fusion.qformer import QFormerFusion, QFormerLayer
from vivqa_tpu_torch.models.fusion.single_stream import SingleStreamFusion

_FUSIONS = {"concat": ConcatFusion, "add": AddFusion,
            "bilinear": BilinearFusion,
            "cross_attention": CrossAttentionFusion, "mcan": MCANFusion,
            "mutan": MuTANFusion, "qformer": QFormerFusion,
            "single_stream": SingleStreamFusion}
_ALIASES = {"cross-attention": "cross_attention", "q_former": "qformer",
            "vilt": "single_stream", "joint": "single_stream"}


def create_fusion(config: FusionConfig, visual_dim: int,
                  text_dim: int) -> nn.Module:
    kind = _ALIASES.get(config.fusion_type, config.fusion_type)
    if kind not in _FUSIONS:
        raise ValueError(f"unknown fusion '{config.fusion_type}' "
                         f"(choices: {FUSION_TYPES})")
    return _FUSIONS[kind](config, visual_dim, text_dim)


__all__ = ["create_fusion", "ConcatFusion", "AddFusion", "BilinearFusion",
           "CrossAttentionFusion", "MCANFusion", "AttFlat", "MuTANFusion",
           "QFormerFusion", "QFormerLayer", "SingleStreamFusion"]
