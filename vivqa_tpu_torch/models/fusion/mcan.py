"""MCAN fusion (counterpart of vivqa_tpu/models/fusion/mcan.py): an
encoder of self-attention layers over the question, a decoder of
self-attention + question-guided attention layers over the image tokens,
then attentional flattening of both streams.

As in the JAX package the whole stack computes in bf16 whatever the
model's dtype, and ``AttFlat``'s softmax is f32 with -1e9 masking.
"""

from __future__ import annotations

import torch
from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig
from vivqa_tpu_torch.models.layers import (CrossAttentionLayer, Dense,
                                           EncoderLayer, LayerNorm,
                                           gelu_tanh, make_attention_mask)

_DTYPE = torch.bfloat16


class AttFlat(nn.Module):
    """MLP -> masked softmax over tokens -> weighted sum, g glimpses."""

    def __init__(self, dim: int, hidden_dim: int, glimpses: int = 1,
                 mlp_dim: int = 512):
        super().__init__()
        self.glimpses = glimpses
        self.att_fc1 = Dense(dim, mlp_dim, dtype=_DTYPE)
        self.att_fc2 = Dense(mlp_dim, glimpses, dtype=_DTYPE)
        self.merge = Dense(glimpses * dim, hidden_dim, dtype=_DTYPE)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        att = self.att_fc2(gelu_tanh(self.att_fc1(x)))
        if mask is not None:
            att = torch.where(mask[..., None] > 0, att, -1e9)
        att = torch.softmax(att.float(), dim=1).to(x.dtype)
        flat = torch.einsum("blg,bld->bgd", att, x).reshape(x.shape[0], -1)
        return self.merge(flat)


class MCANFusion(nn.Module):
    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__()
        cfg = config
        D = cfg.hidden_dim
        self.v_proj = Dense(visual_dim, D, dtype=_DTYPE)
        self.q_proj = Dense(text_dim, D, dtype=_DTYPE)
        self.enc = nn.ModuleList(
            EncoderLayer(D, cfg.num_heads, 4 * D, dtype=_DTYPE)
            for _ in range(cfg.num_layers))
        self.dec = nn.ModuleList(
            CrossAttentionLayer(D, cfg.num_heads, 4 * D, dtype=_DTYPE)
            for _ in range(cfg.num_layers))
        self.q_flat = AttFlat(D, D, cfg.mcan_flat_glimpses,
                              cfg.mcan_flat_mlp_dim)
        self.v_flat = AttFlat(D, D, cfg.mcan_flat_glimpses,
                              cfg.mcan_flat_mlp_dim)
        self.ln = LayerNorm(D, _DTYPE)

    def forward(self, visual: dict, text: dict) -> dict:
        v = self.v_proj(visual["tokens"])
        q = self.q_proj(text["tokens"])
        t_mask = text.get("mask")
        v_ones = torch.ones(v.shape[:2], dtype=torch.int32, device=v.device)
        qq = make_attention_mask(t_mask, t_mask)
        v2q = make_attention_mask(v_ones, t_mask)
        for layer in self.enc:
            q = layer(q, qq)
        for layer in self.dec:
            v = layer(v, q, cross_mask=v2q)
        pooled = self.ln(self.q_flat(q, t_mask) + self.v_flat(v, None))
        tokens = torch.cat([v, q], dim=1)
        if t_mask is None:
            t_mask = torch.ones(q.shape[:2], dtype=torch.int32,
                                device=q.device)
        mask = torch.cat([v_ones, t_mask.to(torch.int32)], dim=1)
        return {"pooled": pooled, "tokens": tokens, "mask": mask}
