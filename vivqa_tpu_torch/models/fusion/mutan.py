"""MuTAN fusion (counterpart of vivqa_tpu/models/fusion/mutan.py): a
rank-R Tucker decomposition of the bilinear interaction between the
pooled visual and question vectors, the rank folded into one wide
product per modality. As in the JAX package it computes in bf16
whatever the model's dtype; its tokens are the two embedded vectors
[v0; q0] under an all-ones mask.
"""

from __future__ import annotations

import torch
from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, LayerNorm,
                                           dropout)

_DTYPE = torch.bfloat16


class MuTANFusion(nn.Module):
    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__()
        R, D = config.mutan_rank, config.hidden_dim
        self.config = config
        self.v_embed = Dense(visual_dim, D, dtype=_DTYPE)
        self.q_embed = Dense(text_dim, D, dtype=_DTYPE)
        self.v_factors = Dense(D, R * D, bias=False, dtype=_DTYPE)
        self.q_factors = Dense(D, R * D, bias=False, dtype=_DTYPE)
        self.out_proj = Dense(D, D, dtype=_DTYPE)
        self.ln = LayerNorm(D, _DTYPE)

    def forward(self, visual: dict, text: dict,
                rng: DropoutRNG | None = None) -> dict:
        cfg = self.config
        R, D = cfg.mutan_rank, cfg.hidden_dim
        v0 = dropout(torch.tanh(self.v_embed(visual["pooled"])), cfg.dropout,
                     rng)
        q0 = dropout(torch.tanh(self.q_embed(text["pooled"])), cfg.dropout,
                     rng)
        B = v0.shape[0]
        z = (torch.tanh(self.v_factors(v0).view(B, R, D))
             * torch.tanh(self.q_factors(q0).view(B, R, D))).sum(dim=1)
        tokens = torch.stack([v0, q0], dim=1)
        return {"pooled": self.ln(self.out_proj(z)), "tokens": tokens,
                "mask": torch.ones(tokens.shape[:2], dtype=torch.int32,
                                   device=tokens.device)}
