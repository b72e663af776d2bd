"""Single-stream (ViLT-style) fusion (counterpart of
vivqa_tpu/models/fusion/single_stream.py): modality-type embeddings
(``modality_embed``, rows CLS / image / question), a CLS token
(``cls_token``, zero-initialised) and one joint encoder over the
1 + Lv + Lt tokens [CLS; image; question] under the query-AND-key mask
of their concatenated validity; ``pooled`` is the CLS token. As in the
JAX package it computes in bf16 whatever the model's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, EncoderLayer,
                                           LayerNorm, make_attention_mask)

_DTYPE = torch.bfloat16


class SingleStreamFusion(nn.Module):
    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__()
        cfg = config
        D = cfg.hidden_dim
        self.v_proj = Dense(visual_dim, D, dtype=_DTYPE)
        self.q_proj = Dense(text_dim, D, dtype=_DTYPE)
        self.modality_embed = nn.Parameter(torch.empty(3, D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.layers = nn.ModuleList(
            EncoderLayer(D, cfg.num_heads, 4 * D, dtype=_DTYPE,
                         dropout=cfg.dropout)
            for _ in range(cfg.num_layers))
        self.ln = LayerNorm(D, _DTYPE)

    def forward(self, visual: dict, text: dict,
                rng: DropoutRNG | None = None) -> dict:
        v = self.v_proj(visual["tokens"])
        t = self.q_proj(text["tokens"])
        B, D, dt, dev = v.shape[0], v.shape[-1], v.dtype, v.device
        t_mask = text.get("mask")
        t_mask = torch.ones(t.shape[:2], dtype=torch.int32, device=dev) \
            if t_mask is None else t_mask.to(torch.int32)
        embed = self.modality_embed.to(dt)
        cls = self.cls_token.expand(B, 1, D).to(dt) + embed[0]
        x = torch.cat([cls, v + embed[1], t + embed[2]], dim=1)
        mask = torch.cat([torch.ones(B, 1 + v.shape[1], dtype=torch.int32,
                                     device=dev), t_mask], dim=1)
        attn = make_attention_mask(mask, mask)
        for layer in self.layers:
            x = layer(x, attn, rng)
        x = self.ln(x)
        return {"pooled": x[:, 0], "tokens": x, "mask": mask}
