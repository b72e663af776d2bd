"""Q-Former fusion (counterpart of vivqa_tpu/models/fusion/qformer.py):
N learnable query tokens (``query_tokens``, an f32 parameter cast to the
compute dtype) run through layers of self-attention, cross-attention to
the image tokens (no mask) and cross-attention to the question tokens
(the question's key mask); the query stream is mean-pooled. Every
attention call goes through ``flash_attention``. As in the JAX package
the whole fusion computes in bf16 whatever the model's dtype (the flax
layer's ``dtype`` class attribute); its mask is all ones over the
queries.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, LayerNorm,
                                           MlpBlock,
                                           MultiHeadDotProductAttention,
                                           make_attention_mask)

_DTYPE = torch.bfloat16


class QFormerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0):
        super().__init__()
        dtype = _DTYPE

        def attention():
            return MultiHeadDotProductAttention(dim, num_heads, dtype=dtype,
                                                dropout_rate=dropout)
        self.ln1 = LayerNorm(dim, dtype)
        self.self_attn = attention()
        self.ln_v = LayerNorm(dim, dtype)
        self.cross_attn_vision = attention()
        self.ln_t = LayerNorm(dim, dtype)
        self.cross_attn_text = attention()
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, d_ff, dtype=dtype, dropout=dropout)

    def forward(self, queries: torch.Tensor, vis: torch.Tensor,
                txt: torch.Tensor, txt_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        y = self.ln1(queries)
        queries = queries + self.self_attn(y, y, None, rng)
        queries = queries + self.cross_attn_vision(self.ln_v(queries), vis,
                                                   None, rng)
        ones = torch.ones(queries.shape[:2], dtype=torch.int32,
                          device=queries.device)
        q2t = make_attention_mask(ones, txt_mask)
        queries = queries + self.cross_attn_text(self.ln_t(queries), txt,
                                                 q2t, rng)
        return queries + self.mlp(self.ln2(queries), rng)


class QFormerFusion(nn.Module):
    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__()
        cfg = config
        D = cfg.hidden_dim
        self.v_proj = Dense(visual_dim, D, dtype=_DTYPE)
        self.q_proj = Dense(text_dim, D, dtype=_DTYPE)
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_tokens, D))
        self.layers = nn.ModuleList(
            QFormerLayer(D, cfg.num_heads, 4 * D, cfg.dropout)
            for _ in range(cfg.num_layers))
        self.ln = LayerNorm(D, _DTYPE)

    def forward(self, visual: dict, text: dict,
                rng: DropoutRNG | None = None) -> dict:
        v = self.v_proj(visual["tokens"])
        t = self.q_proj(text["tokens"])
        x = self.query_tokens.expand(v.shape[0], -1, -1).to(v.dtype)
        for layer in self.layers:
            x = layer(x, v, t, text.get("mask"), rng)
        x = self.ln(x)
        return {"pooled": x.mean(dim=1), "tokens": x,
                "mask": torch.ones(x.shape[:2], dtype=torch.int32,
                                   device=x.device)}
