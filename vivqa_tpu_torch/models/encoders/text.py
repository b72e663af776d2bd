"""BERT-family text encoder (counterpart of
vivqa_tpu/models/encoders/text.py).

Inputs are padded to ``config.max_length``; the (B, L) padding mask
becomes a (B, 1, L, L) query-AND-key mask, so padded query rows are fully
masked and come out as flax's uniform average over the keys.
"""

from __future__ import annotations

import torch
from torch import nn

from vivqa_tpu_torch.models.config import TextEncoderConfig
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, EncoderLayer,
                                           LayerNorm, dropout,
                                           make_attention_mask,
                                           pool_sequence, to_dtype)
from vivqa_tpu_torch.ops.embedding import Embed


class TextEncoder(nn.Module):
    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = to_dtype(cfg.dtype)
        D = cfg.hidden_dim
        self.token_embed = Embed(cfg.vocab_size, D, self.dtype)
        self.pos_embed = Embed(cfg.max_length, D, self.dtype)
        if cfg.type_vocab_size > 1:
            self.type_embed = Embed(cfg.type_vocab_size, D, self.dtype)
        self.ln_embed = LayerNorm(D, self.dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(D, cfg.num_heads, int(D * cfg.mlp_ratio),
                         dtype=self.dtype, norm_style=cfg.norm_style,
                         activation=cfg.activation, dropout=cfg.dropout)
            for _ in range(cfg.num_layers))
        if cfg.norm_style == "pre":
            self.ln_final = LayerNorm(D, self.dtype)
        if cfg.output_dim:
            self.projection = Dense(D, cfg.output_dim, bias=False,
                                    dtype=self.dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> dict:
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        pos_ids = torch.arange(input_ids.shape[1],
                               device=input_ids.device)[None]
        x = self.token_embed(input_ids) + self.pos_embed(pos_ids)
        if cfg.type_vocab_size > 1:
            x = x + self.type_embed(torch.zeros_like(input_ids))
        x = dropout(self.ln_embed(x), cfg.dropout, rng)
        attn_mask = make_attention_mask(attention_mask, attention_mask)
        for layer in self.layers:
            x = layer(x, attn_mask, rng)
        if cfg.norm_style == "pre":
            x = self.ln_final(x)
        pooled = pool_sequence(x, attention_mask, cfg.pooling)
        if cfg.output_dim:
            pooled, x = self.projection(pooled), self.projection(x)
        return {"pooled": pooled, "tokens": x, "mask": attention_mask}
