"""Basic fusions: concat, add, bilinear and cross-attention (counterpart
of vivqa_tpu/models/fusion/basic.py).

Every fusion maps the encoders' output dicts to ``pooled`` (B, D),
``tokens`` (B, L, D) and their validity ``mask`` (B, L). As in the JAX
package each computes in bf16 whatever the model's dtype.

- concat, add, bilinear fuse the pooled vectors; their tokens are the
  two projected vectors (L = 2);
- cross-attention is bidirectional co-attention over N layers: the image
  tokens attend to the text (key mask ``v2t``), the text tokens to
  themselves (``t2t``) and to the image under the query-side mask
  ``t2v``, whose padded rows are fully masked (each becomes the mean of
  its values, flax's rule); the tokens are [image; text].
"""

from __future__ import annotations

import torch
from torch import nn

from vivqa_tpu_torch.models.config import FusionConfig
from vivqa_tpu_torch.models.layers import (CrossAttentionLayer, Dense,
                                           DropoutRNG, LayerNorm, dropout,
                                           gelu_tanh, make_attention_mask)

_DTYPE = torch.bfloat16


def _full_mask(tokens: torch.Tensor) -> torch.Tensor:
    return torch.ones(tokens.shape[:2], dtype=torch.int32,
                      device=tokens.device)


class _PooledFusion(nn.Module):
    """v_proj and q_proj of the pooled vectors; tokens [v, q]."""

    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__()
        D = config.hidden_dim
        self.dropout = config.dropout
        self.v_proj = Dense(visual_dim, D, dtype=_DTYPE)
        self.q_proj = Dense(text_dim, D, dtype=_DTYPE)
        self.ln = LayerNorm(D, _DTYPE)

    def fuse(self, v: torch.Tensor, q: torch.Tensor,
             rng: DropoutRNG | None) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, visual: dict, text: dict,
                rng: DropoutRNG | None = None) -> dict:
        v = self.v_proj(visual["pooled"])
        q = self.q_proj(text["pooled"])
        tokens = torch.stack([v, q], dim=1)
        return {"pooled": self.fuse(v, q, rng), "tokens": tokens,
                "mask": _full_mask(tokens)}


class ConcatFusion(_PooledFusion):
    """LN(dropout(gelu(out_proj([v; q]))))."""

    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__(config, visual_dim, text_dim)
        self.out_proj = Dense(2 * config.hidden_dim, config.hidden_dim,
                              dtype=_DTYPE)

    def fuse(self, v, q, rng):
        h = gelu_tanh(self.out_proj(torch.cat([v, q], dim=-1)))
        return self.ln(dropout(h, self.dropout, rng))


class AddFusion(_PooledFusion):
    """LN(gelu(v + q))."""

    def fuse(self, v, q, rng):
        return self.ln(gelu_tanh(v + q))


class BilinearFusion(_PooledFusion):
    """Low-rank bilinear pooling: LN(out_proj(dropout(tanh(v) tanh(q))))."""

    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__(config, visual_dim, text_dim)
        self.out_proj = Dense(config.hidden_dim, config.hidden_dim,
                              dtype=_DTYPE)

    def fuse(self, v, q, rng):
        h = dropout(torch.tanh(v) * torch.tanh(q), self.dropout, rng)
        return self.ln(self.out_proj(h))


class CrossAttentionFusion(nn.Module):
    def __init__(self, config: FusionConfig, visual_dim: int, text_dim: int):
        super().__init__()
        cfg = config
        D = cfg.hidden_dim
        self.v_proj = Dense(visual_dim, D, dtype=_DTYPE)
        self.q_proj = Dense(text_dim, D, dtype=_DTYPE)
        self.v_layers = nn.ModuleList(
            CrossAttentionLayer(D, cfg.num_heads, 4 * D, dtype=_DTYPE,
                                dropout=cfg.dropout)
            for _ in range(cfg.num_layers))
        self.q_layers = nn.ModuleList(
            CrossAttentionLayer(D, cfg.num_heads, 4 * D, dtype=_DTYPE,
                                dropout=cfg.dropout)
            for _ in range(cfg.num_layers))
        self.out_proj = Dense(2 * D, D, dtype=_DTYPE)
        self.ln = LayerNorm(D, _DTYPE)

    def forward(self, visual: dict, text: dict,
                rng: DropoutRNG | None = None) -> dict:
        v = self.v_proj(visual["tokens"])
        q = self.q_proj(text["tokens"])
        t_mask = text.get("mask")
        if t_mask is None:
            t_mask = _full_mask(q)
        v_mask = _full_mask(v)
        v2t = make_attention_mask(v_mask, t_mask)
        t2v = make_attention_mask(t_mask, v_mask)
        t2t = make_attention_mask(t_mask, t_mask)
        for v_layer, q_layer in zip(self.v_layers, self.q_layers):
            v_new = v_layer(v, q, cross_mask=v2t, rng=rng)
            q = q_layer(q, v, self_mask=t2t, cross_mask=t2v, rng=rng)
            v = v_new
        m = t_mask[..., None].to(q.dtype)
        q_pooled = (q * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-6)
        pooled = self.ln(self.out_proj(torch.cat([v.mean(dim=1), q_pooled],
                                                 dim=-1)))
        return {"pooled": pooled, "tokens": torch.cat([v, q], dim=1),
                "mask": torch.cat([v_mask, t_mask.to(torch.int32)], dim=1)}
