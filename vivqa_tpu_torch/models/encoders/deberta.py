"""DeBERTa(-v2/v3) text encoder with disentangled attention (counterpart
of vivqa_tpu/models/encoders/deberta.py).

- no absolute position embedding: positions enter only through the
  relative-position table ``rel_embeddings`` (2 * span, D), cast to the
  compute dtype and LayerNormed (``ln_rel``) once per forward, and shared
  by the layers;
- each layer's attention is content-to-content plus content-to-position
  (the queries against the table projected by the layer's own
  ``key_proj``, biases included) plus position-to-content (the keys
  against the table projected by ``query_proj``), gathered over the last
  axis at ``clip(+-rel + span, 0, 2 span - 1)`` of the log-bucketed
  relative positions, each term scaled by 1/sqrt(dh (1 + |pos_att_type|));
- padded pairs are filled with -1e9 (a fully padded row gets a uniform
  softmax), dropout falls on the probabilities, LayerNorm eps is 1e-7.

The attention does not go through ``flash_attention``: its c2p and p2c
terms depend on the content, which the kernels' boolean masks cannot
carry. It is computed as the JAX module computes it: f32 score products,
an f32 softmax cast to the compute dtype, then the product with v.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, LayerNorm,
                                           dropout, make_attention_mask,
                                           pool_sequence, to_activation,
                                           to_dtype)
from vivqa_tpu_torch.ops.embedding import Embed


@dataclasses.dataclass(frozen=True)
class DeBERTaConfig(ConfigBase):
    vocab_size: int = 128100        # deberta-v3 sentencepiece vocab
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    max_length: int = 64
    position_buckets: int = 256
    max_relative_positions: int = 512
    pos_att_type: tuple = ("p2c", "c2p")
    norm_rel_ebd: bool = True       # LayerNorm the rel-embedding table
    pooling: str = "cls"
    dropout: float = 0.1
    activation: str = "gelu"
    ln_eps: float = 1e-7            # DebertaV2 default layer_norm_eps
    output_dim: int = 0
    dtype: str = "bfloat16"


def make_log_bucket_position(relative_pos: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    """HF DebertaV2 log-bucketing: positions within +-bucket_size/2 stay
    linear; farther ones are log-compressed."""
    sign = np.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = np.where((relative_pos < mid) & (relative_pos > -mid),
                       mid - 1, np.abs(relative_pos))
    log_pos = (np.ceil(np.log(abs_pos / mid)
                       / np.log((max_position - 1) / mid) * (mid - 1)) + mid)
    return np.where(abs_pos <= mid, relative_pos,
                    (log_pos * sign)).astype(np.int64)


def build_relative_position(query_size: int, key_size: int,
                            bucket_size: int = -1,
                            max_position: int = -1) -> np.ndarray:
    """(Lq, Lk) int relative positions q_i - k_j, optionally bucketed."""
    rel = np.arange(query_size)[:, None] - np.arange(key_size)[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel.astype(np.int64)


def _span(cfg: DeBERTaConfig) -> int:
    return (cfg.position_buckets if cfg.position_buckets > 0
            else cfg.max_relative_positions)


class DisentangledSelfAttention(nn.Module):
    """c2c + c2p + p2c attention over the shared rel embeddings."""

    def __init__(self, config: DeBERTaConfig):
        super().__init__()
        cfg = config
        D = cfg.hidden_dim
        dtype = to_dtype(cfg.dtype)
        self.config = cfg
        self.query_proj = Dense(D, D, dtype=dtype)
        self.key_proj = Dense(D, D, dtype=dtype)
        self.value_proj = Dense(D, D, dtype=dtype)
        self.out_proj = Dense(D, D, dtype=dtype)
        self._positions = {}            # (L, device) -> (c2p, p2c) index

    def _gather_index(self, L: int, device) -> tuple:
        key = (L, str(device))
        if key not in self._positions:
            cfg, span = self.config, _span(self.config)
            rel = build_relative_position(L, L, cfg.position_buckets,
                                          cfg.max_relative_positions)
            self._positions[key] = tuple(
                torch.from_numpy(np.clip(r + span, 0, 2 * span - 1)).to(
                    device) for r in (rel, -rel))
        return self._positions[key]

    def forward(self, x: torch.Tensor, rel_embeddings: torch.Tensor,
                attn_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        cfg = self.config
        B, L, D = x.shape
        H = cfg.num_heads
        dh = D // H
        scale = 1.0 / math.sqrt(dh * (1 + len(cfg.pos_att_type)))

        def heads(t):                       # (B, L, D) -> (B, H, L, dh)
            return t.view(t.shape[0], t.shape[1], H, dh).transpose(1, 2)

        q = heads(self.query_proj(x))
        k = heads(self.key_proj(x))
        v = heads(self.value_proj(x))
        score = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        c2p_pos, p2c_pos = self._gather_index(L, x.device)
        idx = (B, H, L, L)
        if "c2p" in cfg.pos_att_type:
            pos_key = heads(self.key_proj(rel_embeddings[None]))[0]
            c2p = torch.matmul(q.float(), pos_key.float().transpose(-1, -2))
            score = score + torch.gather(c2p, -1, c2p_pos.expand(idx)) * scale
        if "p2c" in cfg.pos_att_type:
            pos_query = heads(self.query_proj(rel_embeddings[None]))[0]
            p2c = torch.matmul(k.float(), pos_query.float().transpose(-1, -2))
            p2c = torch.gather(p2c, -1, p2c_pos.expand(idx))
            score = score + p2c.transpose(-1, -2) * scale
        if attn_mask is not None:
            score = torch.where(attn_mask, score, -1e9)
        probs = dropout(torch.softmax(score, dim=-1).to(v.dtype), cfg.dropout,
                        rng)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(ctx)


class DeBERTaLayer(nn.Module):
    def __init__(self, config: DeBERTaConfig):
        super().__init__()
        cfg = config
        D, dtype = cfg.hidden_dim, to_dtype(cfg.dtype)
        self.config = cfg
        self.activation = to_activation(cfg.activation)
        self.self_attn = DisentangledSelfAttention(cfg)
        self.ln1 = LayerNorm(D, dtype, eps=cfg.ln_eps)
        self.wi = Dense(D, int(D * cfg.mlp_ratio), dtype=dtype)
        self.wo = Dense(int(D * cfg.mlp_ratio), D, dtype=dtype)
        self.ln2 = LayerNorm(D, dtype, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor, rel_embeddings: torch.Tensor,
                attn_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        rate = self.config.dropout
        y = self.self_attn(x, rel_embeddings, attn_mask, rng)
        x = self.ln1(x + dropout(y, rate, rng))
        h = self.wo(self.activation(self.wi(x)))
        return self.ln2(x + dropout(h, rate, rng))


class DeBERTaEncoder(nn.Module):
    """The same contract as ``TextEncoder``: {"pooled", "tokens",
    "mask"}."""

    def __init__(self, config: DeBERTaConfig):
        super().__init__()
        cfg = config
        D = cfg.hidden_dim
        self.config = cfg
        self.dtype = dtype = to_dtype(cfg.dtype)
        self.token_embed = Embed(cfg.vocab_size, D, dtype)
        self.ln_embed = LayerNorm(D, dtype, eps=cfg.ln_eps)
        self.rel_embeddings = nn.Parameter(torch.empty(2 * _span(cfg), D))
        if cfg.norm_rel_ebd:
            self.ln_rel = LayerNorm(D, dtype, eps=cfg.ln_eps)
        self.layers = nn.ModuleList(DeBERTaLayer(cfg)
                                    for _ in range(cfg.num_layers))
        if cfg.output_dim:
            self.projection = Dense(D, cfg.output_dim, bias=False,
                                    dtype=dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                rng: DropoutRNG | None = None) -> dict:
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = dropout(self.ln_embed(self.token_embed(input_ids)), cfg.dropout,
                    rng)
        rel = self.rel_embeddings.to(self.dtype)
        if cfg.norm_rel_ebd:
            rel = self.ln_rel(rel)
        attn_mask = make_attention_mask(attention_mask, attention_mask)
        for layer in self.layers:
            x = layer(x, rel, attn_mask, rng)
        pooled = pool_sequence(x, attention_mask, cfg.pooling)
        if cfg.output_dim:
            pooled, x = self.projection(pooled), self.projection(x)
        return {"pooled": pooled, "tokens": x, "mask": attention_mask}
