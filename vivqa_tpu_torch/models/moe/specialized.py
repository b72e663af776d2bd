"""The six specialized VQA experts (counterpart of
vivqa_tpu/models/moe/specialized.py).

Each maps (B, L, D) -> (B, L, D): ``input_proj`` to the expert's hidden
width H, a body, ``output_proj`` back and a residual LayerNorm
(``_SpecializedBase``). The bodies:

- segmentation: 8 mask tokens through a 2-layer query decoder over the
  tokens, two kernel-3 convolutions along the token axis, the tokens'
  attention to the mask tokens, a spatial MLP;
- object detection: 32 object queries through a 3-layer decoder, then
  the tokens attend to them;
- OCR: 16 text queries through a 2-layer decoder, a diacritic MLP,
  reading-order self-attention with learned order embeddings, the
  tokens gather from them;
- scene understanding: 8 scene tokens encoded jointly with the tokens
  (2 layers over L + 8), mean and max pooling, context attention;
- spatial reasoning: (B, L, L, H/2) pairwise features, a softmax over 16
  relation types (in f32) mixing learned relation embeddings, graph
  attention over the tokens;
- counting: a per-token density, 21 count queries through a 2-layer
  decoder over the density-weighted tokens, an aggregator MLP.

All compute in bf16 with f32 params, as the JAX classes do; the learned
query slots are (1, n, H) f32 parameters broadcast over the batch and
cast to bf16. flax's ``nn.Conv`` over the token axis (kernel 3, SAME) is
a ``Conv1d`` with padding 1 here; ``from_jax.py`` maps its (3, in, out)
kernel to (out, in, 3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.layers import (CrossAttentionLayer, Dense,
                                           DropoutRNG, EncoderLayer,
                                           LayerNorm,
                                           MultiHeadDotProductAttention,
                                           dropout, gelu_tanh)
from vivqa_tpu_torch.models.moe.config import ExpertConfig

_DTYPE = torch.bfloat16


class Conv1d(nn.Conv1d):
    """flax ``nn.Conv`` with a kernel of 3 and ``SAME`` padding over the
    token axis of (B, L, C): f32 params, the product in bf16."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.to(_DTYPE).transpose(1, 2), self.weight.to(_DTYPE),
                     self.bias.to(_DTYPE), padding=1)
        return y.transpose(1, 2)


class _SpecializedBase(nn.Module):
    """input_proj -> body -> output_proj -> LN(x + .). Subclasses build
    their body's modules in ``build`` and compute it in ``body``."""

    def __init__(self, config: ExpertConfig, dim: int):
        super().__init__()
        self.config = config
        self.dropout = config.dropout
        H = config.hidden_dim
        self.input_proj = Dense(dim, H, dtype=_DTYPE)
        self.build(H)
        self.output_proj = Dense(H, dim, dtype=_DTYPE)
        self.output_norm = LayerNorm(dim, _DTYPE)

    def build(self, H: int) -> None:
        raise NotImplementedError

    def body(self, h: torch.Tensor,
             rng: Optional[DropoutRNG]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        xc = x.to(_DTYPE)
        h = self.body(self.input_proj(xc), rng)
        return self.output_norm(xc + self.output_proj(h))

    # -- shared building blocks ----------------------------------------------
    def _add_queries(self, name: str, num: int, H: int) -> None:
        setattr(self, name, nn.Parameter(torch.empty(1, num, H)))

    def _queries(self, name: str, batch: int) -> torch.Tensor:
        q = getattr(self, name)
        return q.expand(batch, -1, -1).to(_DTYPE)

    def _add_decoder(self, prefix: str, layers: int, H: int) -> None:
        """A query decoder: self-attention over the queries, attention to
        the memory and an MLP of width 2H per layer."""
        cfg = self.config
        for i in range(layers):
            setattr(self, f"{prefix}_{i}", CrossAttentionLayer(
                H, cfg.num_heads, 2 * H, dtype=_DTYPE, dropout=cfg.dropout))

    def _decoder(self, prefix: str, layers: int, queries: torch.Tensor,
                 memory: torch.Tensor,
                 rng: Optional[DropoutRNG]) -> torch.Tensor:
        for i in range(layers):
            queries = getattr(self, f"{prefix}_{i}")(queries, memory,
                                                     rng=rng)
        return queries

    def _add_cross(self, name: str, H: int) -> None:
        setattr(self, name, MultiHeadDotProductAttention(
            H, self.config.num_heads, dtype=_DTYPE,
            dropout_rate=self.config.dropout))

    def _add_mlp(self, name: str, in_dim: int, out_dim: int, H: int) -> None:
        setattr(self, f"{name}_fc1", Dense(in_dim, H, dtype=_DTYPE))
        setattr(self, f"{name}_fc2", Dense(H, out_dim, dtype=_DTYPE))

    def _mlp(self, name: str, h: torch.Tensor,
             rng: Optional[DropoutRNG]) -> torch.Tensor:
        y = gelu_tanh(getattr(self, f"{name}_fc1")(h))
        y = dropout(y, self.dropout, rng)
        return getattr(self, f"{name}_fc2")(y)


class SegmentationExpert(_SpecializedBase):
    num_mask_tokens = 8

    def build(self, H: int) -> None:
        self._add_queries("mask_tokens", self.num_mask_tokens, H)
        self._add_decoder("mask_dec", 2, H)
        self.boundary_conv1 = Conv1d(H)
        self.boundary_conv2 = Conv1d(H)
        self._add_cross("mask_ctx_attn", H)
        self._add_mlp("spatial", 2 * H, H, H)

    def body(self, h, rng):
        masks = self._decoder("mask_dec", 2,
                              self._queries("mask_tokens", h.shape[0]), h,
                              rng)
        b = gelu_tanh(self.boundary_conv1(h))
        b = gelu_tanh(self.boundary_conv2(b))
        mask_ctx = self.mask_ctx_attn(h, masks, rng=rng)
        return h + self._mlp("spatial", torch.cat([b, mask_ctx], dim=-1),
                             rng)


class ObjectDetectionExpert(_SpecializedBase):
    num_queries = 32
    num_decoder_layers = 3

    def build(self, H: int) -> None:
        self._add_queries("object_queries", self.num_queries, H)
        self._add_decoder("obj_dec", self.num_decoder_layers, H)
        self.obj_agg = Dense(H, H, dtype=_DTYPE)
        self._add_cross("query_feature_attn", H)

    def body(self, h, rng):
        objects = self._decoder(
            "obj_dec", self.num_decoder_layers,
            self._queries("object_queries", h.shape[0]), h, rng)
        objects = dropout(gelu_tanh(self.obj_agg(objects)), self.dropout,
                          rng)
        return h + self.query_feature_attn(h, objects, rng=rng)


class OCRExpert(_SpecializedBase):
    num_text_queries = 16

    def build(self, H: int) -> None:
        self._add_queries("text_queries", self.num_text_queries, H)
        self._add_decoder("text_dec", 2, H)
        self._add_mlp("diacritic", H, H, H)
        self.order_embed = nn.Parameter(
            torch.empty(1, self.num_text_queries, H))
        self._add_cross("reading_order_attn", H)
        self._add_cross("text_gather_attn", H)
        self._add_mlp("aggregator", H, H, H)

    def body(self, h, rng):
        text = self._decoder("text_dec", 2,
                             self._queries("text_queries", h.shape[0]), h,
                             rng)
        text = text + self._mlp("diacritic", text, rng)
        ordered = text + self.order_embed.to(_DTYPE)
        ordered = self.reading_order_attn(ordered, ordered, rng=rng)
        h_text = self.text_gather_attn(h, ordered, rng=rng)
        return h + self._mlp("aggregator", h_text, rng)


class SceneUnderstandingExpert(_SpecializedBase):
    num_scene_tokens = 8
    num_encoder_layers = 2

    def build(self, H: int) -> None:
        cfg = self.config
        self._add_queries("scene_tokens", self.num_scene_tokens, H)
        for i in range(self.num_encoder_layers):
            setattr(self, f"scene_enc_{i}", EncoderLayer(
                H, cfg.num_heads, 2 * H, dtype=_DTYPE, dropout=cfg.dropout))
        self.global_proj = Dense(2 * H, H, dtype=_DTYPE)
        self.ln_ctx = LayerNorm(H, _DTYPE)
        self._add_cross("context_attn", H)

    def body(self, h, rng):
        n = self.num_scene_tokens
        combined = torch.cat([self._queries("scene_tokens", h.shape[0]), h],
                             dim=1)
        for i in range(self.num_encoder_layers):
            combined = getattr(self, f"scene_enc_{i}")(combined, rng=rng)
        scene_out, h_enc = combined[:, :n], combined[:, n:]
        g = torch.cat([scene_out.mean(dim=1), scene_out.amax(dim=1)],
                      dim=-1)
        g = self.global_proj(g)[:, None]
        ctx = self.context_attn(self.ln_ctx(h_enc),
                                torch.cat([scene_out, g], dim=1), rng=rng)
        return h_enc + ctx


class SpatialReasoningExpert(_SpecializedBase):
    num_relations = 16

    def build(self, H: int) -> None:
        Hp = max(H // 2, 8)
        self.pair_src = Dense(H, Hp, dtype=_DTYPE)
        self.pair_dst = Dense(H, Hp, dtype=_DTYPE)
        self.pair_mlp = Dense(Hp, Hp, dtype=_DTYPE)
        self.relation_predictor = Dense(Hp, self.num_relations,
                                        dtype=_DTYPE)
        self.relation_embeddings = nn.Parameter(
            torch.empty(self.num_relations, Hp))
        self.ln_g = LayerNorm(H, _DTYPE)
        self._add_cross("graph_attn", H)
        self._add_mlp("spatial_agg", H + Hp, H, H)

    def body(self, h, rng):
        # the pairwise features of the concat [h_i, h_j] @ W, as
        # h_i @ W_left + h_j @ W_right: (B, L, L, H/2)
        pair = gelu_tanh(self.pair_src(h)[:, :, None, :]
                         + self.pair_dst(h)[:, None, :, :])
        pair = self.pair_mlp(pair)
        rel = torch.softmax(self.relation_predictor(pair).float(),
                            dim=-1).to(_DTYPE)
        rel_feat = torch.einsum("blmr,rh->blmh", rel,
                                self.relation_embeddings.to(_DTYPE))
        spatial_ctx = (pair + rel_feat).mean(dim=2)          # (B, L, H/2)
        h = h + self.graph_attn(self.ln_g(h), h, rng=rng)
        return self._mlp("spatial_agg", torch.cat([h, spatial_ctx], dim=-1),
                         rng)


class CountingExpert(_SpecializedBase):
    max_count = 20

    def build(self, H: int) -> None:
        self.density_fc1 = Dense(H, H // 2, dtype=_DTYPE)
        self.density_fc2 = Dense(H // 2, 1, dtype=_DTYPE)
        self._add_queries("count_queries", self.max_count + 1, H)
        self._add_decoder("count_dec", 2, H)
        self._add_mlp("aggregator", H, H, H)

    def body(self, h, rng):
        density = torch.sigmoid(self.density_fc2(gelu_tanh(
            self.density_fc1(h))))                             # (B, L, 1)
        h_weighted = h * density
        counts = self._decoder("count_dec", 2,
                               self._queries("count_queries", h.shape[0]),
                               h_weighted, rng)
        count_agg = counts.mean(dim=1, keepdim=True)
        return h + self._mlp("aggregator", h_weighted + count_agg, rng)


SPECIALIZED_EXPERTS = {
    "segmentation": SegmentationExpert,
    "object_detection": ObjectDetectionExpert,
    "ocr": OCRExpert,
    "scene_understanding": SceneUnderstandingExpert,
    "spatial_reasoning": SpatialReasoningExpert,
    "counting": CountingExpert,
}

