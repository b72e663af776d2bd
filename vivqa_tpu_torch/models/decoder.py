"""Transformer decoder with a KV cache (counterpart of
vivqa_tpu/models/decoder.py).

Teacher forcing (``forward``): (B, L) ids, the causal mask AND the
decoder's padding mask, cross-attention to the encoder memory under its
key mask. Cached decoding (``init_cache`` then ``decode_step``): one token
a step, position t at step t, every self-attention layer reading and
writing its slice of a ``DecodeCache``.

flax keeps the cache in the mutable ``cache`` collection; here it is an
explicit object that the caller passes in and gets back. Each step writes
its K/V into the cache's buffers in place (a functional copy of the whole
cache per step would only cost memory traffic), so a cache must not be
reused after it was passed to a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.config import GenerativeVQAConfig
from vivqa_tpu_torch.models.layers import (CrossAttentionLayer, Dense,
                                           DropoutRNG, LayerNorm, dropout,
                                           make_attention_mask,
                                           make_causal_mask,
                                           sinusoidal_positions, to_dtype)
from vivqa_tpu_torch.models.moe.layer import create_moe_layer
from vivqa_tpu_torch.models.vqa_model import moe_config_from_model
from vivqa_tpu_torch.ops.embedding import Embed
from vivqa_tpu_torch.utils.profiling import count


@dataclasses.dataclass
class DecodeCache:
    """The decoder's state between cached steps.

    - ``self_kv``: (layers, 2, B, max_len, H, Dh) in the compute dtype
      (H this rank's heads on a mesh that splits them),
      K then V of every self-attention layer, zero at the start; step t
      writes position t (flax's ``cached_key``/``cached_value``);
    - ``cross_kv``: (layers, 2, B, Lm, H, Dh), the context K/V of every
      cross-attention layer, projected once from the encoder memory
      (``CachedCrossAttention``'s ``cached_ckey``/``cached_cvalue``);
    - ``cross_mask``: (B, 1, 1, Lm) bool, the memory's key mask, or None;
    - ``position_mask``: (max_len, max_len) bool, row t keeps the keys at
      positions <= t (flax's ``arange(max_len) <= cache_index``);
    - ``index``: the next step's position (flax's ``cache_index`` and the
      decoder's ``pos_index``), a host integer, so no step waits on the
      card to read it.
    """
    self_kv: torch.Tensor
    cross_kv: torch.Tensor
    cross_mask: Optional[torch.Tensor]
    position_mask: torch.Tensor
    index: int = 0

    @property
    def max_length(self) -> int:
        return self.self_kv.shape[3]


class TransformerDecoder(nn.Module):
    def __init__(self, config: GenerativeVQAConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = to_dtype(cfg.dtype)
        D = cfg.decoder_dim
        self.token_embed = Embed(cfg.vocab_size, D, self.dtype)
        # the JAX module rounds sqrt(D) to the compute dtype first
        # (22.625 in bf16 for D = 512)
        self.embed_scale = float(torch.tensor(D ** 0.5, dtype=self.dtype))
        self.register_buffer("pos_table", torch.from_numpy(
            sinusoidal_positions(cfg.max_answer_length, D)),
            persistent=False)
        self.layers = nn.ModuleList(
            CrossAttentionLayer(D, cfg.decoder_heads, cfg.decoder_ff_dim,
                                context_dim=cfg.fusion_dim, dtype=self.dtype,
                                dropout=cfg.dropout)
            for _ in range(cfg.decoder_layers))
        self.use_moe = cfg.moe.use_moe and cfg.moe.moe_position in (
            "decoder", "both")
        if self.use_moe:
            self.decoder_moe = create_moe_layer(moe_config_from_model(cfg, D))
        self.ln_final = LayerNorm(D, self.dtype)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(D, cfg.vocab_size, dtype=torch.float32)

    def _embed(self, ids: torch.Tensor, start: int) -> torch.Tensor:
        L = ids.shape[1]
        if start + L > self.config.max_answer_length:
            raise ValueError(
                f"positions {start}..{start + L - 1} exceed the position "
                f"table of max_answer_length={self.config.max_answer_length}")
        x = self.token_embed(ids) * self.embed_scale
        return x + self.pos_table[start:start + L].to(self.dtype)

    def _head(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None,
              rows: Optional[Callable[[], torch.Tensor]] = None):
        """Decoder MoE, final LayerNorm and f32 logits; (logits, aux).
        The MoE, where one runs, takes every (B, L) position, so its
        routing, aux loss and noise draws do not depend on ``rows``.
        ``rows``, called here once the MoE is queued, returns int64
        indices into the flattened (B * L) positions and keeps only those
        for the LayerNorm and the vocabulary: logits (n, vocab) in their
        order, where without it they are (B, L, vocab). Under a profiler
        the rows projected onto the vocabulary add to the counter
        ``decoder.positions``."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.use_moe:
            x, moe_aux = self.decoder_moe(x, None, rng)
            aux = moe_aux["aux_loss"]
        if rows is not None:
            x = x.flatten(0, 1).index_select(0, rows())
        count("decoder.positions", x.shape[:-1].numel())
        x = self.ln_final(x)
        if self.config.tie_embeddings:
            logits = self.token_embed.attend(x.float())
        else:
            logits = self.lm_head(x)
        return logits.float(), aux

    def forward(self, decoder_input_ids: torch.Tensor,
                encoder_hidden: torch.Tensor,
                encoder_mask: Optional[torch.Tensor] = None,
                decoder_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
                return_aux: bool = False, *,
                rows: Optional[Callable[[], torch.Tensor]] = None):
        """Teacher forcing: (B, L) ids -> logits (B, L, vocab) f32, or
        with ``rows`` (a function returning indices into the flattened
        (B * L) positions, the ones a loss counts, called once every
        layer is queued) (n, vocab) for those positions alone: every
        layer and the decoder MoE still run on all positions (``_head``).
        """
        self_mask = make_causal_mask(decoder_input_ids)
        if decoder_mask is not None:
            self_mask = self_mask & make_attention_mask(decoder_mask,
                                                        decoder_mask)
        cross_mask = make_attention_mask(None, encoder_mask)
        x = dropout(self._embed(decoder_input_ids, 0), self.config.dropout,
                    rng)
        context = encoder_hidden.to(self.dtype)
        for layer in self.layers:
            x = layer(x, context, self_mask, cross_mask, rng)
        logits, aux = self._head(x, rng, rows)
        return (logits, aux) if return_aux else logits

    def init_cache(self, encoder_hidden: torch.Tensor,
                   encoder_mask: Optional[torch.Tensor],
                   max_length: int) -> DecodeCache:
        """An empty cache for ``max_length`` steps over this memory: the
        self-attention buffers zero, the context K/V projected."""
        if max_length > self.config.max_answer_length:
            raise ValueError(
                f"max_length {max_length} exceeds the position table of "
                f"max_answer_length={self.config.max_answer_length}")
        cfg = self.config
        B, dev = encoder_hidden.shape[0], encoder_hidden.device
        # this rank's heads where a mesh's 'model' axis splits them
        H = self.layers[0].self_attn.num_heads
        context = encoder_hidden.to(self.dtype)
        self_kv = torch.zeros(
            (len(self.layers), 2, B, max_length, H,
             cfg.decoder_dim // cfg.decoder_heads),
            dtype=self.dtype, device=dev)
        cross_kv = torch.stack([torch.stack(layer.cross_attn.project_context(
            context)) for layer in self.layers])
        return DecodeCache(
            self_kv, cross_kv, make_attention_mask(None, encoder_mask),
            torch.ones(max_length, max_length, dtype=torch.bool,
                       device=dev).tril())

    def decode_step(self, token_ids: torch.Tensor, cache: DecodeCache):
        """One cached step: (B, 1) ids -> (logits (B, vocab) f32, cache),
        the returned cache one position further on."""
        t = cache.index
        if t >= cache.max_length:
            raise ValueError(f"the cache holds {cache.max_length} steps")
        x = self._embed(token_ids, t)
        position_mask = cache.position_mask[t].view(1, 1, 1, -1)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache.self_kv[i, 0], cache.self_kv[i, 1], t,
                             position_mask, cache.cross_kv[i, 0],
                             cache.cross_kv[i, 1], cache.cross_mask)
        logits, _ = self._head(x)
        return logits[:, -1], dataclasses.replace(cache, index=t + 1)
