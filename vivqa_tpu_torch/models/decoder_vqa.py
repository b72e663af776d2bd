"""Decoder-only generative VQA: the image's patch tokens, through a
projector, start one causal sequence with the question and the answer,
in a language model of DeepSeek-V3's layout (Kimi-VL-A3B's).

Each sample's sequence is its projected patch tokens, the question's
real tokens, BOS and the answer's tokens, then padding up to
``config.max_positions`` (image tokens + ``max_question_length`` +
``max_answer_length``). Position ids count the real tokens from 0, and
attention is causal: padding only follows real tokens, so no real query
sees it. Questions and answers are right-padded (their masks are a
prefix of ones), as the tokenizer and the collate functions give them.

A layer is h = x + MLA(RMSNorm(x)), then h + FFN(RMSNorm(h)): FFN is the
dense SwiGLU in the first ``first_k_dense_replace`` layers and
``moe/routed.py:RoutedMoE`` after them, which routes no padded position.
A final RMSNorm and the untied f32 vocabulary head follow.

The forward takes ``GenerativeVQAModel.forward``'s arguments, so
``train/state.py:generative_loss_fn`` trains it unchanged; its ``rows``
(indices into the flattened (B x answer length) positions) are mapped
to sequence positions on the device. Generation (``models/decoding.py``)
runs through ``encode``, ``init_cache`` and ``decode_step``: the cache
holds the embedded prefix and the tokens so far, and each step computes
the whole sequence again (no latent KV cache).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import DecoderVQAConfig
from vivqa_tpu_torch.models.encoders import create_visual_encoder
from vivqa_tpu_torch.models.layers import (Dense, LayerNorm, RMSNorm,
                                           init_weights, rotary_table,
                                           to_dtype)
from vivqa_tpu_torch.models.mla import MultiHeadLatentAttention
from vivqa_tpu_torch.models.moe.routed import RoutedMoE, SwiGLU
from vivqa_tpu_torch.ops.embedding import Embed
from vivqa_tpu_torch.utils.profiling import count, span


class Projector(nn.Module):
    """The image tokens into the language model's width: LayerNorm,
    linear, exact GELU, linear (Kimi-VL's projector, without its 2 x 2
    pixel shuffle)."""

    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype,
                 eps: float):
        super().__init__()
        self.ln_in = LayerNorm(dim, dtype, eps)
        self.fc1 = Dense(dim, dim, dtype=dtype)
        self.fc2 = Dense(dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.ln_in(x))))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderVQAConfig, dense: bool):
        super().__init__()
        dtype, D = to_dtype(cfg.dtype), cfg.hidden_size
        self.ln_attn = RMSNorm(D, dtype, cfg.rms_norm_eps)
        self.attn = MultiHeadLatentAttention(
            D, cfg.num_attention_heads, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
            dtype, cfg.rms_norm_eps)
        self.ln_mlp = RMSNorm(D, dtype, cfg.rms_norm_eps)
        if dense:
            self.mlp = SwiGLU(D, cfg.intermediate_size, dtype)
        else:
            self.moe = RoutedMoE(
                D, cfg.moe_intermediate_size, cfg.n_routed_experts,
                tuple(cfg.experts_held), cfg.num_experts_per_tok,
                cfg.n_shared_experts, cfg.routed_scaling_factor,
                cfg.norm_topk_prob, dtype, cfg.bias_fit_samples,
                cfg.bias_update_iterations)

    def forward(self, x: torch.Tensor, angles: torch.Tensor,
                real: torch.Tensor) -> torch.Tensor:
        with span("mla"):
            x = x + self.attn(self.ln_attn(x), angles)
        if hasattr(self, "mlp"):
            with span("mlp"):
                return x + self.mlp(self.ln_mlp(x))
        with span("moe"):
            return x + self.moe(self.ln_mlp(x), real)


@dataclasses.dataclass
class PrefixCache:
    """Generation's state: the embedded prefix (B, P, D) with each row's
    real length, and the tokens fed so far (B, max_length), BOS first;
    ``index`` is the next step's position among them."""
    prefix: torch.Tensor
    prefix_len: torch.Tensor
    tokens: torch.Tensor
    index: int = 0

    @property
    def max_length(self) -> int:
        return self.tokens.shape[1]

    @property
    def device(self) -> torch.device:
        return self.prefix.device

    def select_rows(self, rows: torch.Tensor) -> "PrefixCache":
        return dataclasses.replace(
            self, prefix=self.prefix.index_select(0, rows),
            prefix_len=self.prefix_len.index_select(0, rows),
            tokens=self.tokens.index_select(0, rows))


def _lengths(mask: Optional[torch.Tensor], ids: torch.Tensor
             ) -> torch.Tensor:
    if mask is None:
        return torch.full(ids.shape[:1], ids.shape[1], dtype=torch.int64,
                          device=ids.device)
    return mask.sum(1).to(torch.int64)


class DecoderVQAModel(nn.Module):
    def __init__(self, config: DecoderVQAConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = to_dtype(cfg.dtype)
        D = cfg.hidden_size
        self.visual_encoder = create_visual_encoder(cfg.visual)
        self.projector = Projector(cfg.visual.hidden_dim, D, self.dtype,
                                   cfg.projector_ln_eps)
        self.token_embed = Embed(cfg.vocab_size, D, self.dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i < cfg.first_k_dense_replace)
            for i in range(cfg.num_hidden_layers))
        self.ln_final = RMSNorm(D, self.dtype, cfg.rms_norm_eps)
        self.lm_head = Dense(D, cfg.vocab_size, bias=False,
                             dtype=torch.float32)
        self.register_buffer("rope_angles", rotary_table(
            cfg.max_positions, cfg.qk_rope_head_dim, cfg.rope_theta),
            persistent=False)

    def encode(self, pixel_values: torch.Tensor, question_ids: torch.Tensor,
               question_mask: Optional[torch.Tensor] = None,
               expert_mask: Optional[torch.Tensor] = None, rng=None, *,
               knowledge_embeddings: Optional[torch.Tensor] = None,
               knowledge_mask: Optional[torch.Tensor] = None) -> dict:
        """The embedded prefix: the projected image tokens, then the
        question's embeddings (B, Lv + Lq, D) as ``memory``, and its
        mask (B, Lv + Lq) as ``memory_mask``."""
        if expert_mask is not None or knowledge_embeddings is not None:
            raise NotImplementedError("the decoder-only model takes no "
                                      "expert mask and no knowledge")
        with span("vision"):
            image = self.visual_encoder(pixel_values, rng)["tokens"]
        with span("projector"):
            image = self.projector(image)
        prefix = torch.cat([image, self.token_embed(question_ids)], dim=1)
        ones = torch.ones(image.shape[:2], dtype=torch.int64,
                          device=image.device)
        qmask = ones[:, :1].expand_as(question_ids) if question_mask is None \
            else question_mask.to(torch.int64)
        return {"memory": prefix, "memory_mask": torch.cat([ones, qmask], 1)}

    def _layers(self, prefix: torch.Tensor, prefix_len: torch.Tensor,
                answer: torch.Tensor, answer_len: torch.Tensor):
        """The language model over [prefix's real rows; answer's real
        rows; padding] -> (hidden (B, S, D), S)."""
        B, P, D = prefix.shape
        S = P + answer.shape[1]
        pos = torch.arange(S, device=prefix.device)[None]
        src = torch.where(pos < prefix_len[:, None], pos,
                          pos + (P - prefix_len[:, None])).clamp(max=S - 1)
        x = torch.cat([prefix, answer], dim=1).gather(
            1, src[..., None].expand(B, S, D))
        real = pos < (prefix_len + answer_len)[:, None]
        angles = self.rope_angles[:S]
        with span("lm"):
            for layer in self.layers:
                x = layer(x, angles, real)
        return x, S

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        count("decoder.positions", x.shape[:-1].numel())
        with span("head"):
            return self.lm_head(self.ln_final(x).float())

    def forward(self, pixel_values: torch.Tensor, question_ids: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                question_mask: Optional[torch.Tensor] = None,
                decoder_mask: Optional[torch.Tensor] = None,
                expert_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                knowledge_embeddings: Optional[torch.Tensor] = None,
                knowledge_mask: Optional[torch.Tensor] = None,
                rows: Optional[Callable[[], torch.Tensor]] = None) -> dict:
        """Teacher forcing: logits (B, La, vocab) f32 at the answer
        positions, or, with ``rows`` (a function returning int64 indices
        into the flattened (B x La) answer positions, as
        ``train/state.py:labelled_rows`` gives them), (n, vocab) for those
        alone. ``aux_loss`` is 0 (no balance loss), ``moe_metrics``
        empty. No dropout (the published rates are 0), so ``generator``
        is not drawn from. Under a profiler: the span ``model`` around
        ``vision``, ``projector``, ``lm`` (each layer's ``mla`` and
        ``mlp`` or ``moe``) and ``head``."""
        with span("model"):
            enc = self.encode(pixel_values, question_ids, question_mask,
                              expert_mask,
                              knowledge_embeddings=knowledge_embeddings)
            prefix_len = enc["memory_mask"].sum(1)
            x, S = self._layers(enc["memory"], prefix_len,
                                self.token_embed(decoder_input_ids),
                                _lengths(decoder_mask, decoder_input_ids))
            B, La = decoder_input_ids.shape
            t = torch.arange(La, device=x.device)
            at = (torch.arange(B, device=x.device)[:, None] * S
                  + prefix_len[:, None] + t).flatten()
            if rows is not None:
                at = at.index_select(0, rows())
            logits = self._head(x.flatten(0, 1).index_select(0, at))
        if rows is None:
            logits = logits.view(B, La, -1)
        return {"logits": logits,
                "aux_loss": torch.zeros((), dtype=torch.float32,
                                        device=logits.device),
                "moe_metrics": {}}

    def init_cache(self, memory: torch.Tensor,
                   memory_mask: Optional[torch.Tensor],
                   max_length: int) -> PrefixCache:
        if max_length > self.config.max_answer_length:
            raise ValueError(f"max_length {max_length} exceeds "
                             f"max_answer_length="
                             f"{self.config.max_answer_length}")
        B = memory.shape[0]
        return PrefixCache(memory, _lengths(memory_mask, memory[..., 0]),
                           torch.full((B, max_length),
                                      self.config.bos_token_id,
                                      dtype=torch.int64,
                                      device=memory.device))

    def decode_step(self, token_ids: torch.Tensor, cache: PrefixCache):
        """One step: (B, 1) ids at position ``cache.index`` -> (logits
        (B, vocab) f32 of the next token, the cache one step on),
        computed over the whole sequence so far."""
        t = cache.index
        if t >= cache.max_length:
            raise ValueError(f"the cache holds {cache.max_length} steps")
        tokens = cache.tokens.clone()
        tokens[:, t] = token_ids[:, 0]
        B = tokens.shape[0]
        x, S = self._layers(cache.prefix, cache.prefix_len,
                            self.token_embed(tokens[:, :t + 1]),
                            torch.full((B,), t + 1, dtype=torch.int64,
                                       device=tokens.device))
        at = torch.arange(B, device=x.device) * S + cache.prefix_len + t
        logits = self._head(x.flatten(0, 1).index_select(0, at))
        return logits, dataclasses.replace(cache, tokens=tokens,
                                           index=t + 1)


def create_decoder_vqa_model(config: DecoderVQAConfig | None = None, *,
                             device: str | torch.device = "cuda",
                             generator: torch.Generator | None = None,
                             **overrides) -> DecoderVQAModel:
    """Build the model with seeded random weights on ``device`` (the card
    by default; raises without CUDA unless ``device="cpu"``), in eval
    mode. ``generator`` (a CPU ``torch.Generator``) seeds the weights."""
    dev = resolve_device(device)
    config = config or DecoderVQAConfig()
    if overrides:
        config = config.replace(**overrides)
    model = DecoderVQAModel(config)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
