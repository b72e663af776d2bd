"""Generative VQA meta-architecture (counterpart of
vivqa_tpu/models/generative.py): visual encoder + question encoder +
cross-modal fusion (concat the token streams -> transformer -> optional
MoE -> LayerNorm) + transformer decoder.

Entry points, as the JAX model's:
    forward(...)      teacher-forcing logits (+ aux loss)
    encode(...)       fused encoder memory + mask
    init_cache(...)   the decoder's KV cache over that memory
    decode_step(...)  one cached decoder step
Generation itself lives in ``models/decoding.py``. Training mode is
``model.train()`` with a ``torch.Generator`` passed to ``forward``, as in
``VietnameseVQAModel``. With ``knowledge.use_knowledge`` the K retrieved
contexts, projected to the fusion width and normalised
(``knowledge_proj``, ``knowledge_ln``), are appended to the memory as K
more tokens under the knowledge mask (fusion-in-decoder RAG), so the
decoder cross-attends over Lv + Lq + K keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import GenerativeVQAConfig
from vivqa_tpu_torch.models.decoder import DecodeCache, TransformerDecoder
from vivqa_tpu_torch.models.encoders import (create_text_encoder,
                                             create_visual_encoder)
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, EncoderLayer,
                                           LayerNorm, init_weights,
                                           make_attention_mask, to_dtype)
from vivqa_tpu_torch.models.moe.layer import create_moe_layer
from vivqa_tpu_torch.models.vqa_model import (encoder_out_dim,
                                              moe_config_from_model)
from vivqa_tpu_torch.utils.profiling import span


class CrossModalFusion(nn.Module):
    """Concat [visual; question] tokens -> N transformer layers under the
    query-AND-key padding mask -> optional MoE -> LayerNorm."""

    def __init__(self, config: GenerativeVQAConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        dtype = to_dtype(cfg.dtype)
        D = cfg.fusion_dim
        self.v_proj = Dense(encoder_out_dim(cfg.visual), D, dtype=dtype)
        self.q_proj = Dense(encoder_out_dim(cfg.text), D, dtype=dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(D, cfg.fusion_heads, 4 * D, dtype=dtype,
                         dropout=cfg.dropout)
            for _ in range(cfg.fusion_layers))
        self.use_moe = cfg.moe.use_moe and cfg.moe.moe_position in (
            "fusion", "both")
        if self.use_moe:
            self.moe = create_moe_layer(moe_config_from_model(cfg, D))
        self.ln_final = LayerNorm(D, dtype)

    def forward(self, visual_tokens: torch.Tensor,
                question_tokens: torch.Tensor,
                question_mask: Optional[torch.Tensor] = None,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        """Returns (tokens (B, Lv + Lq, D), mask (B, Lv + Lq), aux_loss,
        moe_metrics)."""
        v, q = self.v_proj(visual_tokens), self.q_proj(question_tokens)
        x = torch.cat([v, q], dim=1)
        dev = x.device
        if question_mask is None:
            question_mask = torch.ones(q.shape[:2], dtype=torch.int32,
                                       device=dev)
        mask = torch.cat([torch.ones(v.shape[:2], dtype=question_mask.dtype,
                                     device=dev), question_mask], dim=1)
        attn = make_attention_mask(mask, mask)
        for layer in self.layers:
            x = layer(x, attn, rng)
        aux_loss = torch.zeros((), dtype=torch.float32, device=dev)
        moe_metrics = {}
        if self.use_moe:
            with span("moe"):
                x, aux = self.moe(x, expert_mask, rng)
            aux_loss, moe_metrics = aux["aux_loss"], aux["metrics"]
        return self.ln_final(x), mask, aux_loss, moe_metrics


class GenerativeVQAModel(nn.Module):
    def __init__(self, config: GenerativeVQAConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.visual_encoder = create_visual_encoder(cfg.visual)
        self.question_encoder = create_text_encoder(cfg.text)
        self.fusion = CrossModalFusion(cfg)
        self.decoder = TransformerDecoder(cfg)
        if cfg.knowledge.use_knowledge:
            dtype = to_dtype(cfg.dtype)
            self.knowledge_proj = Dense(cfg.knowledge.knowledge_dim,
                                        cfg.fusion_dim, dtype=dtype)
            self.knowledge_ln = LayerNorm(cfg.fusion_dim, dtype)

    def encode(self, pixel_values: torch.Tensor, question_ids: torch.Tensor,
               question_mask: Optional[torch.Tensor] = None,
               expert_mask: Optional[torch.Tensor] = None,
               rng: Optional[DropoutRNG] = None, *,
               knowledge_embeddings: Optional[torch.Tensor] = None,
               knowledge_mask: Optional[torch.Tensor] = None) -> dict:
        """The memory (B, Lv + Lq [+ K], D) and its mask. With
        ``use_knowledge`` and ``knowledge_embeddings`` (B, K, Dk) given,
        the projected contexts follow the fused tokens, under
        ``knowledge_mask`` (B, K), or all-ones when it is None."""
        with span("vision"):
            visual = self.visual_encoder(pixel_values, rng)
        with span("text"):
            text = self.question_encoder(question_ids, question_mask, rng)
        with span("fusion"):
            memory, mask, aux_loss, moe_metrics = self.fusion(
                visual["tokens"], text["tokens"], text["mask"], expert_mask,
                rng)
        if self.config.knowledge.use_knowledge \
                and knowledge_embeddings is not None:
            k = self.knowledge_ln(self.knowledge_proj(
                knowledge_embeddings.to(memory.dtype)))
            memory = torch.cat([memory, k], dim=1)
            if knowledge_mask is None:
                knowledge_mask = torch.ones(k.shape[:2], dtype=torch.int32,
                                            device=k.device)
            mask = torch.cat([mask, knowledge_mask.to(mask.dtype)], dim=1)
        return {"memory": memory, "memory_mask": mask,
                "aux_loss": aux_loss, "moe_metrics": moe_metrics}

    def init_cache(self, memory: torch.Tensor,
                   memory_mask: Optional[torch.Tensor],
                   max_length: int) -> DecodeCache:
        return self.decoder.init_cache(memory, memory_mask, max_length)

    def decode_step(self, token_ids: torch.Tensor, cache: DecodeCache):
        """One cached decoder step: (B, 1) ids -> (logits (B, vocab),
        cache)."""
        return self.decoder.decode_step(token_ids, cache)

    def forward(self, pixel_values: torch.Tensor, question_ids: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                question_mask: Optional[torch.Tensor] = None,
                decoder_mask: Optional[torch.Tensor] = None,
                expert_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                knowledge_embeddings: Optional[torch.Tensor] = None,
                knowledge_mask: Optional[torch.Tensor] = None) -> dict:
        """Teacher forcing: logits (B, L, vocab) f32 and the aux loss of
        both MoE positions; the knowledge arrays as ``encode`` takes
        them. Under a profiler the forward is the span ``model`` around
        ``vision``, ``text``, ``fusion`` (with ``moe`` where the fusion
        runs it) and ``decoder``."""
        rng = None
        if self.training:
            if generator is None:
                raise ValueError(
                    "a training forward needs a torch.Generator for its "
                    "dropout (model.eval() for a deterministic forward)")
            rng = DropoutRNG(generator)
        with span("model"):
            enc = self.encode(pixel_values, question_ids, question_mask,
                              expert_mask, rng,
                              knowledge_embeddings=knowledge_embeddings,
                              knowledge_mask=knowledge_mask)
            with span("decoder"):
                logits, decoder_aux = self.decoder(
                    decoder_input_ids, enc["memory"], enc["memory_mask"],
                    decoder_mask, rng, return_aux=True)
        return {"logits": logits, "aux_loss": enc["aux_loss"] + decoder_aux,
                "moe_metrics": enc["moe_metrics"]}


def create_generative_vqa_model(config: GenerativeVQAConfig | None = None, *,
                                device: str | torch.device = "cuda",
                                generator: torch.Generator | None = None,
                                **overrides) -> GenerativeVQAModel:
    """Build the model with seeded random weights on ``device`` (the card
    by default; raises without CUDA unless ``device="cpu"``), in eval
    mode. ``generator`` (a CPU ``torch.Generator``) seeds the weights;
    load trained ones with ``from_jax.load_flax_params``."""
    dev = resolve_device(device)
    config = config or GenerativeVQAConfig()
    if overrides:
        config = config.replace(**overrides)
    model = GenerativeVQAModel(config)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
