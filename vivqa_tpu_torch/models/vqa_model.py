"""Classification VQA meta-architecture (counterpart of
vivqa_tpu/models/vqa_model.py): visual encoder + text encoder + fusion +
optional MoE + optional knowledge (RAG) attention + answer head.

MoE runs over the fused token sequence; the pooled vector then gains the
masked mean of the MoE output tokens. With ``knowledge.use_knowledge``
and ``knowledge_embeddings`` given, the pooled vector attends over the K
retrieved contexts (``KnowledgeAttention``, one query over K keys under
the knowledge mask) and adds the result with a fixed weight. Training
mode is ``model.train()`` with a ``torch.Generator`` on the model's
device passed to each forward: it is the only source of the dropout
randomness (flax's ``deterministic=False`` with an explicit ``dropout``
rng).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import VisualEncoderConfig, VQAModelConfig
from vivqa_tpu_torch.models.encoders import (create_text_encoder,
                                             create_visual_encoder,
                                             visual_out_dim)
from vivqa_tpu_torch.models.fusion import create_fusion
from vivqa_tpu_torch.models.heads import AnswerHead
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG,
                                           MultiHeadDotProductAttention,
                                           init_weights, make_attention_mask,
                                           to_dtype)
from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                               RouterConfig, VQAMoEConfig)
from vivqa_tpu_torch.models.moe.layer import create_moe_layer
from vivqa_tpu_torch.utils.profiling import span


# the VQA-MoE's specialized experts, in the fixed order the ablation's
# expert masks index (vivqa_tpu/models/vqa_model.py:48-50)
SPECIALIZED_ORDER = ("object_detection", "counting", "scene_understanding",
                     "ocr", "segmentation", "spatial_reasoning")


def moe_config_from_model(cfg, input_dim: int) -> MoEConfig | VQAMoEConfig:
    """Translate the meta-arch MoE knobs (``cfg.moe``, of a
    ``VQAModelConfig`` or a ``GenerativeVQAConfig``) into a full MoE
    config."""
    m = cfg.moe
    router = RouterConfig(router_type=m.router_type, top_k=m.top_k,
                          capacity_factor=m.capacity_factor,
                          load_balance_weight=m.load_balance_weight,
                          z_loss_weight=m.router_z_weight)
    if m.moe_type == "vqa":
        return VQAMoEConfig(
            input_dim=input_dim,
            num_vision_experts=m.num_vision_experts,
            num_text_experts=m.num_text_experts,
            num_multimodal_experts=m.num_multimodal_experts,
            specialized_types=SPECIALIZED_ORDER[:m.num_specialized_experts],
            expert_hidden_dim=m.expert_hidden_dim,
            # the generic default "topk" becomes the VQA-MoE's noisy
            # default; any other router (the ablation's swaps) stays
            router=(router.replace(router_type="noisy_topk")
                    if m.router_type == "topk" else router))
    return MoEConfig(num_experts=m.num_experts, input_dim=input_dim,
                     expert=ExpertConfig(hidden_dim=m.expert_hidden_dim),
                     router=router, moe_type=m.moe_type)


def encoder_out_dim(enc_cfg) -> int:
    """The width of an encoder's output: ``visual_out_dim`` for a visual
    config (ResNet's and Swin's last stage, not ``hidden_dim``), the
    projection's or ``hidden_dim`` for a text config."""
    if isinstance(enc_cfg, VisualEncoderConfig):
        return visual_out_dim(enc_cfg)
    return enc_cfg.output_dim or enc_cfg.hidden_dim


# KnowledgeAttention computes in bf16 whatever the model's dtype, as the
# JAX module does (``dtype = jnp.bfloat16``)
_KNOWLEDGE_DTYPE = torch.bfloat16


class KnowledgeAttention(nn.Module):
    """Batched RAG fusion (vivqa_tpu/models/vqa_model.py:62-85): the fused
    vector attends over the retrieved knowledge embeddings (``k_proj``,
    then flax MHDPA ``context_attn`` with the fused vector as its one
    query); residual add with a fixed weight (reference: fused +
    0.5 * knowledge per sample, vqa_model.py:689-702)."""

    def __init__(self, knowledge_dim: int, hidden_dim: int,
                 residual_weight: float = 0.5, num_heads: int = 8):
        super().__init__()
        self.residual_weight = residual_weight
        self.k_proj = Dense(knowledge_dim, hidden_dim,
                            dtype=_KNOWLEDGE_DTYPE)
        self.context_attn = MultiHeadDotProductAttention(
            hidden_dim, num_heads, dtype=_KNOWLEDGE_DTYPE)

    def forward(self, fused: torch.Tensor, knowledge: torch.Tensor,
                knowledge_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """fused (B, D); knowledge (B, K, Dk); knowledge_mask (B, K) ->
        (B, D)."""
        k = self.k_proj(knowledge)
        mask = None
        if knowledge_mask is not None:
            mask = make_attention_mask(
                torch.ones((fused.shape[0], 1), dtype=torch.int32,
                           device=fused.device), knowledge_mask)
        ctx = self.context_attn(fused[:, None, :], k, mask, rng)[:, 0]
        return fused + self.residual_weight * ctx


class VietnameseVQAModel(nn.Module):
    def __init__(self, config: VQAModelConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.visual_encoder = create_visual_encoder(cfg.visual)
        self.text_encoder = create_text_encoder(cfg.text)
        self.fusion = create_fusion(cfg.fusion, encoder_out_dim(cfg.visual),
                                    encoder_out_dim(cfg.text))
        if cfg.moe.use_moe:
            self.moe = create_moe_layer(
                moe_config_from_model(cfg, cfg.fusion.hidden_dim))
        if cfg.knowledge.use_knowledge:
            self.knowledge_attn = KnowledgeAttention(
                cfg.knowledge.knowledge_dim, cfg.fusion.hidden_dim,
                cfg.knowledge.residual_weight)
        self.answer_head = AnswerHead(cfg.head, cfg.num_answers,
                                      cfg.fusion.hidden_dim)

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                expert_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                knowledge_embeddings: Optional[torch.Tensor] = None,
                knowledge_mask: Optional[torch.Tensor] = None) -> dict:
        """``knowledge_embeddings`` (B, K, knowledge_dim) and
        ``knowledge_mask`` (B, K) come from a ``KnowledgeProvider``; they
        are read only when the config's ``use_knowledge`` is set (the JAX
        model's rule: without embeddings the branch is skipped). Under a
        profiler the forward is the span ``model`` around ``vision``,
        ``text``, ``fusion``, ``moe`` and ``head``."""
        rng = None
        if self.training:
            if generator is None:
                raise ValueError(
                    "a training forward needs a torch.Generator for its "
                    "dropout (model.eval() for a deterministic forward)")
            rng = DropoutRNG(generator)
        with span("model"):
            with span("vision"):
                visual = self.visual_encoder(pixel_values, rng)
            with span("text"):
                text = self.text_encoder(input_ids, attention_mask, rng)
            with span("fusion"):
                fused = self.fusion(visual, text, rng)
            pooled, tokens, mask = (fused["pooled"], fused["tokens"],
                                    fused["mask"])

            aux_loss = torch.zeros((), dtype=torch.float32,
                                   device=pooled.device)
            moe_metrics = {}
            if self.config.moe.use_moe:
                with span("moe"):
                    tokens, aux = self.moe(tokens, expert_mask, rng)
                    aux_loss = aux_loss + aux["aux_loss"]
                    moe_metrics = aux["metrics"]
                    m = mask[..., None].to(tokens.dtype)
                    pooled = pooled + (tokens * m).sum(dim=1) / torch.clamp(
                        m.sum(dim=1), min=1e-6)

            with span("head"):
                if self.config.knowledge.use_knowledge \
                        and knowledge_embeddings is not None:
                    pooled = self.knowledge_attn(
                        pooled, knowledge_embeddings.to(
                            to_dtype(self.config.dtype)),
                        knowledge_mask, rng)
                logits = self.answer_head(pooled, rng)
        return {"logits": logits, "features": pooled,
                "aux_loss": aux_loss, "moe_metrics": moe_metrics}


def create_vqa_model(config: VQAModelConfig | None = None, *,
                     device: str | torch.device = "cuda",
                     generator: torch.Generator | None = None,
                     **overrides) -> VietnameseVQAModel:
    """Build the model with seeded random weights on ``device`` (the card
    by default; raises without CUDA unless ``device="cpu"``), in eval
    mode. ``generator`` (a CPU ``torch.Generator``) seeds the weights;
    load trained ones with ``from_jax.load_flax_params``."""
    dev = resolve_device(device)
    config = config or VQAModelConfig()
    if overrides:
        config = config.replace(**overrides)
    model = VietnameseVQAModel(config)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
