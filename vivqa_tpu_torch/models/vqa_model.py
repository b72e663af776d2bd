"""Classification VQA meta-architecture (counterpart of
vivqa_tpu/models/vqa_model.py): visual encoder + text encoder + fusion +
optional MoE + answer head.

MoE runs over the fused token sequence; the pooled vector then gains the
masked mean of the MoE output tokens. ``KnowledgeAttention`` (RAG) is not
ported yet (ROADMAP.md Queue A item 7).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import VQAModelConfig
from vivqa_tpu_torch.models.encoders import (create_text_encoder,
                                             create_visual_encoder)
from vivqa_tpu_torch.models.fusion import create_fusion
from vivqa_tpu_torch.models.heads import AnswerHead
from vivqa_tpu_torch.models.layers import init_weights
from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                               RouterConfig)
from vivqa_tpu_torch.models.moe.layer import create_moe_layer


def moe_config_from_model(cfg: VQAModelConfig, input_dim: int) -> MoEConfig:
    """Translate the meta-arch MoE knobs into a full MoE config."""
    m = cfg.moe
    if m.moe_type == "vqa":
        raise NotImplementedError(
            "moe_type 'vqa' is not ported yet (ROADMAP.md Queue A item 13)")
    router = RouterConfig(router_type=m.router_type, top_k=m.top_k,
                          capacity_factor=m.capacity_factor,
                          load_balance_weight=m.load_balance_weight,
                          z_loss_weight=m.router_z_weight)
    return MoEConfig(num_experts=m.num_experts, input_dim=input_dim,
                     expert=ExpertConfig(hidden_dim=m.expert_hidden_dim),
                     router=router, moe_type=m.moe_type)


def _out_dim(enc_cfg) -> int:
    return enc_cfg.output_dim or enc_cfg.hidden_dim


class VietnameseVQAModel(nn.Module):
    def __init__(self, config: VQAModelConfig):
        super().__init__()
        cfg = config
        if cfg.knowledge.use_knowledge:
            raise NotImplementedError(
                "KnowledgeAttention is not ported yet "
                "(ROADMAP.md Queue A item 7)")
        self.config = cfg
        self.visual_encoder = create_visual_encoder(cfg.visual)
        self.text_encoder = create_text_encoder(cfg.text)
        self.fusion = create_fusion(cfg.fusion, _out_dim(cfg.visual),
                                    _out_dim(cfg.text))
        if cfg.moe.use_moe:
            self.moe = create_moe_layer(
                moe_config_from_model(cfg, cfg.fusion.hidden_dim))
        self.answer_head = AnswerHead(cfg.head, cfg.num_answers,
                                      cfg.fusion.hidden_dim)

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                expert_mask: Optional[torch.Tensor] = None) -> dict:
        visual = self.visual_encoder(pixel_values)
        text = self.text_encoder(input_ids, attention_mask)
        fused = self.fusion(visual, text)
        pooled, tokens, mask = fused["pooled"], fused["tokens"], fused["mask"]

        aux_loss = torch.zeros((), dtype=torch.float32,
                               device=pooled.device)
        moe_metrics = {}
        if self.config.moe.use_moe:
            tokens, aux = self.moe(tokens, expert_mask)
            aux_loss = aux_loss + aux["aux_loss"]
            moe_metrics = aux["metrics"]
            m = mask[..., None].to(tokens.dtype)
            pooled = pooled + (tokens * m).sum(dim=1) / torch.clamp(
                m.sum(dim=1), min=1e-6)

        logits = self.answer_head(pooled)
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
