"""MoE layers (counterpart of vivqa_tpu/models/moe/layer.py).

- ``MOELayer`` (dense): every expert sees every token; the router's
  combine is fused into the output einsum ('bleh,ehd,ble->bld') and the
  residual + LayerNorm sit outside it: y = LN(x + sum_e w_e * FF_e(x)).
  It computes in its input's dtype; the ``glu`` expert type gates the
  hidden units with sigmoid(x W_gate), any other type is the
  feed-forward expert, as in the JAX package.
- ``VQAMoELayer``: heterogeneous experts in the FIXED order vision ->
  text -> multimodal -> specialized (the ablation's expert masks index
  into it), each computed on every token; their outputs are stacked
  (B, L, E, D), combined densely by the router's weights and
  LayerNormed. A masked expert is still computed (its weight is 0).

The experts live in a ``ModuleDict`` named ``experts`` whose keys are the
flax names after ``experts/`` (``vision_0``, ``specialized_3_ocr``), so
``from_jax.py`` maps them by path. The sparse and hierarchical layers
wait for ROADMAP.md Queue A item 13.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.layers import (DropoutRNG, LayerNorm, dropout,
                                           gelu_tanh)
from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                               VQAMoEConfig)
from vivqa_tpu_torch.models.moe.experts import (MultimodalExpert, TextExpert,
                                                VisionExpert, create_expert)
from vivqa_tpu_torch.models.moe.routers import create_router


class MOELayer(nn.Module):
    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        E, H, D = cfg.num_experts, cfg.expert.hidden_dim, cfg.input_dim
        self.config = cfg
        self.dropout = cfg.expert.dropout       # on the experts' hidden units
        self.router = create_router(cfg.router, E, D)
        self.experts_w_in = nn.Parameter(torch.empty(E, D, H))
        self.experts_bias_in = nn.Parameter(torch.zeros(E, H))
        self.experts_w_out = nn.Parameter(torch.empty(E, H, D))
        self.experts_bias_out = nn.Parameter(torch.zeros(E, D))
        self.experts_w_gate = nn.Parameter(torch.empty(E, D, H)) \
            if cfg.expert.expert_type == "glu" else None
        self.ln_out = LayerNorm(D, dtype=None)     # in x's dtype

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        rout = self.router(x, expert_mask, rng)
        dt = x.dtype
        w = rout.combine_weights.to(dt)                          # (B, L, E)
        h = torch.einsum("bld,edh->bleh", x, self.experts_w_in.to(dt))
        h = gelu_tanh(h + self.experts_bias_in.to(dt))
        if self.experts_w_gate is not None:
            h = h * torch.sigmoid(torch.einsum(
                "bld,edh->bleh", x, self.experts_w_gate.to(dt)))
        h = dropout(h, self.dropout, rng)
        y = torch.einsum("bleh,ehd,ble->bld", h, self.experts_w_out.to(dt), w)
        y = y + torch.einsum("ble,ed->bld", w, self.experts_bias_out.to(dt))
        y = self.ln_out(y + x)
        return y, {"aux_loss": rout.aux_loss, "metrics": rout.metrics}


class VQAMoELayer(nn.Module):
    def __init__(self, config: VQAMoEConfig):
        super().__init__()
        cfg = config
        D = cfg.input_dim
        ex_cfg = ExpertConfig(hidden_dim=cfg.expert_hidden_dim,
                              num_heads=cfg.num_heads, dropout=cfg.dropout)
        experts = {}
        for kind, cls, n in (("vision", VisionExpert, cfg.num_vision_experts),
                             ("text", TextExpert, cfg.num_text_experts),
                             ("multimodal", MultimodalExpert,
                              cfg.num_multimodal_experts)):
            for i in range(n):
                experts[f"{kind}_{i}"] = cls(ex_cfg, D)
        for i, s in enumerate(cfg.specialized_types):
            experts[f"specialized_{i}_{s}"] = create_expert(
                ex_cfg.replace(expert_type=s), D)
        if len(experts) != cfg.num_experts:
            raise ValueError(f"{len(experts)} experts built, the config "
                             f"counts {cfg.num_experts}")
        self.config = cfg
        self.router = create_router(cfg.router, len(experts), D)
        self.experts = nn.ModuleDict(experts)
        self.ln_out = LayerNorm(D, dtype=None)     # in the experts' dtype

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        rout = self.router(x, expert_mask, rng)
        outs = [ex(x, rng) for ex in self.experts.values()]
        dt = outs[0].dtype
        for o in outs[1:]:
            dt = torch.promote_types(dt, o.dtype)
        outs = torch.stack([o.to(dt) for o in outs], dim=2)   # (B, L, E, D)
        y = torch.einsum("ble,bled->bld", rout.combine_weights.to(dt), outs)
        y = self.ln_out(y + x.to(dt))
        return y, {"aux_loss": rout.aux_loss, "metrics": rout.metrics}


def create_moe_layer(config: MoEConfig | VQAMoEConfig) -> nn.Module:
    if isinstance(config, VQAMoEConfig):
        return VQAMoELayer(config)
    if config.moe_type == "standard":
        return MOELayer(config)
    if config.moe_type in ("sparse", "hierarchical"):
        raise NotImplementedError(
            f"moe_type '{config.moe_type}' is not ported yet "
            "(ROADMAP.md Queue A item 13)")
    raise ValueError(f"unknown moe_type '{config.moe_type}'")
