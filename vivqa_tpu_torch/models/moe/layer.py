"""Dense MoE layer (counterpart of ``MOELayer`` in
vivqa_tpu/models/moe/layer.py).

Every expert sees every token; the router's combine is fused into the
output einsum ('bleh,ehd,ble->bld') and the residual + LayerNorm sit
outside it: y = LN(x + sum_e w_e * FF_e(x)). The layer computes in its
input's dtype. The sparse, VQA and hierarchical layers wait for
ROADMAP.md Queue A item 13.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.layers import (DropoutRNG, LayerNorm, dropout,
                                           gelu_tanh)
from vivqa_tpu_torch.models.moe.config import MoEConfig
from vivqa_tpu_torch.models.moe.routers import create_router


class MOELayer(nn.Module):
    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        E, H, D = cfg.num_experts, cfg.expert.hidden_dim, cfg.input_dim
        if cfg.expert.expert_type != "feedforward":
            raise NotImplementedError(
                f"expert type '{cfg.expert.expert_type}' is not ported yet "
                "(ROADMAP.md Queue A item 13)")
        self.config = cfg
        self.dropout = cfg.expert.dropout       # on the experts' hidden units
        self.router = create_router(cfg.router, E, D)
        self.experts_w_in = nn.Parameter(torch.empty(E, D, H))
        self.experts_bias_in = nn.Parameter(torch.zeros(E, H))
        self.experts_w_out = nn.Parameter(torch.empty(E, H, D))
        self.experts_bias_out = nn.Parameter(torch.zeros(E, D))
        self.ln_out = LayerNorm(D, dtype=None)     # in x's dtype

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        rout = self.router(x, expert_mask)
        dt = x.dtype
        w = rout.combine_weights.to(dt)                          # (B, L, E)
        h = torch.einsum("bld,edh->bleh", x, self.experts_w_in.to(dt))
        h = gelu_tanh(h + self.experts_bias_in.to(dt))
        h = dropout(h, self.dropout, rng)
        y = torch.einsum("bleh,ehd,ble->bld", h, self.experts_w_out.to(dt), w)
        y = y + torch.einsum("ble,ed->bld", w, self.experts_bias_out.to(dt))
        y = self.ln_out(y + x)
        return y, {"aux_loss": rout.aux_loss, "metrics": rout.metrics}


def create_moe_layer(config: MoEConfig) -> nn.Module:
    if not isinstance(config, MoEConfig):
        raise NotImplementedError(
            f"{type(config).__name__} is not ported yet "
            "(ROADMAP.md Queue A item 13)")
    if config.moe_type == "standard":
        return MOELayer(config)
    if config.moe_type in ("sparse", "hierarchical"):
        raise NotImplementedError(
            f"moe_type '{config.moe_type}' is not ported yet "
            "(ROADMAP.md Queue A item 13)")
    raise ValueError(f"unknown moe_type '{config.moe_type}'")
