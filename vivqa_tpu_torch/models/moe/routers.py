"""MoE routers (counterpart of vivqa_tpu/models/moe/routers.py).

Every router returns a DENSE per-token combine-weight matrix (B, L, E)
plus aux losses. ``expert_mask`` (E,) gives disabled experts -1e9 logits
before top-k/softmax, so the remaining weights renormalize. The top-k
router is ported; the noisy, soft and expert-choice routers wait for
ROADMAP.md Queue A item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.layers import Dense
from vivqa_tpu_torch.models.moe.config import RouterConfig

NEG_INF = -1e9


@dataclasses.dataclass
class RouterOutput:
    combine_weights: torch.Tensor   # (B, L, E) dense per-token weights
    router_probs: torch.Tensor      # (B, L, E) full softmax (fp32)
    aux_loss: torch.Tensor          # scalar fp32
    metrics: dict                   # expert_usage (E,), entropy, ...


def load_balance_loss(probs: torch.Tensor,
                      assignment: torch.Tensor) -> torch.Tensor:
    """Switch-style load balance: E * sum_e(frac_tokens_e * mean_prob_e)."""
    E = probs.shape[-1]
    frac = assignment.reshape(-1, E).mean(dim=0)
    mean_prob = probs.reshape(-1, E).mean(dim=0)
    return E * torch.sum(frac * mean_prob)


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE z-loss: mean(logsumexp(logits)^2)."""
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


def _router_metrics(probs: torch.Tensor, weights: torch.Tensor) -> dict:
    E = probs.shape[-1]
    usage = (weights.reshape(-1, E) > 0).float().mean(dim=0)
    p = probs.reshape(-1, E)
    entropy = -torch.mean(torch.sum(p * torch.log(p + 1e-9), dim=-1))
    # jnp.std is the population std
    imbalance = torch.std(usage, correction=0) / (torch.mean(usage) + 1e-9)
    return {"expert_usage": usage, "routing_entropy": entropy,
            "load_imbalance": imbalance}


def _topk_dense(probs: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k then renormalize, scattered back to dense (..., E). Ties go
    to the lower expert index, as ``jax.lax.top_k`` breaks them."""
    top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    top_vals = top_vals / torch.clamp(top_vals.sum(dim=-1, keepdim=True),
                                      min=1e-9)
    dense = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    assignment = (dense > 0).to(probs.dtype)
    return dense, assignment


class TopKRouter(nn.Module):
    """Bias-free f32 gate -> softmax -> top-k -> renormalize."""

    def __init__(self, config: RouterConfig, num_experts: int, dim: int):
        super().__init__()
        self.config = config
        self.num_experts = num_experts
        self.gate = Dense(dim, num_experts, bias=False, dtype=torch.float32)

    def _logits(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor]) -> torch.Tensor:
        logits = self.gate(x.float()) / self.config.temperature
        if expert_mask is not None:
            logits = torch.where(expert_mask > 0, logits, NEG_INF)
        return logits

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None) -> RouterOutput:
        logits = self._logits(x, expert_mask)
        probs = torch.softmax(logits, dim=-1)
        weights, assignment = _topk_dense(
            probs, min(self.config.top_k, self.num_experts))
        aux = self.config.load_balance_weight * load_balance_loss(probs,
                                                                  assignment)
        if self.config.z_loss_weight:
            aux = aux + self.config.z_loss_weight * router_z_loss(logits)
        return RouterOutput(weights, probs, aux,
                            _router_metrics(probs, weights))


_ALIASES = {"top_k": "topk", "noisy_top_k": "noisy_topk"}
_KNOWN = ("topk", "noisy_topk", "soft", "expert_choice")


def create_router(config: RouterConfig, num_experts: int,
                  dim: int) -> nn.Module:
    kind = _ALIASES.get(config.router_type, config.router_type)
    if kind not in _KNOWN:
        raise ValueError(f"unknown router '{config.router_type}' "
                         f"(choices: {_KNOWN})")
    if kind == "topk":
        return TopKRouter(config, num_experts, dim)
    raise NotImplementedError(
        f"router '{kind}' is not ported yet (ROADMAP.md Queue A item 6)")
