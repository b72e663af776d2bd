"""MoE routers (counterpart of vivqa_tpu/models/moe/routers.py).

Every router returns a DENSE per-token combine-weight matrix (B, L, E)
plus aux losses. ``expert_mask`` (E,) gives disabled experts -1e9 logits
before top-k/softmax, so the remaining weights renormalize.

Training mode is a ``DropoutRNG`` passed as ``rng`` (flax's
``deterministic=False``): the noisy router draws its N(0, 1) noise from
that forward's generator, never from the global RNG, so its training
draws differ from JAX's ``make_rng("router")`` and only its
deterministic path is compared with the JAX package. Every ``top_k``
here breaks ties toward the lower index, as ``jax.lax.top_k`` does
(``torch.topk`` on CUDA promises no order among equal values).

Under data parallelism (a mesh's 'data' axis, ``use_mesh``) the
load-balance loss is the global batch's: the token fraction and the mean
probability per expert are averaged over 'data' (the latter with its
gradient) before their product, as the JAX package's global computation
takes them. The z-loss is a plain mean and needs nothing more. The
expert-choice router picks tokens within each row, so it too runs
unchanged on a rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.layers import Dense, DropoutRNG
from vivqa_tpu_torch.models.moe.config import RouterConfig
from vivqa_tpu_torch.parallel.collectives import (Axis, all_reduce,
                                                  all_reduce_with_grad)

NEG_INF = -1e9


@dataclasses.dataclass
class RouterOutput:
    combine_weights: torch.Tensor   # (B, L, E) dense per-token weights
    router_probs: torch.Tensor      # (B, L, E) full softmax (fp32)
    aux_loss: torch.Tensor          # scalar fp32
    metrics: dict                   # expert_usage (E,), entropy, ...


def load_balance_loss(probs: torch.Tensor, assignment: torch.Tensor,
                      data: Optional[Axis] = None) -> torch.Tensor:
    """Switch-style load balance: E * sum_e(frac_tokens_e * mean_prob_e),
    both means over the global batch when ``data`` splits it (ranks of
    equal rows)."""
    E = probs.shape[-1]
    frac = assignment.reshape(-1, E).mean(dim=0)
    mean_prob = probs.reshape(-1, E).mean(dim=0)
    if data is not None and data.size > 1:
        frac = all_reduce(frac.detach(), data) / data.size
        mean_prob = all_reduce_with_grad(mean_prob, data) / data.size
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


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_dense(probs: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k then renormalize, scattered back to dense (..., E). Ties go
    to the lower expert index, as ``jax.lax.top_k`` breaks them."""
    top_vals, top_idx = _top_k(probs, k)
    top_vals = top_vals / torch.clamp(top_vals.sum(dim=-1, keepdim=True),
                                      min=1e-9)
    dense = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    assignment = (dense > 0).to(probs.dtype)
    return dense, assignment


class TopKRouter(nn.Module):
    """Bias-free f32 gate -> softmax -> top-k -> renormalize."""
    data: Optional[Axis] = None

    def __init__(self, config: RouterConfig, num_experts: int, dim: int):
        super().__init__()
        self.config = config
        self.num_experts = num_experts
        self.gate = Dense(dim, num_experts, bias=False, dtype=torch.float32)

    def use_mesh(self, mesh, sharded: set) -> set:
        self.data = mesh.data
        return set()

    def _logits(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor]) -> torch.Tensor:
        logits = self.gate(x.float()) / self.config.temperature
        if expert_mask is not None:
            logits = torch.where(expert_mask > 0, logits, NEG_INF)
        return logits

    def _finish(self, logits: torch.Tensor, weights: torch.Tensor,
                assignment: torch.Tensor) -> RouterOutput:
        probs = torch.softmax(logits, dim=-1)
        aux = self.config.load_balance_weight * load_balance_loss(
            probs, assignment, self.data)
        if self.config.z_loss_weight:
            aux = aux + self.config.z_loss_weight * router_z_loss(logits)
        return RouterOutput(weights, probs, aux,
                            _router_metrics(probs, weights))

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> RouterOutput:
        logits = self._logits(x, expert_mask)
        weights, assignment = _topk_dense(
            torch.softmax(logits, dim=-1),
            min(self.config.top_k, self.num_experts))
        return self._finish(logits, weights, assignment)


class NoisyTopKRouter(TopKRouter):
    """Learned-noise top-k: in training, N(0, 1) * softplus(w_noise(x)) *
    ``noise_std`` is added to the logits before the top-k; the masked
    experts are masked again after the noise. ``w_noise`` exists in eval
    too. Aux loss and metrics read the clean logits."""

    def __init__(self, config: RouterConfig, num_experts: int, dim: int):
        super().__init__(config, num_experts, dim)
        self.w_noise = Dense(dim, num_experts, bias=False,
                             dtype=torch.float32)

    def noisy_logits(self, x: torch.Tensor, logits: torch.Tensor,
                     expert_mask: Optional[torch.Tensor],
                     rng: DropoutRNG) -> torch.Tensor:
        """The training logits: ``logits`` + N(0, 1) * softplus(w_noise(x))
        * noise_std, the masked experts masked again."""
        scale = F.softplus(self.w_noise(x.float())) * self.config.noise_std
        noise = torch.randn(logits.shape, generator=rng.generator,
                            device=logits.device)
        noisy = logits + noise * scale
        if expert_mask is not None:
            noisy = torch.where(expert_mask > 0, noisy, NEG_INF)
        return noisy

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> RouterOutput:
        logits = self._logits(x, expert_mask)
        noisy = logits if rng is None else self.noisy_logits(
            x, logits, expert_mask, rng)
        weights, assignment = _topk_dense(
            torch.softmax(noisy, dim=-1),
            min(self.config.top_k, self.num_experts))
        return self._finish(logits, weights, assignment)


class SoftRouter(TopKRouter):
    """Every expert at its softmax weight; an entropy regularizer when
    ``entropy_weight`` is set."""

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> RouterOutput:
        logits = self._logits(x, expert_mask)
        probs = torch.softmax(logits, dim=-1)
        out = self._finish(logits, probs, (probs > 1e-6).to(probs.dtype))
        if self.config.entropy_weight:
            ent = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9),
                                        dim=-1))
            out.aux_loss = out.aux_loss + self.config.entropy_weight * ent
        return out


class ExpertChoiceRouter(TopKRouter):
    """Each expert takes its top ``int(capacity_factor * L / E)`` tokens
    (at least one) at their softmax weight; a token no expert chose gets
    zero weight."""

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> RouterOutput:
        logits = self._logits(x, expert_mask)             # (B, L, E)
        L, E = logits.shape[1:]
        probs = torch.softmax(logits, dim=-1)
        cap = max(1, int(self.config.capacity_factor * L / E))
        scores = probs.transpose(1, 2)                    # (B, E, L)
        top_vals, top_idx = _top_k(scores, min(cap, L))
        weights = torch.zeros_like(scores).scatter(
            -1, top_idx, top_vals).transpose(1, 2)
        return self._finish(logits, weights, (weights > 0).to(probs.dtype))


_ROUTERS = {"topk": TopKRouter, "noisy_topk": NoisyTopKRouter,
            "soft": SoftRouter, "expert_choice": ExpertChoiceRouter}
_ALIASES = {"top_k": "topk", "noisy_top_k": "noisy_topk"}


def create_router(config: RouterConfig, num_experts: int,
                  dim: int) -> nn.Module:
    kind = _ALIASES.get(config.router_type, config.router_type)
    if kind not in _ROUTERS:
        raise ValueError(f"unknown router '{config.router_type}' "
                         f"(choices: {tuple(_ROUTERS)})")
    return _ROUTERS[kind](config, num_experts, dim)
