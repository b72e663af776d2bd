"""MoE experts (counterpart of vivqa_tpu/models/moe/experts.py).

``StackedExperts`` holds E homogeneous feed-forward / GLU experts as one
stacked (E, D, H) weight and computes them in one einsum. The other
experts are modules of their own: feed-forward and GLU, vision (spatial
self-attention), text (self-attention + FFN) and multimodal (attention
to the sequence mean + a sigmoid modality gate); ``create_expert`` also
builds the six specialized experts of ``specialized.py``.

As in the JAX package every expert computes in bf16 whatever the model's
dtype (each flax class sets ``dtype = jnp.bfloat16``), with f32 params.
Every expert maps (B, L, D) -> (B, L, D) with a residual inside; none
takes the token mask, so padded tokens are attended to, as in the JAX
package. Training mode is an ``rng`` (``DropoutRNG``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, LayerNorm,
                                           MultiHeadDotProductAttention,
                                           dropout, gelu_tanh)
from vivqa_tpu_torch.models.moe.config import ExpertConfig

_DTYPE = torch.bfloat16


class StackedExperts(nn.Module):
    """E homogeneous experts as stacked weights, computed in one shot:
    expert_i(x) = LN(x + W2_i act(W1_i x)) (GLU: act(W1_i x) *
    sigmoid(Wg_i x)); x (B, L, D) -> per-expert outputs (B, L, E, D)."""

    def __init__(self, num_experts: int, dim: int, hidden_dim: int,
                 glu: bool = False, dropout: float = 0.0):
        super().__init__()
        E, D, H = num_experts, dim, hidden_dim
        self.dropout = dropout
        self.w_in = nn.Parameter(torch.empty(E, D, H))
        self.bias_in = nn.Parameter(torch.zeros(E, H))
        self.w_out = nn.Parameter(torch.empty(E, H, D))
        self.bias_out = nn.Parameter(torch.zeros(E, D))
        self.w_gate = nn.Parameter(torch.empty(E, D, H)) if glu else None
        self.ln = LayerNorm(D, _DTYPE)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        xc = x.to(_DTYPE)
        h = torch.einsum("bld,edh->bleh", xc, self.w_in.to(_DTYPE))
        h = gelu_tanh(h + self.bias_in.to(_DTYPE))
        if self.w_gate is not None:
            h = h * torch.sigmoid(torch.einsum("bld,edh->bleh", xc,
                                               self.w_gate.to(_DTYPE)))
        h = dropout(h, self.dropout, rng)
        y = torch.einsum("bleh,ehd->bled", h, self.w_out.to(_DTYPE))
        y = y + self.bias_out.to(_DTYPE) + xc[:, :, None, :]
        return self.ln(y)


class FeedForwardExpert(nn.Module):
    """LN(x + wo(dropout(gelu(wi(x)))))."""

    def __init__(self, config: ExpertConfig, dim: int):
        super().__init__()
        self.dropout = config.dropout
        self.wi = Dense(dim, config.hidden_dim, dtype=_DTYPE)
        self.wo = Dense(config.hidden_dim, dim, dtype=_DTYPE)
        self.ln = LayerNorm(dim, _DTYPE)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        h = dropout(gelu_tanh(self.wi(x)), self.dropout, rng)
        return self.ln(x + self.wo(h))


class GatedLinearExpert(nn.Module):
    """LN(x + wo(dropout(gelu(wi(x)) * sigmoid(w_gate(x)))))."""

    def __init__(self, config: ExpertConfig, dim: int):
        super().__init__()
        self.dropout = config.dropout
        self.wi = Dense(dim, config.hidden_dim, dtype=_DTYPE)
        self.w_gate = Dense(dim, config.hidden_dim, dtype=_DTYPE)
        self.wo = Dense(config.hidden_dim, dim, dtype=_DTYPE)
        self.ln = LayerNorm(dim, _DTYPE)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        h = gelu_tanh(self.wi(x)) * torch.sigmoid(self.w_gate(x))
        h = dropout(h, self.dropout, rng)
        return self.ln(x + self.wo(h))


class _AttentionExpert(nn.Module):
    """Pre-LN attention, then a pre-LN MLP, both residual; the attention
    is named as the flax module names it (``attn_name``)."""
    attn_name = ""

    def __init__(self, config: ExpertConfig, dim: int):
        super().__init__()
        self.dropout = config.dropout
        self.ln1 = LayerNorm(dim, _DTYPE)
        setattr(self, self.attn_name, MultiHeadDotProductAttention(
            dim, config.num_heads, dtype=_DTYPE,
            dropout_rate=config.dropout))
        self.ln2 = LayerNorm(dim, _DTYPE)
        self.wi = Dense(dim, config.hidden_dim, dtype=_DTYPE)
        self.wo = Dense(config.hidden_dim, dim, dtype=_DTYPE)

    def _mlp(self, x: torch.Tensor, rng: Optional[DropoutRNG],
             rate: float) -> torch.Tensor:
        y = dropout(gelu_tanh(self.wi(self.ln2(x))), rate, rng)
        return x + self.wo(y)


class VisionExpert(_AttentionExpert):
    """Spatial multi-head self-attention over the tokens, then an MLP."""
    attn_name = "spatial_attn"

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        y = self.ln1(x)
        x = x + self.spatial_attn(y, y, rng=rng)
        return self._mlp(x, rng, 0.0)


class TextExpert(_AttentionExpert):
    """Self-attention, then an MLP with dropout on its hidden units."""
    attn_name = "self_attn"

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        y = self.ln1(x)
        x = x + self.self_attn(y, y, rng=rng)
        return self._mlp(x, rng, self.dropout)


class MultimodalExpert(_AttentionExpert):
    """Each token attends to the sequence mean (one key), scaled by a
    sigmoid gate of the token; then an MLP."""
    attn_name = "cross_attn"

    def __init__(self, config: ExpertConfig, dim: int):
        super().__init__(config, dim)
        self.gate = Dense(dim, dim, dtype=_DTYPE)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        ctx = x.mean(dim=1, keepdim=True)
        y = self.cross_attn(self.ln1(x), ctx, rng=rng)
        x = x + torch.sigmoid(self.gate(x)) * y
        return self._mlp(x, rng, 0.0)


_EXPERTS = {
    "feedforward": FeedForwardExpert,
    "glu": GatedLinearExpert,
    "vision": VisionExpert,
    "text": TextExpert,
    "multimodal": MultimodalExpert,
}


def create_expert(config: ExpertConfig, dim: int) -> nn.Module:
    """An expert of ``config.expert_type`` over tokens of width ``dim``."""
    from vivqa_tpu_torch.models.moe.specialized import SPECIALIZED_EXPERTS
    registry = {**_EXPERTS, **SPECIALIZED_EXPERTS}
    if config.expert_type not in registry:
        raise ValueError(f"unknown expert type '{config.expert_type}' "
                         f"(choices: {tuple(registry)})")
    return registry[config.expert_type](config, dim)
