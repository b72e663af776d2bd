"""Losses (counterpart of vivqa_tpu/train/losses.py): f32 accumulation.

The classification slice needs ``cross_entropy_loss`` and ``perplexity``;
the rest of the loss zoo waits (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0,
                       ignore_index: Optional[int] = None,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """CE over the last axis, labels int (...,); ``ignore_index``
    positions contribute zero; the sum is divided by the (weighted) count
    of valid positions, at least 1."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = torch.ones(labels.shape, dtype=torch.float32,
                       device=logits.device)
    if ignore_index is not None:
        valid = (labels != ignore_index).float()
        labels = torch.where(labels == ignore_index, 0, labels)
    onehot = F.one_hot(labels, num_classes).float()
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) \
            + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    nll = -(onehot * logp).sum(dim=-1) * valid
    if weights is not None:
        nll = nll * weights
        valid = valid * weights
    return nll.sum() / torch.clamp(valid.sum(), min=1.0)


def perplexity(loss: torch.Tensor) -> torch.Tensor:
    """exp(min(loss, 100))."""
    return torch.exp(torch.clamp(loss, max=100.0))
