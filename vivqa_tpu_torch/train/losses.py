"""Losses (counterpart of vivqa_tpu/train/losses.py): f32 accumulation.

Cross-entropy with label smoothing and ignored positions, soft-target and
multi-label BCE, focal, contrastive (symmetric InfoNCE), triplet, the
perplexity clamp, a multi-task combiner and the ``create_loss`` factory,
each with the JAX package's formula.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from vivqa_tpu_torch.parallel.collectives import Axis, all_reduce

# label of a position the loss leaves out (answer padding); data/dataset.py
# builds its teacher-forcing targets with it
IGNORE_INDEX = -100


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0,
                       ignore_index: Optional[int] = None,
                       weights: Optional[torch.Tensor] = None,
                       data: Optional[Axis] = None) -> torch.Tensor:
    """CE over the last axis, labels int (...,); ``ignore_index``
    positions contribute zero; the sum is divided by the (weighted) count
    of valid positions, at least 1. With ``data`` (a mesh axis that splits
    the batch) the count is the global batch's, over ``data.size``: the
    mean over the ranks of this rank's loss, and of its gradient, is the
    global batch's mean, however the ignored positions fall."""
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
    if data is not None and data.size > 1:
        total = all_reduce(valid.sum().detach(), data)
        return nll.sum() * data.size / torch.clamp(total, min=1.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1.0)


def perplexity(loss: torch.Tensor) -> torch.Tensor:
    """exp(min(loss, 100))."""
    return torch.exp(torch.clamp(loss, max=100.0))


def soft_target_loss(logits: torch.Tensor,
                     soft_targets: torch.Tensor) -> torch.Tensor:
    """VQA-v2 soft-target BCE: targets in [0, 1] per answer class; the
    sum over classes, averaged over rows."""
    logits = logits.float()
    loss = -(soft_targets * F.logsigmoid(logits)
             + (1 - soft_targets) * F.logsigmoid(-logits))
    return loss.sum(dim=-1).mean()


def binary_cross_entropy_loss(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """Multi-label BCE."""
    return soft_target_loss(logits, targets)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """alpha (1 - p_t)^gamma CE, averaged over rows."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    ce = -(onehot * logp).sum(-1)
    pt = torch.exp(-ce)
    return (alpha * (1 - pt) ** gamma * ce).mean()


def contrastive_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE between two aligned embedding batches (rows
    normalised with 1e-8 added to the norm)."""
    a = emb_a / (torch.linalg.vector_norm(emb_a, dim=-1, keepdim=True)
                 + 1e-8)
    b = emb_b / (torch.linalg.vector_norm(emb_b, dim=-1, keepdim=True)
                 + 1e-8)
    sim = (a @ b.T).float() / temperature
    labels = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (cross_entropy_loss(sim, labels)
                  + cross_entropy_loss(sim.T, labels))


def info_nce_loss(query: torch.Tensor, positive: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    return contrastive_loss(query, positive, temperature)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, margin: float = 1.0
                 ) -> torch.Tensor:
    """max(|a - p|^2 - |a - n|^2 + margin, 0), averaged over rows."""
    d_pos = ((anchor - positive) ** 2).sum(-1)
    d_neg = ((anchor - negative) ** 2).sum(-1)
    return torch.clamp(d_pos - d_neg + margin, min=0.0).mean()


@dataclasses.dataclass
class MultiTaskLoss:
    """answer + aux (MoE) + consistency terms with static weights, or with
    Kendall-style uncertainty weights when ``log_vars`` (3,) is given."""
    answer_weight: float = 1.0
    aux_weight: float = 1.0
    consistency_weight: float = 0.0

    def __call__(self, answer_loss, aux_loss=0.0, consistency_loss=0.0,
                 log_vars: Optional[torch.Tensor] = None):
        if log_vars is not None:
            terms = torch.stack([torch.as_tensor(x, dtype=log_vars.dtype,
                                                 device=log_vars.device)
                                 for x in (answer_loss, aux_loss,
                                           consistency_loss)])
            return (torch.exp(-log_vars) * terms).sum() + log_vars.sum()
        return (self.answer_weight * answer_loss
                + self.aux_weight * aux_loss
                + self.consistency_weight * consistency_loss)


_LOSSES = {
    "cross_entropy": cross_entropy_loss,
    "bce": binary_cross_entropy_loss,
    "focal": focal_loss,
    "label_smoothing": cross_entropy_loss,
    "soft_target": soft_target_loss,
    "contrastive": contrastive_loss,
    "triplet": triplet_loss,
    "infonce": info_nce_loss,
}


def create_loss(name: str) -> Callable:
    """The loss function of ``name``."""
    if name not in _LOSSES:
        raise ValueError(f"unknown loss '{name}' (choices: {tuple(_LOSSES)})")
    return _LOSSES[name]
