"""Training state and the train/eval steps (counterpart of
vivqa_tpu/train/state.py) on one card.

The JAX package compiles one pure function ``state' = train_step(state,
batch)``; here the model and the optimizer update in place, eagerly. The
dropout randomness of step n comes from a ``torch.Generator`` reseeded
with ``fold_in(seed, n)`` before the step, as the JAX step folds the step
into ``state.rng``; reseeding is host-side and costs no device sync. The
mesh sharding (``ShardedStep``, ``place_state``) and the settled-read
defenses of the JAX package's TPU runtime have no counterpart on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from vivqa_tpu_torch.ops.batch_mix import mix_batch, mixed_cross_entropy
from vivqa_tpu_torch.train.losses import IGNORE_INDEX, cross_entropy_loss
from vivqa_tpu_torch.train.optimizers import Optimizer

_M64 = 2 ** 64 - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, step: int) -> int:
    """A 63-bit seed for step ``step`` of the run seeded ``seed``."""
    return _splitmix64(_splitmix64(seed & _M64) ^ (step & _M64)) >> 1


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    seed: int
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer,
               seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        return cls(model, optimizer, seed, torch.Generator(device=device))

    @property
    def schedule(self) -> Callable[[int], float]:
        return self.optimizer.schedule

    def step_generator(self) -> torch.Generator:
        """The generator, seeded for the current step."""
        self.generator.manual_seed(fold_in(self.seed, self.step))
        return self.generator


KNOWLEDGE_KEYS = ("knowledge_embeddings", "knowledge_mask")


def knowledge_of(batch: dict) -> dict:
    """The knowledge arrays a ``KnowledgeProvider`` attached to ``batch``
    (none when no provider wraps the loader), as the model's keyword
    arguments."""
    return {k: batch[k] for k in KNOWLEDGE_KEYS if k in batch}


def classification_loss_fn(aux_weight: float = 0.01,
                           label_smoothing: float = 0.0,
                           expert_mask: Optional[torch.Tensor] = None,
                           mix_mode: str = "none", mix_alpha: float = 0.4
                           ) -> Callable:
    """The classification loss (bench.py's, and the training pipeline's
    ``_loss_fn``): cross-entropy of the answer logits plus ``aux_weight``
    times the MoE router's aux loss. batch: dict of pixel_values,
    input_ids, attention_mask, labels on the model's device, and the
    knowledge arrays when a provider attached them. With ``mix_mode``
    (mixup | cutmix | both, ``ops/batch_mix.py``) the pixels are mixed
    first, with draws from the step's generator, and the loss and
    accuracy are the λ-weighted pair over each row's labels and its
    partner's. The metrics ``ce``, ``aux_loss`` and ``accuracy`` are 0-d
    tensors on the device."""
    def loss_fn(model: nn.Module, batch: dict, generator: torch.Generator):
        pixels, labels = batch["pixel_values"], batch["labels"]
        if mix_mode != "none":
            pixels, perm, lam = mix_batch(generator, pixels, mix_mode,
                                          mix_alpha)
        out = model(pixels, batch["input_ids"],
                    batch["attention_mask"], expert_mask=expert_mask,
                    generator=generator, **knowledge_of(batch))
        preds = out["logits"].detach().argmax(-1)
        if mix_mode != "none":
            labels_b = labels[perm]
            ce = mixed_cross_entropy(out["logits"], labels, labels_b, lam,
                                     label_smoothing)
            accuracy = (lam * (preds == labels).float().mean()
                        + (1 - lam) * (preds == labels_b).float().mean())
        else:
            ce = cross_entropy_loss(out["logits"], labels, label_smoothing)
            accuracy = (preds == labels).float().mean()
        return ce + aux_weight * out["aux_loss"], {
            "ce": ce.detach(), "aux_loss": out["aux_loss"].detach(),
            "accuracy": accuracy}
    return loss_fn


def generative_loss_fn(label_smoothing: float = 0.1,
                       moe_aux_weight: float = 0.01,
                       expert_mask: Optional[torch.Tensor] = None
                       ) -> Callable:
    """The generative pipeline's teacher-forcing loss
    (generative_training_pipeline.py:87-107): cross-entropy of the logits
    against ``labels`` with ``IGNORE_INDEX`` positions left out, plus
    ``moe_aux_weight`` times the MoE aux loss. batch: dict of
    pixel_values, question_ids, question_mask, decoder_input_ids,
    decoder_mask, labels on the model's device, and the knowledge arrays
    when a provider attached them. The metrics ``ce``, ``aux_loss`` and
    ``n_tokens`` (labels that count) are 0-d tensors on the device."""
    def loss_fn(model: nn.Module, batch: dict, generator: torch.Generator):
        out = model(batch["pixel_values"], batch["question_ids"],
                    batch["decoder_input_ids"], batch["question_mask"],
                    batch["decoder_mask"], expert_mask=expert_mask,
                    generator=generator, **knowledge_of(batch))
        ce = cross_entropy_loss(out["logits"], batch["labels"],
                                label_smoothing, ignore_index=IGNORE_INDEX)
        n_tokens = (batch["labels"] != IGNORE_INDEX).sum()
        return ce + moe_aux_weight * out["aux_loss"], {
            "ce": ce.detach(), "aux_loss": out["aux_loss"].detach(),
            "n_tokens": n_tokens}
    return loss_fn


def make_train_step(loss_fn: Callable) -> Callable:
    """loss_fn(model, batch, generator) -> (loss, metrics dict).

    Returns train_step(state, batch) -> (state, metrics): one forward in
    train mode, backward, clip and AdamW update. ``metrics`` gains
    ``loss`` and ``grad_norm`` (the global norm before clipping), both
    0-d tensors on the device, so the step never waits for the card.
    """
    def train_step(state: TrainState, batch: dict):
        state.model.train()
        state.optimizer.zero_grad()
        loss, metrics = loss_fn(state.model, batch, state.step_generator())
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics
    return train_step


def make_eval_step(metric_fn: Callable) -> Callable:
    """metric_fn(model, batch) -> metrics dict, run in eval mode with no
    gradient."""
    def eval_step(state: TrainState, batch: dict):
        state.model.eval()
        with torch.no_grad():
            return metric_fn(state.model, batch)
    return eval_step
