"""Training strategies (counterpart of vivqa_tpu/train/strategies.py):
full / freeze_visual / freeze_text / linear_probe / gradual_unfreeze.

"Freezing" is a mask over the parameters (True = trainable) that the
optimizer applies, as the JAX package applies its optax mask: a frozen
parameter still gets its gradient (the backward runs through the frozen
tower and ``grad_norm`` covers it), but no update, decay or moment.
Each parameter is judged by the first segment of its flax path
(``models/from_jax.flax_paths``), so the JAX package's prefix rules apply
letter for letter; a top-level module they do not name (the knowledge
modules, for example) stays trainable under every strategy but
``linear_probe``.
"""

from __future__ import annotations

from torch import nn

from vivqa_tpu_torch.models.from_jax import flax_paths

STRATEGIES = ("full", "freeze_visual", "freeze_text", "linear_probe",
              "gradual_unfreeze")

_VISUAL_PREFIX = "visual_encoder"
_TEXT_PREFIXES = ("text_encoder", "question_encoder")
_HEAD_PREFIXES = ("answer_head", "decoder")


def _trainable(head: str, strategy: str, epoch: int,
               total_epochs: int) -> bool:
    if strategy == "full":
        return True
    if strategy == "freeze_visual":
        return head != _VISUAL_PREFIX
    if strategy == "freeze_text":
        return head not in _TEXT_PREFIXES
    if strategy == "linear_probe":
        return head in _HEAD_PREFIXES
    # gradual_unfreeze: the heads always; the text encoder from a third of
    # the run, the visual encoder from two thirds
    frac = epoch / max(1, total_epochs)
    if head in _HEAD_PREFIXES or head.startswith("fusion") or head == "moe":
        return True
    if head in _TEXT_PREFIXES:
        return frac >= 1 / 3
    if head == _VISUAL_PREFIX:
        return frac >= 2 / 3
    return True


def trainable_mask(model: nn.Module, strategy: str, epoch: int = 0,
                   total_epochs: int = 1) -> dict[str, bool]:
    """torch parameter name -> True where the parameter trains under
    ``strategy`` at ``epoch`` of ``total_epochs``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy '{strategy}' "
                         f"(choices: {STRATEGIES})")
    return {name: _trainable(path.split("/")[0], strategy, epoch,
                             total_epochs)
            for name, path in flax_paths(model).items()}
