"""Batch-mix augmentation: MixUp and CutMix (counterpart of
vivqa_tpu/ops/batch_mix.py), inside the train step on the batch already
on the device.

As in the JAX package:
- each row mixes with the row before it (a roll by one of the batch,
  which the loader has shuffled);
- MixUp's ratio λ ~ Beta(α, α) (1 where α <= 0);
- CutMix's box has sides ``int(side * sqrt(1 - λ))`` around a centre
  drawn uniformly from ``[0, W] x [0, H]``, clipped to the image, and λ
  becomes the share of the image outside the clipped box;
- ``both`` flips a fair coin per step between the two.

The draws come from the step's ``torch.Generator`` on the batch's device,
so nothing waits for the card: λ is a Beta draw built from two Gamma
draws by Marsaglia and Tsang's method, each taking the first of
``_CANDIDATES`` candidates that passes (one fails with probability under
0.05, so all of them with under 1e-40). ``draw_mix`` makes the draws and
``apply_mix`` mixes with them, so a caller can give λ and the box.
The loss is the λ-weighted pair of cross-entropies, which equals the
cross-entropy against ``mixed_soft_targets``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

MIX_MODES = ("mixup", "cutmix", "both")
_CANDIDATES = 32


def _pair_permutation(batch_size: int, device) -> torch.Tensor:
    """Each row's mixing partner: the row before it (roll by one)."""
    return torch.roll(torch.arange(batch_size, device=device), 1)


def _log_gamma_draw(generator: torch.Generator, shape: float) -> torch.Tensor:
    """log of one Gamma(shape, 1) draw, 0-d f64 on the generator's device
    (Marsaglia and Tsang; below shape 1, Gamma(shape + 1) x U^(1/shape),
    kept in logs so a small shape cannot underflow to 0)."""
    dev = generator.device
    a = shape + 1.0 if shape < 1.0 else shape
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn(_CANDIDATES, generator=generator, device=dev,
                    dtype=torch.float64)
    u = torch.rand(_CANDIDATES, generator=generator, device=dev,
                   dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    log_v = torch.log(torch.clamp(v, min=1e-300))
    accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    first = torch.argmax(accept.to(torch.uint8))   # the first accepted
    out = math.log(d) + log_v[first]
    if shape < 1.0:
        boost = torch.rand((), generator=generator, device=dev,
                           dtype=torch.float64)
        out = out + torch.log(boost) / shape
    return out


def sample_lambda(generator: torch.Generator, alpha: float) -> torch.Tensor:
    """Beta(alpha, alpha) mixing ratio, 0-d f32 on the generator's device."""
    if alpha <= 0:
        return torch.ones((), dtype=torch.float32, device=generator.device)
    log_x = _log_gamma_draw(generator, alpha)
    log_y = _log_gamma_draw(generator, alpha)
    return torch.sigmoid(log_x - log_y).to(torch.float32)


def draw_mix(generator: torch.Generator, mode: str, alpha: float,
             height: int, width: int) -> Dict[str, torch.Tensor]:
    """The draws of one step's mix, 0-d tensors on the generator's device:
    ``lam``; for cutmix and both the box centre ``cx`` in [0, width] and
    ``cy`` in [0, height]; for both the coin ``use_mixup``."""
    if mode not in MIX_MODES:
        raise ValueError(f"unknown mix mode '{mode}' "
                         "(choices: mixup, cutmix, both)")
    dev = generator.device
    draw = {"lam": sample_lambda(generator, alpha)}
    if mode != "mixup":
        draw["cx"] = torch.randint(0, width + 1, (), generator=generator,
                                   device=dev)
        draw["cy"] = torch.randint(0, height + 1, (), generator=generator,
                                   device=dev)
    if mode == "both":
        draw["use_mixup"] = torch.rand((), generator=generator,
                                       device=dev) < 0.5
    return draw


def _mixup(images: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor
           ) -> torch.Tensor:
    return (lam * images + (1.0 - lam) * images[perm]).to(images.dtype)


def _cutmix(images: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor,
            cx: torch.Tensor, cy: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mixed NHWC images, λ re-adjusted to the clipped box's area)."""
    H, W = images.shape[1], images.shape[2]
    cut_rat = torch.sqrt(1.0 - lam.to(torch.float32))
    cut_w = (W * cut_rat).to(torch.int64)
    cut_h = (H * cut_rat).to(torch.int64)
    x1 = torch.clamp(cx - cut_w // 2, min=0)
    y1 = torch.clamp(cy - cut_h // 2, min=0)
    x2 = torch.clamp(cx + cut_w // 2, max=W)
    y2 = torch.clamp(cy + cut_h // 2, max=H)
    ys = torch.arange(H, device=images.device)[:, None]
    xs = torch.arange(W, device=images.device)[None, :]
    box = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
    mixed = torch.where(box[None, :, :, None], images[perm], images)
    lam_adj = 1.0 - ((x2 - x1) * (y2 - y1)).to(torch.float32) / float(H * W)
    return mixed.to(images.dtype), lam_adj


def apply_mix(images: torch.Tensor, mode: str,
              draw: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mix a NHWC batch with ``draw`` (``draw_mix``'s keys); returns
    (mixed images, partner index, λ)."""
    perm = _pair_permutation(images.shape[0], images.device)
    lam = draw["lam"].to(device=images.device, dtype=torch.float32)
    if mode == "mixup":
        return _mixup(images, perm, lam), perm, lam
    if mode not in ("cutmix", "both"):
        raise ValueError(f"unknown mix mode '{mode}' "
                         "(choices: mixup, cutmix, both)")
    c_img, c_lam = _cutmix(images, perm, lam, draw["cx"].to(images.device),
                           draw["cy"].to(images.device))
    if mode == "cutmix":
        return c_img, perm, c_lam
    use_mixup = draw["use_mixup"].to(images.device)
    img = torch.where(use_mixup, _mixup(images, perm, lam), c_img)
    return img, perm, torch.where(use_mixup, lam, c_lam)


def mixup(generator: torch.Generator, images: torch.Tensor,
          alpha: float = 0.4, lam: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MixUp a NHWC batch with λ drawn (or ``lam``, given); returns
    (mixed images, partner index, λ)."""
    if lam is None:
        lam = sample_lambda(generator, alpha)
    return apply_mix(images, "mixup", {"lam": torch.as_tensor(lam)})


def cutmix(generator: torch.Generator, images: torch.Tensor,
           alpha: float = 1.0, lam: Optional[torch.Tensor] = None,
           center: Optional[Tuple[int, int]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CutMix a NHWC batch; λ and the box centre (cx, cy) are drawn
    unless given. Returns (mixed images, partner index, λ of the clipped
    box)."""
    draw = draw_mix(generator, "cutmix", alpha, images.shape[1],
                    images.shape[2]) if lam is None or center is None else {}
    if lam is not None:
        draw["lam"] = torch.as_tensor(lam)
    if center is not None:
        draw["cx"], draw["cy"] = (torch.as_tensor(c) for c in center)
    return apply_mix(images, "cutmix", draw)


def mix_batch(generator: torch.Generator, images: torch.Tensor, mode: str,
              alpha: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """'mixup' | 'cutmix' | 'both' (a coin per step) with the step's
    draws; returns (mixed images, partner index, λ)."""
    return apply_mix(images, mode, draw_mix(
        generator, mode, alpha, images.shape[1], images.shape[2]))


def mixed_soft_targets(labels_a: torch.Tensor, labels_b: torch.Tensor,
                       lam: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The mixed label distribution: rows sum to 1."""
    a = F.one_hot(labels_a.long(), num_classes).float()
    b = F.one_hot(labels_b.long(), num_classes).float()
    return lam * a + (1.0 - lam) * b


def mixed_cross_entropy(logits: torch.Tensor, labels_a: torch.Tensor,
                        labels_b: torch.Tensor, lam: torch.Tensor,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """λ CE(labels_a) + (1 - λ) CE(labels_b), equal to the CE against
    ``mixed_soft_targets``."""
    # here: train/state.py imports this module
    from vivqa_tpu_torch.train.losses import cross_entropy_loss
    ce_a = cross_entropy_loss(logits, labels_a, label_smoothing)
    ce_b = cross_entropy_loss(logits, labels_b, label_smoothing)
    return lam * ce_a + (1.0 - lam) * ce_b
