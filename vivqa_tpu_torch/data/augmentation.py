"""Eval-mode image preprocessing: a copy of the ``mode="eval"`` path of
``ImageAugmentation`` in vivqa_tpu/data/augmentation.py.

PIL.Image | ndarray | path -> (H, W, 3) float32: RGB, bicubic resize to
``image_size``, scale to [0, 1], then CLIP mean/std. The train-mode
augmentations belong to the training slice (ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class ImageAugmentation:
    def __init__(self, image_size: int = 224, mode: str = "eval",
                 mean: Sequence[float] = CLIP_MEAN,
                 std: Sequence[float] = CLIP_STD):
        if mode != "eval":
            raise NotImplementedError(
                "train-mode augmentation is not ported yet "
                "(ROADMAP.md Queue A item 10)")
        self.image_size = image_size
        self.mode = mode
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def _load(self, img) -> Image.Image:
        if isinstance(img, Image.Image):
            return img.convert("RGB")
        if isinstance(img, np.ndarray):
            arr = img
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            return Image.fromarray(arr).convert("RGB")
        try:
            return Image.open(img).convert("RGB")
        except OSError:
            # black placeholder for a missing or corrupt image, as the
            # JAX package does
            return Image.new("RGB", (self.image_size, self.image_size))

    def __call__(self, img) -> np.ndarray:
        s = self.image_size
        im = self._load(img).resize((s, s), Image.BICUBIC)
        arr = np.asarray(im, np.float32) / 255.0
        return (arr - self.mean) / self.std
