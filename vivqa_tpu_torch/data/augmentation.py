"""Image & text preprocessing / augmentation (host-side, PIL + numpy): a
copy of vivqa_tpu/data/augmentation.py (the port imports nothing of the
JAX package).

- ``ImageAugmentation``: train/eval modes, strength presets light /
  medium / strong (flip, color jitter, grayscale, rotation, affine
  translate, random erasing) drawn from one ``random.Random(seed)`` in
  the JAX package's order, so a seed gives the same pixels; float32 NHWC
  normalized with CLIP statistics, or raw uint8 (``normalize=False``, the
  "u8 wire" format, 4x fewer host-to-device bytes). ``batch`` is the
  native loader's path (``data/fastloader.py``).
- ``TextAugmentation`` (random deletion / random swap).
- ``DropoutScheduler`` (warmup + linear/cosine ramp). The JAX package
  rebuilds its flax module from a rate-substituted config
  (``apply_to_config``); the port sets the rate on the live modules
  (``apply_to_model``), so the optimizer keeps the same parameters.
- ``normalize_pixels_on_device``: the device half of the u8 wire format.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

import numpy as np
import torch
from PIL import Image, ImageEnhance

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

STRENGTH_PRESETS = {
    "light": dict(flip_p=0.5, jitter=0.1, gray_p=0.0, rot_deg=0, trans=0.0,
                  erase_p=0.0),
    "medium": dict(flip_p=0.5, jitter=0.2, gray_p=0.1, rot_deg=10, trans=0.05,
                   erase_p=0.1),
    "strong": dict(flip_p=0.5, jitter=0.4, gray_p=0.2, rot_deg=20, trans=0.1,
                   erase_p=0.25),
}


class ImageAugmentation:
    """Callable: PIL.Image | ndarray | path -> (H, W, 3) float32 normalized
    (uint8 with ``normalize=False``)."""

    def __init__(self, image_size: int = 224, mode: str = "train",
                 strength: str = "medium", seed: int | None = None,
                 mean: Sequence[float] = CLIP_MEAN,
                 std: Sequence[float] = CLIP_STD,
                 normalize: bool = True):
        if mode not in ("train", "eval"):
            raise ValueError(f"unknown mode '{mode}' (choices: train, eval)")
        if strength not in STRENGTH_PRESETS:
            raise ValueError(f"unknown strength '{strength}' "
                             f"(choices: {tuple(STRENGTH_PRESETS)})")
        self.image_size = image_size
        self.mode = mode
        self.p = STRENGTH_PRESETS[strength]
        self.rng = random.Random(seed)
        self.normalize = normalize
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        # the native loader always applies (x/255 - mean)/std; identity
        # mean/std make its float output raw 0..255 for the u8 path
        self._native_mean = self.mean if normalize else \
            np.zeros(3, np.float32)
        self._native_std = self.std if normalize else \
            np.full(3, 1.0 / 255.0, np.float32)

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
            # black placeholder for a missing or corrupt image
            return Image.new("RGB", (self.image_size, self.image_size))

    def batch(self, paths: Sequence) -> np.ndarray | None:
        """Native batch path: decode + (train-mode) augment + normalize all
        ``paths`` in one C++ call. None when the library cannot be loaded
        or an input is not a path: the caller then takes the per-sample
        PIL ``__call__``. Failed decodes become black placeholders, as on
        the PIL path."""
        if not all(isinstance(p, (str, bytes)) or hasattr(p, "__fspath__")
                   for p in paths):
            return None
        from vivqa_tpu_torch.data import fastloader
        if not fastloader.is_available():
            return None
        if self.mode == "train":
            seed = self.rng.getrandbits(63)   # advances with each batch
            out, status = fastloader.batch_load_train(
                [str(p) for p in paths], self.image_size, self.p, seed,
                self._native_mean, self._native_std)
        else:
            out, status = fastloader.batch_load(
                [str(p) for p in paths], self.image_size,
                self._native_mean, self._native_std)
        for i in np.nonzero(status != 0)[0]:
            if status[i] == -3:
                # decode failure, possibly not a JPEG: PIL gets a chance
                out[i] = self(paths[i])
            else:
                # missing or unreadable file: a black placeholder, i.e.
                # black in normalized space, not raw zeros
                out[i] = ((-self.mean / self.std).astype(np.float32)
                          if self.normalize else 0.0)
        if not self.normalize:
            return np.clip(out, 0.0, 255.0).astype(np.uint8)
        return out

    def __call__(self, img) -> np.ndarray:
        im = self._load(img)
        s = self.image_size
        if self.mode == "train":
            p, rng = self.p, self.rng
            if rng.random() < p["flip_p"]:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
            if p["jitter"] > 0:
                for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                            ImageEnhance.Color):
                    f = 1.0 + rng.uniform(-p["jitter"], p["jitter"])
                    im = enh(im).enhance(f)
            if p["gray_p"] > 0 and rng.random() < p["gray_p"]:
                im = im.convert("L").convert("RGB")
            if p["rot_deg"] > 0:
                im = im.rotate(rng.uniform(-p["rot_deg"], p["rot_deg"]),
                               resample=Image.BILINEAR)
            if p["trans"] > 0:
                dx = rng.uniform(-p["trans"], p["trans"]) * im.width
                dy = rng.uniform(-p["trans"], p["trans"]) * im.height
                im = im.transform(im.size, Image.AFFINE, (1, 0, dx, 0, 1, dy),
                                  resample=Image.BILINEAR)
        im = im.resize((s, s), Image.BICUBIC)
        arr = np.asarray(im, np.float32) / 255.0
        # the erase draws come after the resize, as in the JAX package
        if self.mode == "train" and self.p["erase_p"] > 0 \
                and self.rng.random() < self.p["erase_p"]:
            eh = self.rng.randint(s // 8, s // 4)
            ew = self.rng.randint(s // 8, s // 4)
            y = self.rng.randint(0, s - eh)
            x = self.rng.randint(0, s - ew)
            arr[y:y + eh, x:x + ew] = self.rng.random()
        if not self.normalize:
            return np.clip(arr * 255.0, 0.0, 255.0).astype(np.uint8)
        return (arr - self.mean) / self.std


class TextAugmentation:
    """Vietnamese question augmentation (reference augmentation.py:350-473).

    Whitespace-token level, which is the right granularity for Vietnamese
    (syllable-per-token): random deletion (keep >= 1 word) and random
    swap. The reference accepts an ``enable_synonym_replacement`` flag
    but never registers a synonym function in ``__call__`` (:440-452);
    the flag is kept for API parity with identical (no-op) behavior.
    Seeded locally — no dependence on the global ``random`` state.
    """

    def __init__(self, augmentation_probability: float = 0.3,
                 enable_synonym_replacement: bool = True,
                 enable_random_deletion: bool = True,
                 enable_random_swap: bool = True,
                 seed: int | None = None):
        self.augmentation_probability = augmentation_probability
        self.enable_synonym_replacement = enable_synonym_replacement
        self.enable_random_deletion = enable_random_deletion
        self.enable_random_swap = enable_random_swap
        self.rng = random.Random(seed)

    def random_deletion(self, words: list, p: float = 0.1) -> list:
        """Drop each word with prob p; never return empty (:383-410)."""
        if len(words) <= 1:
            return words
        kept = [w for w in words if self.rng.random() > p]
        return kept if kept else [self.rng.choice(words)]

    def random_swap(self, words: list, n: int = 1) -> list:
        """Swap n random position pairs (:412-435)."""
        if len(words) < 2:
            return words
        out = list(words)
        for _ in range(n):
            i = self.rng.randrange(len(out))
            j = self.rng.randrange(len(out))
            out[i], out[j] = out[j], out[i]
        return out

    def __call__(self, text: str) -> str:
        if self.rng.random() > self.augmentation_probability:
            return text
        words = text.split()
        if len(words) <= 1:
            return text
        fns = []
        if self.enable_random_deletion:
            fns.append(lambda w: self.random_deletion(w, p=0.1))
        if self.enable_random_swap:
            fns.append(lambda w: self.random_swap(w, n=1))
        if not fns:
            return text
        return " ".join(self.rng.choice(fns)(words))


def create_text_augmentation(augmentation_probability: float = 0.3,
                             **kwargs) -> TextAugmentation:
    """Factory (reference augmentation.py:593)."""
    return TextAugmentation(augmentation_probability, **kwargs)


class DropoutScheduler:
    """Scheduled dropout rate over training (reference :475-562): flat
    warmup at ``initial_dropout`` then a linear or cosine ramp to
    ``final_dropout`` by ``total_steps``. "Step" granularity is the
    caller's choice; the training pipeline drives it per epoch, as the
    JAX package does."""

    def __init__(self, initial_dropout: float = 0.1,
                 final_dropout: float = 0.3, total_steps: int = 10000,
                 warmup_steps: int = 1000, schedule: str = "linear"):
        if schedule not in ("linear", "cosine"):
            raise ValueError(f"unknown schedule '{schedule}' "
                             "(choices: linear, cosine)")
        self.initial_dropout = initial_dropout
        self.final_dropout = final_dropout
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.schedule = schedule
        self.current_step = 0

    def get_dropout(self, step: int | None = None) -> float:
        if step is None:
            step = self.current_step
        if step < self.warmup_steps:
            return self.initial_dropout
        progress = min(1.0, (step - self.warmup_steps) /
                       max(1, self.total_steps - self.warmup_steps))
        span = self.final_dropout - self.initial_dropout
        if self.schedule == "cosine":
            return self.initial_dropout + 0.5 * span * (
                1 - math.cos(math.pi * progress))
        return self.initial_dropout + progress * span

    def step(self) -> float:
        self.current_step += 1
        return self.get_dropout()

    @staticmethod
    def apply_to_config(config, rate: float):
        """A copy of a (nested, frozen) model config with every ``dropout``
        field set to ``rate``."""
        if not dataclasses.is_dataclass(config):
            return config
        changes = {}
        for f in dataclasses.fields(config):
            v = getattr(config, f.name)
            if f.name == "dropout" and isinstance(v, float):
                if v != float(rate):
                    changes[f.name] = float(rate)
            elif dataclasses.is_dataclass(v):
                nv = DropoutScheduler.apply_to_config(v, rate)
                if nv is not v:
                    changes[f.name] = nv
        return dataclasses.replace(config, **changes) if changes else config

    @staticmethod
    def apply_to_model(model: torch.nn.Module, rate: float
                       ) -> torch.nn.Module:
        """Set the rates of a live model (one built from a ``config``) to
        those of ``apply_to_config(model.config, rate)``, in place: the
        parameters, and so the optimizer's references, stay. The rates
        are read off a copy of the module tree built from the new config
        on the meta device (no memory), so every module gets the rate
        the JAX package's rebuilt module has, and no other (the MoE
        experts' 0.1 of ``ExpertConfig`` is not a model-config field and
        stays)."""
        new_cfg = DropoutScheduler.apply_to_config(model.config, rate)
        if new_cfg is model.config:
            return model
        with torch.device("meta"):
            fresh = type(model)(new_cfg)
        live = dict(model.named_modules())
        for name, mod in fresh.named_modules():
            for attr in ("config", "dropout", "dropout_rate"):
                if attr in vars(mod):
                    setattr(live[name], attr, vars(mod)[attr])
        return model


def normalize_pixels_on_device(pixels: torch.Tensor,
                               mean: Sequence[float] = CLIP_MEAN,
                               std: Sequence[float] = CLIP_STD
                               ) -> torch.Tensor:
    """Device half of the u8 wire format: uint8 0..255 -> normalized
    float32 on the tensor's device, from batches of
    ``ImageAugmentation(normalize=False)``. Float inputs pass through
    unchanged, so call sites work with either wire format."""
    if pixels.dtype != torch.uint8:
        return pixels
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=pixels.device)
    std = torch.as_tensor(np.asarray(std, np.float32), device=pixels.device)
    return (pixels.to(torch.float32) / 255.0 - mean) / std
