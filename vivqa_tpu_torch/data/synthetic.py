"""Synthetic ViVQA-style dataset generator: a copy of
vivqa_tpu/data/synthetic.py (the port imports nothing of the JAX
package), for tests, demos and the card's smoke run without downloads."""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import List, Tuple

import numpy as np

from vivqa_tpu_torch.data.schema import OneSample

_COLORS = ["đỏ", "xanh", "vàng", "trắng", "đen"]
_OBJECTS = ["con mèo", "con chó", "quả táo", "cái bàn", "chiếc xe"]
_COUNTS = ["một", "hai", "ba", "bốn", "năm"]

_TEMPLATES = [
    ("{obj} màu gì?", "màu {color}"),
    ("có bao nhiêu {obj}?", "{count}"),
    ("trong ảnh có gì?", "{obj}"),
    ("đây có phải {obj} không?", "phải"),
]

# compositional sequence answers for the GENERATIVE convergence bench:
# the 4-6 token answer composes all three visual codes, so the decoder
# must emit a multi-token sequence conditioned on the image (not just
# pick a class) — VERDICT r2 #1 "extend the corpus to sequence answers"
_SEQ_TEMPLATES = [
    ("hãy mô tả bức ảnh", "có {count} {obj} màu {color}"),
    ("ảnh này chụp gì vậy?", "{count} {obj} trên nền màu {color}"),
]


_COLOR_RGB = {"đỏ": (200, 40, 40), "xanh": (40, 80, 200),
              "vàng": (220, 200, 40), "trắng": (230, 230, 230),
              "đen": (25, 25, 25)}


# object hues: saturated mixes disjoint from the background palette, so
# "màu gì" (background) and "có gì" (object band) stay separable signals
_OBJECT_RGB = {"con mèo": (230, 40, 230),    # magenta
               "con chó": (40, 220, 220),    # cyan
               "quả táo": (240, 130, 20),    # orange
               "cái bàn": (130, 40, 220),    # purple
               "chiếc xe": (20, 160, 90)}    # teal


def _render_scene(image_size: int, color: str, obj: str, count: str,
                  rng_img: np.random.RandomState) -> np.ndarray:
    """Image that ENCODES the answers, redundantly and robustly:
      background (top 2/3)  = the color answer
      bottom-third band     = the object answer (distinct hue)
      count                 = bright blocks AND a bar of width ~ count
    Every code is a coarse global feature that survives the photometric
    and flip augmentations — the bench must prove the TRAINING STACK
    learns a multimodal mapping (answers are unrecoverable from the
    question alone), not pose a hard fine-grained vision task."""
    arr = np.zeros((image_size, image_size, 3), np.float32)
    arr[:] = _COLOR_RGB[color]
    # object hue fills the bottom third
    arr[2 * image_size // 3:, :] = _OBJECT_RGB[obj]
    # count: discrete bright blocks along the top...
    k = _COUNTS.index(count) + 1
    bw = max(image_size // 8, 2)
    for b in range(k):
        x0 = b * (bw + 2)
        if x0 + bw <= image_size:
            arr[2:2 + bw, x0:x0 + bw] = 255.0
    # ...plus a dark bar whose WIDTH is proportional to the count
    # (redundant global geometry; flip only mirrors it)
    yb = image_size // 2
    arr[yb:yb + max(image_size // 10, 2), : (k * image_size) // 6] = 10.0
    noise = rng_img.randn(image_size, image_size, 3) * 8.0
    return np.clip(arr + noise, 0, 255).astype(np.uint8)


def generate_synthetic_vivqa(out_dir: str | Path, n: int = 64,
                             image_size: int = 64, seed: int = 0,
                             learnable: bool = False,
                             seq_answers: bool = False) -> Tuple[Path, Path]:
    """Write images/ + data.csv (image_link,question,answers). Returns
    (csv_path, image_dir). With ``learnable=True`` the image content
    determines the answers (see _render_scene) — used by the
    convergence benchmark. ``seq_answers=True`` additionally mixes in
    the compositional multi-token templates (_SEQ_TEMPLATES) so the
    GENERATIVE decoder has real sequences to learn."""
    from PIL import Image
    rng = random.Random(seed)
    out = Path(out_dir)
    img_dir = out / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    templates = _TEMPLATES + (_SEQ_TEMPLATES * 2 if seq_answers else [])
    rows = []
    for i in range(n):
        color = rng.choice(_COLORS)
        obj = rng.choice(_OBJECTS)
        count = rng.choice(_COUNTS)
        tq, ta = rng.choice(templates)
        q = tq.format(obj=obj, color=color, count=count)
        a = ta.format(obj=obj, color=color, count=count)
        rs = np.random.RandomState(seed + i)
        if learnable:
            arr = _render_scene(image_size, color, obj, count, rs)
        else:
            arr = (rs.rand(image_size, image_size, 3) * 255).astype(np.uint8)
        name = f"img_{i:05d}.jpg"
        Image.fromarray(arr).save(img_dir / name, quality=95)
        if learnable:
            answers = [a]
        else:
            answers = [a] * rng.randint(1, 3) + ([rng.choice(_COLORS)]
                                                 if rng.random() < 0.3 else [])
        rows.append((name, q, answers))
    csv_path = out / "data.csv"
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("image_link,question,answers\n")
        for name, q, answers in rows:
            f.write(f'{name},"{q}","{answers}"\n')
    with open(out / "manifest.json", "w", encoding="utf-8") as f:
        json.dump({"n": n, "image_size": image_size, "seed": seed,
                   "learnable": learnable, "seq_answers": seq_answers}, f)
    return csv_path, img_dir


def ensure_synthetic_vivqa(out_dir: str | Path, n: int = 64,
                           image_size: int = 64, seed: int = 0,
                           learnable: bool = False,
                           seq_answers: bool = False) -> Tuple[Path, Path]:
    """Reuse-or-generate wrapper around :func:`generate_synthetic_vivqa`
    for benches that cache the rendered corpus across chunked runs
    (224^2 rendering costs minutes on a 1-core host).

    Reuse is only valid when the cached corpus was generated with the
    SAME parameters — a stale cache from a different config (e.g. a
    64x64 demo corpus silently resized to 224) would corrupt the
    measurement without warning. The generator writes ``manifest.json``
    alongside ``data.csv``; this checks it and raises on mismatch
    instead of silently reusing. A pre-manifest cache is grandfathered
    iff its row count and image dimensions verify against the request
    (then the manifest is written for next time)."""
    out = Path(out_dir)
    csv_path, img_dir = out / "data.csv", out / "images"
    want = {"n": n, "image_size": image_size, "seed": seed,
            "learnable": learnable, "seq_answers": seq_answers}
    if not csv_path.exists():
        return generate_synthetic_vivqa(out_dir, n=n, image_size=image_size,
                                        seed=seed, learnable=learnable,
                                        seq_answers=seq_answers)
    mpath = out / "manifest.json"
    if mpath.exists():
        with open(mpath, encoding="utf-8") as f:
            have = json.load(f)
        if have != want:
            raise ValueError(
                f"cached corpus at {out} was generated with {have}, but "
                f"{want} was requested — clear the directory or point the "
                "corpus-dir env var elsewhere")
        return csv_path, img_dir
    # pre-manifest cache: verify the cheap invariants, then stamp it
    with open(csv_path, encoding="utf-8") as f:
        rows = sum(1 for _ in f) - 1
    from PIL import Image
    with Image.open(img_dir / "img_00000.jpg") as im:
        w, h = im.size
    if rows != n or (w, h) != (image_size, image_size):
        raise ValueError(
            f"cached corpus at {out} has {rows} rows of {w}x{h} images, "
            f"but n={n} image_size={image_size} was requested (no manifest "
            "to confirm seed/flags) — clear the directory or fix the env")
    with open(mpath, "w", encoding="utf-8") as f:
        json.dump(want, f)
    return csv_path, img_dir


def synthetic_samples(n: int = 32, seed: int = 0) -> List[OneSample]:
    """In-memory samples with array 'paths' (the augmentation pipeline
    falls back to a black placeholder for missing files, so any string
    works when images aren't needed)."""
    rng = random.Random(seed)
    samples = []
    for i in range(n):
        color = rng.choice(_COLORS)
        obj = rng.choice(_OBJECTS)
        count = rng.choice(_COUNTS)
        tq, ta = rng.choice(_TEMPLATES)
        samples.append(OneSample(
            image_path=f"missing_{i}.jpg",
            question=tq.format(obj=obj, color=color, count=count),
            answers=[ta.format(obj=obj, color=color, count=count)]))
    return samples
