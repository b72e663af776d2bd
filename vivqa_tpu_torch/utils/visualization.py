"""Dataset sample visualization (counterpart of
vivqa_tpu/utils/visualization.py; reference
src/utils/dataset_visualization.py — a matplotlib show_sample with
hardcoded demo paths; redesigned headless-first: Agg backend, explicit
save path, no module-level demo state, plus a grid helper). Images are
numpy arrays (H, W, 3), uint8 or floats in [0, 1] or [0, 255]; a torch
tensor on the CPU converts through ``np.asarray``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)  # headless-safe; no-op if set
    import matplotlib.pyplot as plt
    return plt


def show_sample(image: np.ndarray, question: str, answer,
                save_path: Optional[str | Path] = None,
                show: bool = False) -> Optional[Path]:
    """Render one (image, question, answer) sample; save to PNG if
    `save_path` is given (reference show_sample,
    dataset_visualization.py:12-26). Returns the saved path or None."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(np.asarray(image).astype(np.uint8)
              if np.asarray(image).dtype != np.uint8
              and np.asarray(image).max() > 1.5 else np.asarray(image))
    ax.axis("off")
    ax.set_title(f"Q: {question}\nA: {answer}", fontsize=9, wrap=True)
    out = None
    if save_path is not None:
        out = Path(save_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out, bbox_inches="tight", dpi=100)
    if show:                                       # pragma: no cover
        plt.show(block=True)
    plt.close(fig)
    return out


def show_batch(images: Sequence[np.ndarray], questions: Sequence[str],
               answers: Sequence, save_path: str | Path,
               ncols: int = 4) -> Path:
    """Grid of samples -> one PNG (no reference analogue; convenient for
    eyeballing a whole loader batch)."""
    plt = _plt()
    n = len(images)
    ncols = max(1, min(ncols, n))
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(3 * ncols, 3.2 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i >= n:
            continue
        img = np.asarray(images[i])
        ax.imshow(img.astype(np.uint8)
                  if img.dtype != np.uint8 and img.max() > 1.5 else img)
        ax.set_title(f"Q: {questions[i]}\nA: {answers[i]}", fontsize=7)
    out = Path(save_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out
