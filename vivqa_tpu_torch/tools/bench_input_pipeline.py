"""Host input-pipeline throughput: the PIL path against the native loader
(counterpart of tools/bench_input_pipeline.py).

    python3 -m vivqa_tpu_torch.tools.bench_input_pipeline [--n 256]
        [--size 224] [--batch 64] [--device cpu]

Images/s of the port's ``ImageAugmentation`` train and eval transforms
(medium strength, seed 0) over a corpus of ``--n`` smooth 640x480 JPEGs
made on the fly from ``RandomState(0)`` (the JAX tool's corpus): the PIL
path image by image, then the native loader (``data/fastloader.py``) a
batch at a time, NaN where its library is absent. Each batch then goes
to the device as a pipeline's does (``host_tensor``, one copy; nothing
on the CPU), inside the timed window. The host must keep up with the
train step: a step at batch B every t ms needs B / t images/ms. Prints
the JAX tool's lines, then one JSON line (null for NaN).
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from vivqa_tpu_torch.data import fastloader
from vivqa_tpu_torch.data.augmentation import ImageAugmentation
from vivqa_tpu_torch.data.loader import host_tensor
from vivqa_tpu_torch.device import card_line, resolve_device


def make_corpus(d: Path, n: int, hw=(480, 640)) -> list[str]:
    """``n`` smooth-ish synthetic photos (pure-noise JPEGs are
    unrealistically expensive to decode), as the JAX tool draws them."""
    from PIL import Image
    rng = np.random.RandomState(0)
    y = np.linspace(0, 1, hw[0])[:, None, None]
    x = np.linspace(0, 1, hw[1])[None, :, None]
    paths = []
    for i in range(n):
        base = 0.35 * y + 0.35 * x + 0.3 * rng.rand(1, 1, 3)
        img = np.clip(base + 0.08 * rng.rand(*hw, 3), 0, 1)
        p = d / f"img_{i:04d}.jpg"
        Image.fromarray((img * 255).astype(np.uint8)).save(p, quality=90)
        paths.append(str(p))
    return paths


def _to_device(arr: np.ndarray, device: torch.device) -> None:
    if device.type == "cuda":
        host_tensor(arr).to(device, non_blocking=True)


def bench(paths: list, size: int, batch: int, device: torch.device) -> dict:
    """{mode: {pil_images_per_s, native_images_per_s, speedup}}."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = {}
    for mode in ("train", "eval"):
        tf = ImageAugmentation(size, mode=mode, strength="medium", seed=0)
        t0 = time.perf_counter()
        for i in range(0, len(paths), batch):
            _to_device(np.stack([tf(p) for p in paths[i:i + batch]]), device)
        sync()
        dt_pil = time.perf_counter() - t0
        dt_nat = float("nan")
        if fastloader.is_available():
            t0 = time.perf_counter()
            for i in range(0, len(paths), batch):
                arr = tf.batch(paths[i:i + batch])
                if arr is None:
                    raise RuntimeError("the native loader refused a batch")
                _to_device(arr, device)
            sync()
            dt_nat = time.perf_counter() - t0
        out[mode] = {"pil_images_per_s": len(paths) / dt_pil,
                     "native_images_per_s": len(paths) / dt_nat,
                     "speedup": dt_pil / dt_nat}
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (no device copy)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory() as td:
        paths = make_corpus(Path(td), args.n)
        print(f"corpus: {args.n} x 640x480 JPEG -> {args.size}x{args.size}, "
              f"batch {args.batch}, native loader "
              f"{'present' if fastloader.is_available() else 'absent'}",
              flush=True)
        modes = bench(paths, args.size, args.batch, device)
    for mode, r in modes.items():
        print(f"  {mode:>5}: PIL {r['pil_images_per_s']:7.1f} img/s   "
              f"native {r['native_images_per_s']:7.1f} img/s   "
              f"speedup {r['speedup']:4.1f}x", flush=True)
    line = {"tool": "bench_input_pipeline",
            "device": torch.cuda.get_device_name(device) if on_card
            else "cpu", "card": card_line() if on_card else None,
            "n": args.n, "size": args.size, "batch": args.batch,
            "native_available": fastloader.is_available(),
            "modes": {m: {k: None if math.isnan(v) else v
                          for k, v in r.items()} for m, r in modes.items()}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
