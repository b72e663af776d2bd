"""Raw data loading & splitting: a copy of vivqa_tpu/data/actions.py (the
port imports nothing of the JAX package).

Counterpart of src/data/data_actions.py in the reference:
- load_raw_data (:63-154): CSV with `image_link,question,answers` columns
  (answers is a Python-literal list string), plus a filename -> path map
  built from an image folder.
- split_data (:174-200): seeded shuffle + ratio slicing.

The reference's per-100-rows RAM guard is replaced by a single up-front
size check (pandas reads the CSV in one pass; the kill-switch lives in
the resource monitor)."""

from __future__ import annotations

import ast
import os
import random
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from vivqa_tpu_torch.data.schema import OneSample

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def build_image_index(image_dir: str | Path) -> Dict[str, str]:
    """Map basename (and stem) -> absolute path for every image under dir."""
    index: Dict[str, str] = {}
    for root, _, files in os.walk(image_dir):
        for f in files:
            if f.lower().endswith(IMAGE_EXTENSIONS):
                p = os.path.join(root, f)
                index[f] = p
                index[os.path.splitext(f)[0]] = p
    return index


def parse_answers(raw) -> List[str]:
    """Answers column may be a literal list string or a plain string
    (reference uses ast.literal_eval with fallback, data_actions.py:112)."""
    if isinstance(raw, list):
        return [str(a) for a in raw]
    s = str(raw).strip()
    if s.startswith("[") and s.endswith("]"):
        try:
            val = ast.literal_eval(s)
            if isinstance(val, (list, tuple)):
                return [str(a) for a in val]
        except (ValueError, SyntaxError):
            pass
    return [s]


def load_raw_data(csv_path: str | Path, image_dir: str | Path | None = None,
                  image_col: str = "image_link", question_col: str = "question",
                  answers_col: str = "answers",
                  max_samples: int | None = None) -> List[OneSample]:
    import pandas as pd
    df = pd.read_csv(csv_path)
    for col in (image_col, question_col, answers_col):
        if col not in df.columns:
            raise ValueError(f"CSV missing column '{col}' "
                             f"(has: {list(df.columns)})")
    index = build_image_index(image_dir) if image_dir else {}
    from vivqa_tpu_torch.utils.memory_guard import get_memory_guard
    guard = get_memory_guard()
    samples: List[OneSample] = []
    for _, row in df.iterrows():
        guard.check()  # warn/kill on runaway RAM (reference checks /100 rows)
        img = str(row[image_col])
        base = os.path.basename(img)
        path = index.get(base) or index.get(os.path.splitext(base)[0]) or img
        samples.append(OneSample(image_path=path,
                                 question=str(row[question_col]),
                                 answers=parse_answers(row[answers_col])))
        if max_samples and len(samples) >= max_samples:
            break
    return samples


def validate_samples(samples: Sequence[OneSample]) -> Tuple[List[OneSample], List[str]]:
    """Drop invalid samples, report problems (reference data_pipeline
    step 2, data_pipeline.py:210-260)."""
    good, problems = [], []
    for i, s in enumerate(samples):
        p = s.validate()
        if p:
            problems.append(f"sample {i}: {', '.join(p)}")
        else:
            good.append(s)
    return good, problems


def split_data(samples: Sequence[OneSample], train_ratio: float = 0.8,
               val_ratio: float = 0.1, seed: int = 42):
    """Seeded shuffle + ratio slicing (reference data_actions.py:174-200)."""
    assert 0 < train_ratio < 1 and train_ratio + val_ratio <= 1
    idx = list(range(len(samples)))
    random.Random(seed).shuffle(idx)
    n_train = int(len(samples) * train_ratio)
    n_val = int(len(samples) * val_ratio)
    train = [samples[i] for i in idx[:n_train]]
    val = [samples[i] for i in idx[n_train:n_train + n_val]]
    test = [samples[i] for i in idx[n_train + n_val:]]
    return train, val, test


def save_data(splits: Dict[str, Sequence[OneSample]],
              out_dir: str | Path, copy_images: bool = False) -> Dict[str, str]:
    """Persist split metadata (and optionally copy images into
    processed/<split>/) — reference save_data, data_actions.py:321-367."""
    import json
    import shutil
    out_dir = Path(out_dir)
    written = {}
    for split, samples in splits.items():
        split_dir = out_dir / split
        split_dir.mkdir(parents=True, exist_ok=True)
        records = []
        for s in samples:
            path = s.image_path
            if copy_images and os.path.isfile(s.image_path):
                dest = split_dir / "images" / os.path.basename(s.image_path)
                dest.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(s.image_path, dest)
                path = str(dest)
            records.append({"image_path": path, "question": s.question,
                            "answers": s.answers})
        meta = split_dir / "metadata.json"
        meta.write_text(json.dumps(records, ensure_ascii=False, indent=2))
        written[split] = str(meta)
    return written


def load_data_split(out_dir: str | Path, split: str,
                    start: int = 0, end: int | None = None) -> List[OneSample]:
    """RAM-frugal per-split loading by index range (reference
    load_data_split, data_actions.py:203-318)."""
    import json
    meta = Path(out_dir) / split / "metadata.json"
    records = json.loads(meta.read_text())[start:end]
    return [OneSample(image_path=r["image_path"], question=r["question"],
                      answers=list(r["answers"])) for r in records]


def data_statistics(samples: Sequence[OneSample]) -> Dict:
    """Corpus stats (reference data_pipeline step 3, :262-310)."""
    from collections import Counter
    q_lens = [len(s.question.split()) for s in samples]
    a_counter = Counter(a for s in samples for a in s.answers)
    return {
        "num_samples": len(samples),
        "question_len_mean": sum(q_lens) / max(len(q_lens), 1),
        "question_len_max": max(q_lens, default=0),
        "num_unique_answers": len(a_counter),
        "top_answers": a_counter.most_common(10),
    }
