"""Inference result accumulation & export: a copy of
vivqa_tpu/eval/result_manager.py (the port imports nothing of the JAX
package).

Counterpart of src/modeling/inference/result_manager.py:22-476 in the
reference: accumulate PredictionResults + metadata, export JSON/CSV/JSONL,
human-readable sample dump, summary statistics, reload.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


class InferenceResultManager:
    def __init__(self, metadata: Optional[Dict[str, Any]] = None):
        self.results: List[Dict[str, Any]] = []
        self.metadata = dict(metadata or {})
        self.metadata.setdefault("created", time.strftime("%Y-%m-%d %H:%M:%S"))

    def add(self, result, **extra) -> None:
        if dataclasses.is_dataclass(result):
            result = dataclasses.asdict(result)
        self.results.append({**result, **extra})

    def __len__(self):
        return len(self.results)

    # -- export -------------------------------------------------------------
    def save_json(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"metadata": self.metadata, "results": self.results},
            ensure_ascii=False, indent=2, default=str))
        return path

    def save_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for r in self.results:
                f.write(json.dumps(r, ensure_ascii=False, default=str) + "\n")
        return path

    def save_csv(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if not self.results:
            path.write_text("")
            return path
        keys = [k for k in self.results[0]
                if not isinstance(self.results[0][k], (list, dict))]
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            w.writeheader()
            for r in self.results:
                w.writerow({k: r.get(k) for k in keys})
        return path

    # -- reporting ------------------------------------------------------------
    def sample_dump(self, n: int = 5) -> str:
        lines = []
        for r in self.results[:n]:
            lines.append(f"Q: {r.get('question')}\n"
                         f"A: {r.get('answer')} "
                         f"(conf={r.get('confidence', 0):.3f})")
        return "\n---\n".join(lines)

    def summary(self) -> Dict[str, Any]:
        confs = [r.get("confidence", 0.0) for r in self.results]
        times = [r.get("inference_ms", 0.0) for r in self.results]
        return {
            "num_results": len(self.results),
            "mean_confidence": float(np.mean(confs)) if confs else 0.0,
            "mean_inference_ms": float(np.mean(times)) if times else 0.0,
            "p50_inference_ms": float(np.percentile(times, 50)) if times else 0.0,
            "p95_inference_ms": float(np.percentile(times, 95)) if times else 0.0,
        }

    @classmethod
    def load(cls, path: str | Path) -> "InferenceResultManager":
        data = json.loads(Path(path).read_text())
        mgr = cls(metadata=data.get("metadata"))
        mgr.results = data.get("results", [])
        return mgr
