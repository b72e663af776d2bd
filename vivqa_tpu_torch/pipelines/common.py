"""Shared pipeline utilities: early stopping, param counting, timing
(counterpart of vivqa_tpu/pipelines/common.py)."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from torch import nn


@dataclasses.dataclass
class EarlyStopping:
    """Patience-based early stopping (reference
    training_utils.py:192-268)."""
    patience: int = 5
    min_delta: float = 0.0
    mode: str = "max"
    best: Optional[float] = None
    counter: int = 0
    should_stop: bool = False

    def update(self, value: float) -> bool:
        improved = (self.best is None or
                    (value > self.best + self.min_delta if self.mode == "max"
                     else value < self.best - self.min_delta))
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return improved


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Parameter counts per top-level child module, as the JAX package
    counts per top-level key of its param tree (reference ModelPipeline
    step 6, model_pipeline.py:368-427)."""
    counts = {name: sum(p.numel() for p in child.parameters())
              for name, child in model.named_children()}
    counts.update({name: p.numel() for name, p in
                   model.named_parameters(recurse=False)})
    return {name: n for name, n in counts.items() if n}


class StepTimer:
    """Wall-clock per-step timing + throughput."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self.times = []

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, n_items: int = 1) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append((dt, n_items))
        return dt

    @property
    def items_per_sec(self) -> float:
        tot_t = sum(t for t, _ in self.times)
        tot_n = sum(n for _, n in self.times)
        return tot_n / tot_t if tot_t > 0 else 0.0
