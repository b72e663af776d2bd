"""Metric framework: MetricResult / BaseMetric / MetricCollection, a copy
of vivqa_tpu/metrics/base.py (reference:
src/solvers/metrics/vqa_metrics.py:16-72,:1150-1234).

Metrics are host-side accumulators (update per batch with numpy/python
values read off the device, compute at the end); device work stays in
the train and generate steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class MetricResult:
    value: float
    per_class: Optional[Dict[Any, float]] = None
    per_sample: Optional[List[float]] = None
    metadata: Optional[Dict[str, Any]] = None


class BaseMetric:
    name: str = "metric"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        raise NotImplementedError

    def update(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def compute(self) -> MetricResult:
        raise NotImplementedError


class MetricCollection:
    """Bundle of metrics sharing update calls; update routes kwargs to
    each metric's signature."""

    def __init__(self, metrics: Dict[str, BaseMetric]):
        self.metrics = metrics

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()

    def update(self, **kwargs) -> None:
        import inspect
        for m in self.metrics.values():
            sig = inspect.signature(m.update)
            accepted = {k: v for k, v in kwargs.items() if k in sig.parameters}
            try:
                m.update(**accepted)
            except TypeError:
                pass  # metric doesn't apply to this batch type

    def compute(self) -> Dict[str, MetricResult]:
        return {name: m.compute() for name, m in self.metrics.items()}

    def compute_values(self) -> Dict[str, float]:
        return {name: r.value for name, r in self.compute().items()}
