"""Structured console + file logger used across all pipelines: a copy of
vivqa_tpu/utils/logger.py (reference: src/core/pipeline_logger.py:
27-405): section banners, status glyphs, key/value + ASCII tables, domain
helpers (data sample, model architecture, batch sample, metrics,
checkpoint), stage timing, and a run-stats JSON dump; a single class
with a small formatting core; stage timings feed the JSON stats file
directly.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Mapping, Sequence


_GLYPH_OK = "[ok]"
_GLYPH_FAIL = "[fail]"
_GLYPH_WARN = "[warn]"


class PipelineLogger:
    """Console + optional file logger with banners, tables, and stage timing."""

    def __init__(
        self,
        name: str = "vivqa",
        log_dir: str | Path | None = None,
        level: int = logging.INFO,
        console: bool = True,
    ):
        self.name = name
        self._logger = logging.getLogger(f"vivqa_tpu_torch.{name}")
        self._logger.setLevel(level)
        self._logger.propagate = False
        # Reset handlers so repeated construction (tests, ablation reruns)
        # doesn't duplicate output.
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
        fmt = logging.Formatter("%(asctime)s | %(levelname)-7s | %(message)s",
                                datefmt="%H:%M:%S")
        if console:
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(fmt)
            self._logger.addHandler(sh)
        self.log_file: Path | None = None
        if log_dir is not None:
            log_dir = Path(log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            self.log_file = log_dir / f"{name}_{time.strftime('%Y%m%d_%H%M%S')}.log"
            fh = logging.FileHandler(self.log_file)
            fh.setFormatter(fmt)
            self._logger.addHandler(fh)

        self._stage_starts: dict[str, float] = {}
        self.stats: dict[str, Any] = {"stages": {}, "events": []}

    # ----- basic levels -------------------------------------------------
    def info(self, msg: str, *args: Any) -> None:
        self._logger.info(msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self._logger.warning("%s %s" % (_GLYPH_WARN, msg), *args)

    def error(self, msg: str, *args: Any) -> None:
        self._logger.error(msg, *args)

    def debug(self, msg: str, *args: Any) -> None:
        self._logger.debug(msg, *args)

    # ----- banners & status ----------------------------------------------
    def section(self, title: str, width: int = 72) -> None:
        bar = "=" * width
        self.info(bar)
        self.info(f"  {title}")
        self.info(bar)

    def subsection(self, title: str, width: int = 72) -> None:
        self.info("-" * width)
        self.info(f"  {title}")
        self.info("-" * width)

    def success(self, msg: str) -> None:
        self.info(f"{_GLYPH_OK} {msg}")

    def failure(self, msg: str) -> None:
        self.error(f"{_GLYPH_FAIL} {msg}")

    def key_value(self, key: str, value: Any, indent: int = 2) -> None:
        self.info(f"{' ' * indent}{key:<32} {value}")

    def table(self, headers: Sequence[str], rows: Sequence[Sequence[Any]]) -> None:
        cols = [
            max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
            for i, h in enumerate(headers)
        ]
        def fmt(row: Sequence[Any]) -> str:
            return " | ".join(str(c).ljust(w) for c, w in zip(row, cols))
        self.info(fmt(headers))
        self.info("-+-".join("-" * w for w in cols))
        for r in rows:
            self.info(fmt(r))

    # ----- domain helpers -------------------------------------------------
    def log_data_sample(self, sample: Mapping[str, Any], index: int = 0) -> None:
        self.subsection(f"Data sample #{index}")
        for k, v in sample.items():
            sv = str(v)
            self.key_value(k, sv if len(sv) <= 120 else sv[:117] + "...")

    def log_model_architecture(self, name: str, param_counts: Mapping[str, int]) -> None:
        self.subsection(f"Model architecture: {name}")
        total = sum(param_counts.values())
        rows = [(k, f"{v:,}", f"{100.0 * v / max(total, 1):.1f}%")
                for k, v in sorted(param_counts.items(), key=lambda kv: -kv[1])]
        self.table(("module", "params", "share"), rows)
        self.key_value("total", f"{total:,}")

    def log_batch_sample(self, batch: Mapping[str, Any]) -> None:
        self.subsection("Batch sample")
        for k, v in batch.items():
            shape = getattr(v, "shape", None)
            dtype = getattr(v, "dtype", None)
            if shape is not None:
                self.key_value(k, f"shape={tuple(shape)} dtype={dtype}")
            else:
                self.key_value(k, type(v).__name__)

    def log_metrics(self, metrics: Mapping[str, float], prefix: str = "") -> None:
        for k, v in metrics.items():
            try:
                self.key_value(f"{prefix}{k}", f"{float(v):.6f}")
            except (TypeError, ValueError):
                self.key_value(f"{prefix}{k}", v)

    def log_checkpoint(self, path: str | Path, step: int, metric: float | None = None) -> None:
        extra = f" (metric={metric:.4f})" if metric is not None else ""
        self.success(f"checkpoint saved: {path} @ step {step}{extra}")

    # ----- stage timing -----------------------------------------------------
    def start_stage(self, stage: str) -> None:
        self._stage_starts[stage] = time.perf_counter()
        self.section(f"STAGE: {stage}")

    def end_stage(self, stage: str) -> float:
        t0 = self._stage_starts.pop(stage, None)
        dt = (time.perf_counter() - t0) if t0 is not None else 0.0
        self.stats["stages"][stage] = {"seconds": dt}
        self.success(f"stage '{stage}' finished in {dt:.2f}s")
        return dt

    def record_event(self, name: str, **payload: Any) -> None:
        self.stats["events"].append({"name": name, "time": time.time(), **payload})

    def save_stats(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.stats, indent=2, default=str))
        self.success(f"run stats saved to {path}")


_SINGLETON: PipelineLogger | None = None


def get_pipeline_logger(reset: bool = False, **kwargs: Any) -> PipelineLogger:
    """Module-level singleton (reference: pipeline_logger.py:384)."""
    global _SINGLETON
    if _SINGLETON is None or reset:
        _SINGLETON = PipelineLogger(**kwargs)
    return _SINGLETON
