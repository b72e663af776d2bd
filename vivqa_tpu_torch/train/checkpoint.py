"""Checkpointing (counterpart of vivqa_tpu/train/checkpoint.py), with
torch.save in place of orbax and the orbax manager's policy:

- one directory per step, ``<directory>/<step>/``, holding ``state.pt``
  (``torch.save`` of what the caller passes) and ``metadata.json`` (the
  caller's metadata plus a ``metrics`` entry), written under a temporary
  name and renamed into place when complete;
- a save at a step that is not past the latest kept one is refused
  (returns False);
- without ``keep_best`` the ``max_to_keep`` latest steps stay; with it,
  the ``max_to_keep`` best steps among those saved with metrics, ranked
  by ``best_metric`` (0.0 where a step's metrics lack it) under
  ``best_mode``, ties to the later step, and every step saved without
  metrics stays;
- ``best_step`` is the best kept step (the latest without ``keep_best``),
  and ``restore_best`` falls back to the latest step when there is none.

Nothing is held open between calls, so there is no ``close``; the JAX
config's ``save_interval_steps``, which its manager never reads, is left
out.

The JAX package's ``partial_load`` and ``emergency_save`` wait for the
port's classification pipeline and resource monitor (ROADMAP.md Queue A
items 10 and 12).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from vivqa_tpu_torch.config.base import ConfigBase

_STATE, _METADATA = "state.pt", "metadata.json"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig(ConfigBase):
    directory: str = "checkpoints"
    max_to_keep: int = 3
    keep_best: bool = True
    best_metric: str = "vqa_accuracy"     # metadata key to rank by
    best_mode: str = "max"                # max | min


class CheckpointManager:
    """Saves {state: torch.save'd object, metadata: json} per step."""

    def __init__(self, config: CheckpointConfig):
        if config.best_mode not in ("max", "min"):
            raise ValueError(f"unknown best_mode '{config.best_mode}'")
        self.config = config
        self.directory = Path(config.directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    def _metrics(self, step: int) -> Dict[str, float]:
        meta = json.loads((self._step_dir(step) / _METADATA).read_text())
        return meta.get("metrics") or {}

    def save(self, step: int, state, metadata: Optional[Dict[str, Any]] = None,
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """state: any object ``torch.save`` takes (e.g. {'params': {name:
        tensor}}); returns False, saving nothing, for a step not past the
        latest kept one."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        metadata = dict(metadata or {})
        metadata["metrics"] = {k: float(v) for k, v in (metrics or {}).items()}
        tmp = self.directory / f"{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / _STATE)
        (tmp / _METADATA).write_text(json.dumps(metadata, default=str))
        tmp.rename(self._step_dir(step))
        self._remove_old()
        return True

    def _ranked(self) -> list:
        """Steps saved with metrics, worst first (ties: earlier first)."""
        scored = [s for s in self.all_steps() if self._metrics(s)]
        return sorted(scored, key=lambda s: self._metrics(s).get(
            self.config.best_metric, 0.0),
            reverse=self.config.best_mode == "min")

    def _remove_old(self) -> None:
        keep = self.config.max_to_keep
        candidates = self._ranked() if self.config.keep_best \
            else self.all_steps()
        for step in candidates[:max(0, len(candidates) - keep)]:
            shutil.rmtree(self._step_dir(step))

    # -- queries ----------------------------------------------------------
    def all_steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if not self.config.keep_best:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    # -- loading ----------------------------------------------------------
    def restore(self, step: Optional[int] = None, map_location=None):
        """(state, metadata) of ``step`` (the latest by default);
        ``map_location`` as ``torch.load``'s."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints in {self.config.directory}")
        path = self._step_dir(step)
        state = torch.load(path / _STATE, map_location=map_location,
                           weights_only=True)
        return state, json.loads((path / _METADATA).read_text())

    def restore_best(self, map_location=None):
        step = self.best_step()
        if step is None:
            step = self.latest_step()
        return self.restore(step, map_location)
