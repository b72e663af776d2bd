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

Nothing is held open between calls: ``close`` only marks the manager
closed, and a later ``save`` raises, as orbax's closed manager refuses
one. The JAX config's ``save_interval_steps``, which its manager never
reads, is left out.

On a mesh, ``gathered_params`` and ``gathered_optimizer_state`` give the
whole tensors of a placed state (every rank calls them: they gather the
shards over 'model'), and the main rank alone saves them, so a
checkpoint is the single-card format whatever mesh wrote it, and it
resumes on any mesh: load it into the unplaced model and optimizer, then
``place_state``, or into a placed model with ``pipelines.common.load_params``
given the state's sharding and mesh.

``partial_load`` merges a restored {name: tensor} dict into a model by
name and shape. ``emergency_save`` writes one state at once, outside any
manager's policy, into ``<directory>/emergency/`` (``state.pt`` and, with
metadata, ``metadata.json``), where ``restore_emergency`` reads it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

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
        self.closed = False

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    def _metrics(self, step: int) -> Dict[str, float]:
        meta = json.loads((self._step_dir(step) / _METADATA).read_text())
        return meta.get("metrics") or {}

    def save(self, step: int, state, metadata: Optional[Dict[str, Any]] = None,
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """state: any object ``torch.save`` takes (e.g. {'params': {name:
        tensor}}); returns False, saving nothing, for a step not past the
        latest kept one. Raises after ``close``."""
        if self.closed:
            raise RuntimeError(f"checkpoint manager of {self.directory} "
                               f"is closed")
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

    def close(self) -> None:
        """End the manager. ``torch.save`` holds nothing open, so this only
        refuses later saves; restoring still works."""
        self.closed = True


def partial_load(restored_params: Mapping[str, torch.Tensor],
                 model: nn.Module, logger=None):
    """Copy each restored parameter or buffer whose name and shape match
    one of ``model``'s into it, in place; one the checkpoint lacks keeps
    its value, a checkpoint entry the model lacks is ignored (reference
    strict/partial load, checkpoint_manager.py:403-492). Returns (model,
    the list of names skipped for a shape mismatch, each with both
    shapes)."""
    skipped = []
    with torch.no_grad():
        for name, p in itertools.chain(model.named_parameters(),
                                       model.named_buffers()):
            r = restored_params.get(name)
            if r is None:
                continue
            if tuple(r.shape) == tuple(p.shape):
                p.copy_(r)
            else:
                skipped.append(f"{name}: ckpt{tuple(r.shape)} != "
                               f"model{tuple(p.shape)}")
    if skipped and logger is not None:
        logger.warning("partial load skipped %d params: %s",
                       len(skipped), skipped[:5])
    return model, skipped


def to_host(tree):
    """Tensors (in dicts, lists and tuples) copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def emergency_save(state, directory: str | Path,
                   metadata: Optional[Dict[str, Any]] = None) -> Path:
    """One synchronous save for the resource monitor's critical path
    (reference BackupHandler emergency backup, backup_handler.py:620-735):
    ``state`` (e.g. a train state's ``{"params", "optimizer", "step"}``)
    copied to the host and ``torch.save``'d, replacing any earlier one.
    Returns the emergency directory."""
    path = Path(directory).absolute() / "emergency"
    path.mkdir(parents=True, exist_ok=True)
    torch.save(to_host(state), path / _STATE)
    if metadata:
        (path / _METADATA).write_text(json.dumps(metadata, default=str))
    return path


def restore_emergency(path: str | Path, map_location=None):
    """(state, metadata or {}) of an ``emergency_save`` directory."""
    path = Path(path)
    state = torch.load(path / _STATE, map_location=map_location,
                       weights_only=True)
    meta = path / _METADATA
    return state, json.loads(meta.read_text()) if meta.exists() else {}


def gathered_params(model: nn.Module, sharding=None, mesh=None) -> dict:
    """{name: whole parameter on the host}; ``sharding`` and ``mesh`` are
    a placed state's (``TrainState.sharding``, ``.mesh``), None for a
    state on one device."""
    from vivqa_tpu_torch.parallel.mesh import Placement, full_tensor
    out = {}
    for n, p in model.named_parameters():
        pl = sharding.placements.get(n, Placement()) if sharding \
            else Placement()
        out[n] = full_tensor(p.detach(), pl, mesh).cpu()
    return out


def model_buffers(model: nn.Module) -> dict:
    """{name: buffer on the host} of the buffers ``model.state_dict()``
    holds (a router's correction bias, say); they are whole on every
    rank."""
    params = dict(model.named_parameters())
    return {n: t.detach().cpu() for n, t in model.state_dict().items()
            if n not in params}


def gathered_optimizer_state(optimizer, sharding=None, mesh=None) -> dict:
    """``optimizer.state_dict()`` with each split parameter's state
    whole, on the host (each field gathered where
    ``optimizer.state_placement`` says it is split)."""
    from vivqa_tpu_torch.parallel.mesh import Placement, full_tensor
    sd = optimizer.state_dict()

    def whole(field: str, by_name: dict) -> dict:
        return {n: full_tensor(t, optimizer.state_placement(field, n)
                               if sharding else Placement(), mesh).cpu()
                for n, t in by_name.items()}
    out = dict(sd, acc=whole("acc", sd["acc"]),
               state={f: whole(f, ts) for f, ts in sd["state"].items()})
    if "slow" in sd:
        out["slow"] = whole("slow", sd["slow"])
    return out
