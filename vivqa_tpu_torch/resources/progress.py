"""Progress tracking with ETA (counterpart of
vivqa_tpu/resources/progress.py; reference:
src/resource_management/progress_tracker.py:321-830)."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

TASK_STATUSES = ("pending", "running", "paused", "completed", "failed",
                 "cancelled")


@dataclasses.dataclass
class TaskInfo:
    task_id: str
    name: str
    total_steps: int
    current_step: int = 0
    status: str = "pending"
    started: Optional[float] = None
    finished: Optional[float] = None
    metadata: dict = dataclasses.field(default_factory=dict)

    @property
    def progress(self) -> float:
        return self.current_step / self.total_steps if self.total_steps else 0.0

    @property
    def eta_seconds(self) -> Optional[float]:
        if not self.started or self.current_step == 0 or \
                self.status != "running":
            return None
        elapsed = time.time() - self.started
        rate = self.current_step / elapsed
        return (self.total_steps - self.current_step) / rate if rate else None


class ProgressTracker:
    def __init__(self):
        self.tasks: Dict[str, TaskInfo] = {}
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[TaskInfo], None]] = []

    def add_callback(self, cb: Callable[[TaskInfo], None]) -> None:
        self._callbacks.append(cb)

    def _notify(self, task: TaskInfo) -> None:
        for cb in self._callbacks:
            try:
                cb(task)
            except Exception:
                pass

    def create_task(self, task_id: str, name: str,
                    total_steps: int, **metadata) -> TaskInfo:
        with self._lock:
            t = TaskInfo(task_id, name, total_steps, metadata=metadata)
            self.tasks[task_id] = t
        return t

    def start(self, task_id: str) -> None:
        self._set(task_id, status="running", started=time.time())

    def update(self, task_id: str, step: int, **metadata) -> None:
        with self._lock:
            t = self.tasks.get(task_id)
            if t:
                t.current_step = step
                t.metadata.update(metadata)
        if t:
            self._notify(t)

    def complete(self, task_id: str) -> None:
        self._set(task_id, status="completed", finished=time.time())

    def fail(self, task_id: str, error: str = "") -> None:
        self._set(task_id, status="failed", finished=time.time(),
                  error=error)

    def pause(self, task_id: str) -> None:
        self._set(task_id, status="paused")

    def resume(self, task_id: str) -> None:
        self._set(task_id, status="running")

    def cancel(self, task_id: str) -> None:
        self._set(task_id, status="cancelled", finished=time.time())

    def _set(self, task_id: str, **kwargs) -> None:
        with self._lock:
            t = self.tasks.get(task_id)
            if not t:
                return
            error = kwargs.pop("error", None)
            for k, v in kwargs.items():
                setattr(t, k, v)
            if error:
                t.metadata["error"] = error
        self._notify(t)

    def summary(self) -> Dict:
        with self._lock:
            return {tid: {"name": t.name, "status": t.status,
                          "progress": t.progress, "eta": t.eta_seconds}
                    for tid, t in self.tasks.items()}


class TrainingProgressTracker(ProgressTracker):
    """Training-specific lifecycle (reference :614-830)."""

    def __init__(self):
        super().__init__()
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def create_training_task(self, num_epochs: int,
                             steps_per_epoch: int) -> TaskInfo:
        self.num_epochs = num_epochs
        self.steps_per_epoch = steps_per_epoch
        return self.create_task("training", "training",
                                num_epochs * steps_per_epoch)

    def start_epoch(self, epoch: int) -> None:
        if epoch == 0:
            self.start("training")
        self.update("training", epoch * self.steps_per_epoch, epoch=epoch)

    def update_training_step(self, epoch: int, step: int,
                             **metrics) -> None:
        self.update("training", epoch * self.steps_per_epoch + step,
                    **metrics)

    def end_epoch(self, epoch: int, metric: Optional[float] = None) -> None:
        if metric is not None and (self.best_metric is None
                                   or metric > self.best_metric):
            self.best_metric = metric
            self.best_epoch = epoch
        self.update("training", (epoch + 1) * self.steps_per_epoch,
                    best_metric=self.best_metric, best_epoch=self.best_epoch)
