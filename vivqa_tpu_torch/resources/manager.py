"""ResourceManager facade + module singleton (counterpart of
vivqa_tpu/resources/manager.py).

Counterpart of src/resource_management/resource_manager.py:61-894 in the
reference: wires monitors + backup + progress + reports, SIGINT/SIGTERM +
atexit emergency state save, training-lifecycle API
(start_training/start_epoch/update_training_step/end_epoch/
complete_training/fail_training), critical/warning queries, context
manager, and `resource_managed_training` helper.
"""

from __future__ import annotations

import atexit
import signal
import threading
from contextlib import contextmanager
from typing import Callable, Optional

from vivqa_tpu_torch.resources.backup import AutoBackupTrigger, BackupHandler
from vivqa_tpu_torch.resources.config import ResourceConfig
from vivqa_tpu_torch.resources.monitor import ResourceMonitor
from vivqa_tpu_torch.resources.progress import TrainingProgressTracker
from vivqa_tpu_torch.resources.reports import ReportManager
from vivqa_tpu_torch.utils import get_pipeline_logger


class ResourceManager:
    def __init__(self, config: Optional[ResourceConfig] = None, logger=None):
        self.config = config or ResourceConfig()
        self.log = logger or get_pipeline_logger()
        self.monitor = ResourceMonitor(self.config)
        self.backup = BackupHandler(self.config.backup, self.log)
        self.trigger = AutoBackupTrigger(
            self.backup, self.config.threshold_action,
            self.config.backup.min_interval_seconds, self.log)
        self.monitor.add_callback(self.trigger.on_resource_alert)
        self.progress = TrainingProgressTracker()
        self.reports = ReportManager(
            self.monitor, self.progress,
            self.config.report.report_dir,
            self.config.report.auto_save_seconds, self.log)
        self._running = False
        self._signals_installed = False

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self.monitor.start()
        self.reports.start_auto_save()
        if self.config.enable_signal_handlers:
            self._install_signal_handlers()
        self._running = True
        self.log.success("resource manager started "
                         f"(action={self.config.threshold_action})")

    def stop(self) -> None:
        if not self._running:
            return
        self.monitor.stop()
        self.reports.stop_auto_save()
        self._running = False
        self.log.success("resource manager stopped")

    def _install_signal_handlers(self) -> None:
        if self._signals_installed or \
                threading.current_thread() is not threading.main_thread():
            return

        def handler(signum, frame):
            self.log.warning(f"signal {signum} — emergency backup")
            self.backup.create_backup(reason=f"signal_{signum}")
            raise KeyboardInterrupt

        try:
            signal.signal(signal.SIGTERM, handler)
            atexit.register(self._atexit_save)
            self._signals_installed = True
        except (ValueError, OSError):
            pass

    def _atexit_save(self) -> None:
        if self._running:
            try:
                self.reports.save(self.reports.emergency_report("atexit"))
            except Exception:
                pass

    # -- model registration ------------------------------------------------------
    def register_model(self, name: str, provider: Callable) -> None:
        """provider() -> pytree to persist on emergencies."""
        self.backup.register_state_provider(name, provider)

    # -- training lifecycle -------------------------------------------------------
    def start_training(self, num_epochs: int, steps_per_epoch: int) -> None:
        self.progress.create_training_task(num_epochs, steps_per_epoch)

    def start_epoch(self, epoch: int) -> None:
        self.progress.start_epoch(epoch)

    def update_training_step(self, epoch: int, step: int, **metrics) -> None:
        self.progress.update_training_step(epoch, step, **metrics)

    def end_epoch(self, epoch: int, metric: Optional[float] = None) -> None:
        self.progress.end_epoch(epoch, metric)

    def complete_training(self) -> None:
        self.progress.complete("training")

    def fail_training(self, error: str = "") -> None:
        self.progress.fail("training", error)
        self.backup.create_backup(reason="training_failure")

    # -- queries -----------------------------------------------------------------
    def is_resource_critical(self) -> bool:
        return self.monitor.is_critical()

    def should_shutdown(self) -> bool:
        return self.trigger.shutdown_requested.is_set()

    def get_active_alerts(self):
        return list(self.monitor.active_alerts)

    def get_status_summary(self) -> dict:
        return {"running": self._running,
                "resources": self.monitor.snapshot(),
                "alerts": len(self.monitor.active_alerts),
                "tasks": self.progress.summary(),
                "shutdown_requested": self.should_shutdown()}

    # -- context manager -----------------------------------------------------------
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.fail_training(str(exc))
        self.stop()
        return False


_SINGLETON: Optional[ResourceManager] = None


def get_resource_manager(config: Optional[ResourceConfig] = None,
                         reset: bool = False) -> ResourceManager:
    global _SINGLETON
    if _SINGLETON is None or reset:
        _SINGLETON = ResourceManager(config)
    return _SINGLETON


@contextmanager
def resource_managed_training(config: Optional[ResourceConfig] = None):
    """Context manager wrapping a training run (reference :894)."""
    rm = get_resource_manager(config)
    rm.start()
    try:
        yield rm
        rm.complete_training()
    except Exception as e:
        rm.fail_training(str(e))
        raise
    finally:
        rm.stop()
