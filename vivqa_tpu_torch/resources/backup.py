"""Emergency backup trigger (counterpart of vivqa_tpu/resources/backup.py).

Counterpart of src/resource_management/backup_handler.py:39-829 in the
reference: register state providers, build a backup on demand, rotate,
and auto-trigger throttled emergency saves on critical alerts — with the
`backup_and_shutdown` action initiating graceful shutdown. Backups are
``torch.save`` files, one per provider (``<name>.pt``), as the port's
checkpoints are (the JAX package writes orbax saves).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from vivqa_tpu_torch.resources.config import BackupConfig
from vivqa_tpu_torch.resources.monitor import Alert
from vivqa_tpu_torch.train.checkpoint import to_host


class BackupHandler:
    def __init__(self, config: BackupConfig, logger=None):
        self.config = config
        self.log = logger
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self.backups: List[Path] = []

    def register_state_provider(self, name: str,
                                provider: Callable[[], Any]) -> None:
        """provider() -> pytree/dict to persist (e.g. lambda: state.params)."""
        self._providers[name] = provider

    def unregister(self, name: str) -> None:
        self._providers.pop(name, None)

    def create_backup(self, reason: str = "manual") -> Optional[Path]:
        if not self._providers:
            return None
        with self._lock:
            # microsecond suffix: backups triggered in the same second
            # (e.g. rapid alerts) must not collide — a duplicate path would
            # alias two entries in the rotation list
            stamp = time.strftime("%Y%m%d_%H%M%S") + f"_{time.time_ns() % 1_000_000:06d}"
            root = Path(self.config.emergency_dir) / f"backup_{stamp}"
            root.mkdir(parents=True, exist_ok=True)
            saved = {}
            for name, provider in self._providers.items():
                try:
                    torch.save(to_host(provider()), root / f"{name}.pt")
                    saved[name] = "ok"
                except Exception as e:  # keep going; save what we can
                    saved[name] = f"failed: {e}"
            (root / "backup_info.json").write_text(json.dumps({
                "reason": reason, "timestamp": stamp, "states": saved}))
            self.backups.append(root)
            self._rotate()
            if self.log:
                self.log.success(f"emergency backup at {root} ({reason})")
            return root

    def _rotate(self) -> None:
        import shutil
        while len(self.backups) > self.config.max_backups:
            victim = self.backups.pop(0)
            shutil.rmtree(victim, ignore_errors=True)

    def restore(self, backup_dir: str | Path, name: str,
                map_location="cpu"):
        """The object provider ``name`` gave to backup ``backup_dir``."""
        return torch.load(Path(backup_dir) / f"{name}.pt",
                          map_location=map_location, weights_only=False)


class AutoBackupTrigger:
    """On critical alert -> throttled emergency backup; under
    backup_and_shutdown also sets a shutdown flag the training loop can
    poll (reference :620-829)."""

    def __init__(self, handler: BackupHandler, action: str = "backup",
                 min_interval: float = 60.0, logger=None):
        self.handler = handler
        self.action = action
        self.min_interval = min_interval
        self.log = logger
        self._last_backup = 0.0
        self.shutdown_requested = threading.Event()

    def on_resource_alert(self, alert: Alert) -> None:
        if alert.level != "critical" or self.action == "warn_only":
            return
        now = time.time()
        if now - self._last_backup < self.min_interval:
            return
        self._last_backup = now
        self.handler.create_backup(reason=f"critical:{alert.resource}")
        if self.action == "backup_and_shutdown":
            if self.log:
                self.log.failure(f"critical {alert.resource} — requesting "
                                 "graceful shutdown")
            self.shutdown_requested.set()
