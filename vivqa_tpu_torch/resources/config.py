"""Resource management configuration (counterpart of
vivqa_tpu/resources/config.py; reference:
src/resource_management/resource_config.py:37-359)."""

from __future__ import annotations

import dataclasses

from vivqa_tpu_torch.config.base import ConfigBase

THRESHOLD_ACTIONS = ("warn_only", "backup", "backup_and_shutdown")


@dataclasses.dataclass(frozen=True)
class ResourceThresholds(ConfigBase):
    cpu_warning: float = 80.0
    cpu_critical: float = 95.0
    memory_warning: float = 70.0
    memory_critical: float = 90.0
    disk_warning: float = 85.0
    disk_critical: float = 95.0
    device_memory_warning: float = 85.0     # the card's memory %
    device_memory_critical: float = 95.0


@dataclasses.dataclass(frozen=True)
class MonitoringIntervals(ConfigBase):
    cpu_seconds: float = 5.0
    memory_seconds: float = 5.0
    disk_seconds: float = 30.0
    device_seconds: float = 10.0
    aggregate_seconds: float = 10.0


@dataclasses.dataclass(frozen=True)
class BackupConfig(ConfigBase):
    emergency_dir: str = "emergency_backups"
    max_backups: int = 3
    min_interval_seconds: float = 60.0       # throttle emergency saves


@dataclasses.dataclass(frozen=True)
class ReportIntervalConfig(ConfigBase):
    auto_save_seconds: float = 1800.0        # 30 min (reference default)
    report_dir: str = "resource_reports"


@dataclasses.dataclass(frozen=True)
class ResourceConfig(ConfigBase):
    thresholds: ResourceThresholds = dataclasses.field(
        default_factory=ResourceThresholds)
    intervals: MonitoringIntervals = dataclasses.field(
        default_factory=MonitoringIntervals)
    backup: BackupConfig = dataclasses.field(default_factory=BackupConfig)
    report: ReportIntervalConfig = dataclasses.field(
        default_factory=ReportIntervalConfig)
    threshold_action: str = "backup"         # THRESHOLD_ACTIONS
    history_size: int = 720
    enable_signal_handlers: bool = True
