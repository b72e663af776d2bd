"""Resource services (counterpart of vivqa_tpu/resources): CPU, memory,
disk and device-memory monitors with alerts, emergency backups,
progress with ETA, reports, and the ``ResourceManager`` facade."""

from vivqa_tpu_torch.resources.backup import AutoBackupTrigger, BackupHandler
from vivqa_tpu_torch.resources.config import (BackupConfig, MonitoringIntervals,
                                        ReportIntervalConfig, ResourceConfig,
                                        ResourceThresholds)
from vivqa_tpu_torch.resources.manager import (ResourceManager,
                                         get_resource_manager,
                                         resource_managed_training)
from vivqa_tpu_torch.resources.monitor import (Alert, BaseResourceMonitor,
                                         CPUMonitor, DeviceMemoryMonitor,
                                         DiskMonitor, MemoryMonitor,
                                         ResourceMonitor, ResourceSnapshot)
from vivqa_tpu_torch.resources.progress import (ProgressTracker, TaskInfo,
                                          TrainingProgressTracker)
from vivqa_tpu_torch.resources.reports import ReportManager, format_report

__all__ = [
    "ResourceConfig", "ResourceThresholds", "MonitoringIntervals",
    "BackupConfig", "ReportIntervalConfig",
    "ResourceMonitor", "BaseResourceMonitor", "CPUMonitor", "MemoryMonitor",
    "DiskMonitor", "DeviceMemoryMonitor", "Alert", "ResourceSnapshot",
    "BackupHandler", "AutoBackupTrigger",
    "ProgressTracker", "TrainingProgressTracker", "TaskInfo",
    "ReportManager", "format_report",
    "ResourceManager", "get_resource_manager", "resource_managed_training",
]
