"""``vivqa_tpu_torch/resources`` and ``train/checkpoint.emergency_save``:
the JAX package's resource tests (tests/test_resources.py) over the
port's copies, with torch tensors where those hold jax arrays, plus the
port's own: the same ``__all__`` and defaults as the JAX package, the
device monitor (0 on a host without CUDA, as JAX reports on a host
without memory stats) and the emergency save read back. Every thread
started here is stopped within its test; no test sleeps a second."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import vivqa_tpu.resources as JR
import vivqa_tpu_torch.resources as PR
from vivqa_tpu_torch.resources import (Alert, AutoBackupTrigger, BackupConfig,
                                 BackupHandler, CPUMonitor, MemoryMonitor,
                                 ProgressTracker, ReportManager,
                                 ResourceConfig, ResourceManager,
                                 ResourceMonitor, ResourceThresholds,
                                 TrainingProgressTracker, format_report,
                                 resource_managed_training)


def test_memory_monitor_sample_and_stats():
    m = MemoryMonitor(interval=0.05, warning=200, critical=300)
    snap = m.poll_once()
    assert snap.resource == "memory" and 0 <= snap.percent <= 100
    assert "total_gb" in snap.detail
    stats = m.stats()
    assert stats["n"] == 1


def test_monitor_thread_and_alerts():
    alerts = []
    # warning threshold at 0% -> every sample alerts
    m = CPUMonitor(interval=0.05, warning=0.0, critical=200.0,
                   on_alert=alerts.append)
    m.start()
    time.sleep(0.3)
    m.stop()
    assert len(m.history) >= 2
    assert alerts and alerts[0].level == "warning"


def test_resource_monitor_aggregate():
    # thresholds above 100% so a fully loaded CI machine can't trip them
    cfg = ResourceConfig(thresholds=ResourceThresholds(
        cpu_critical=200.0, memory_critical=200.0, disk_critical=200.0,
        device_memory_critical=200.0))
    rm = ResourceMonitor(cfg)
    snap = rm.snapshot()
    assert "memory" in snap and "cpu" in snap
    assert not rm.is_critical()


def test_backup_handler_and_rotation(tmp_path):
    h = BackupHandler(BackupConfig(emergency_dir=str(tmp_path), max_backups=2))
    h.register_state_provider("model", lambda: {"w": torch.ones(3)})
    paths = [h.create_backup(f"r{i}") for i in range(3)]
    assert all(p is not None for p in paths)
    assert len(h.backups) == 2                       # rotated
    assert not paths[0].exists()                     # oldest removed
    restored = h.restore(paths[-1], "model")
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.ones(3))


def test_auto_backup_trigger_throttle_and_shutdown(tmp_path):
    h = BackupHandler(BackupConfig(emergency_dir=str(tmp_path)))
    h.register_state_provider("m", lambda: {"x": torch.zeros(1)})
    t = AutoBackupTrigger(h, action="backup_and_shutdown", min_interval=100)
    a = Alert("memory", "critical", 95.0, time.time(), "mem high")
    t.on_resource_alert(a)
    assert len(h.backups) == 1
    assert t.shutdown_requested.is_set()
    t.on_resource_alert(a)                            # throttled
    assert len(h.backups) == 1
    # warnings don't trigger
    t2 = AutoBackupTrigger(h, action="backup", min_interval=0)
    t2.on_resource_alert(Alert("cpu", "warning", 85.0, time.time(), ""))
    assert len(h.backups) == 1


def test_progress_tracker_eta():
    p = ProgressTracker()
    p.create_task("t", "test", 100)
    p.start("t")
    p.update("t", 50)
    info = p.tasks["t"]
    assert info.progress == 0.5
    assert info.eta_seconds is not None
    p.complete("t")
    assert p.tasks["t"].status == "completed"
    assert p.summary()["t"]["status"] == "completed"


def test_training_progress_best_metric():
    t = TrainingProgressTracker()
    t.create_training_task(3, 10)
    t.start_epoch(0)
    t.update_training_step(0, 5, loss=1.0)
    t.end_epoch(0, metric=0.5)
    t.end_epoch(1, metric=0.7)
    t.end_epoch(2, metric=0.6)
    assert t.best_metric == 0.7 and t.best_epoch == 1


def test_report_formats(tmp_path):
    rm = ResourceMonitor(ResourceConfig())
    rep = ReportManager(rm, report_dir=str(tmp_path))
    data = rep.resource_report()
    for fmt in ("json", "yaml", "csv", "text"):
        s = format_report(data, fmt)
        assert "memory" in s
    with pytest.raises(ValueError):
        format_report(data, "xml")
    p = rep.save(data)
    assert p.exists()
    assert rep.cleanup(keep=0) == 1


def test_resource_manager_facade(tmp_path):
    cfg = ResourceConfig(
        backup=BackupConfig(emergency_dir=str(tmp_path / "em")),
        report=type(ResourceConfig().report)(report_dir=str(tmp_path / "rep")),
        enable_signal_handlers=False)
    mgr = ResourceManager(cfg)
    mgr.register_model("model", lambda: {"w": torch.ones(2)})
    with mgr:
        mgr.start_training(2, 5)
        mgr.start_epoch(0)
        mgr.update_training_step(0, 3, loss=0.5)
        mgr.end_epoch(0, metric=0.4)
        status = mgr.get_status_summary()
        assert status["running"] and "memory" in status["resources"]
        assert not mgr.should_shutdown()
    assert not mgr._running


def test_resource_managed_training_failure_backup(tmp_path):
    cfg = ResourceConfig(
        backup=BackupConfig(emergency_dir=str(tmp_path / "em")),
        enable_signal_handlers=False)
    with pytest.raises(RuntimeError):
        with resource_managed_training(cfg) as rm:
            rm.register_model("m", lambda: {"x": torch.zeros(1)})
            rm.start_training(1, 1)
            raise RuntimeError("boom")
    # failure path created an emergency backup
    assert any((tmp_path / "em").iterdir())


def test_same_surface_and_defaults_as_jax():
    assert PR.__all__ == JR.__all__
    for name in ("ResourceConfig", "ResourceThresholds", "MonitoringIntervals",
                 "BackupConfig", "ReportIntervalConfig"):
        assert dataclasses.asdict(getattr(PR, name)()) == \
            dataclasses.asdict(getattr(JR, name)())


def test_device_monitor_reports_zero_without_cuda():
    m = PR.DeviceMemoryMonitor(interval=0.05, warning=0.0, critical=200.0)
    snap = m.poll_once()
    assert snap.resource == "device"
    if not torch.cuda.is_available():
        assert snap.percent == 0.0 and snap.detail == {}


def test_emergency_save_restores_the_state(tmp_path):
    from vivqa_tpu_torch.train.checkpoint import (emergency_save,
                                                  restore_emergency)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "optimizer": {"count": 3, "state": {"mu": {"w": torch.ones(2)}}},
             "step": 3}
    path = emergency_save(state, tmp_path, metadata={"reason": "test"})
    assert path == (tmp_path / "emergency").absolute()
    got, meta = restore_emergency(path)
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["optimizer"]["count"] == 3 and got["step"] == 3
    assert meta == {"reason": "test"}
    emergency_save({"step": 4}, tmp_path)            # replaces it
    assert restore_emergency(path)[0]["step"] == 4
