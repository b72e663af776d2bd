"""Resource management tutorial on the port (counterpart of
examples/resource_management_examples.py; reference:
examples/resource_management_examples.py, 523 LoC — the reference's
largest example, because the subsystem is its operational safety net).

The resource subsystem watches CPU / host RAM / disk / the card's memory
from daemon threads, fans alerts out to callbacks, makes throttled
emergency backups on critical pressure, tracks training progress with
ETA, and writes periodic JSON reports — all host-side Python around the
device's compute, where such code belongs.

Reference surface: src/resource_management/ (resource_monitor.py,
backup_handler.py, progress_tracker.py, report_manager.py,
resource_manager.py). Deltas: the JAX package's TPU HBM monitor becomes
the card's memory via `torch.cuda.mem_get_info` (no pynvml needed), and
emergency backups are torch checkpoints with microsecond-unique names
(rapid alert storms must not collide).

Sections
  1. Configuration: thresholds, intervals, actions
  2. Individual monitors (one sample, no threads)
  3. The aggregator: background threads + alert fan-out
  4. Emergency backups and the auto-backup trigger
  5. Progress tracking with ETA
  6. Reports
  7. The ResourceManager facade in a training loop
  8. Failure-path walkthrough (what happens at 85% RAM)

Run (the state it backs up lies on the card, or on the CPU with
--device cpu; finishes in a few seconds):
    python3 -m vivqa_tpu_torch.examples.resource_management_examples [--device cpu]
"""

import pathlib
import tempfile
import time

import torch

from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.resources import (Alert, AutoBackupTrigger,
                                       BackupConfig, BackupHandler,
                                       CPUMonitor, DeviceMemoryMonitor,
                                       DiskMonitor, MemoryMonitor,
                                       ProgressTracker, ResourceConfig,
                                       ResourceMonitor, ResourceThresholds,
                                       TrainingProgressTracker,
                                       resource_managed_training)


def section_config(tmp):
    banner("1. Configuration")
    print("""Thresholds are percentages with warning/critical tiers per
resource (reference resource_config.py:51-112; defaults warn 70 /
critical 90, RAM kill-switch at 85 via the separate memory guard):

    cfg = ResourceConfig(
        thresholds=ResourceThresholds(memory_warning=70.0,
                                      memory_critical=90.0,
                                      cpu_warning=80.0, ...),
        intervals=MonitoringIntervals(memory_seconds=5.0, ...),
        backup=BackupConfig(emergency_dir="emergency_backups",
                            max_backups=3, min_interval_seconds=60),
        threshold_action="backup",   # warn_only | backup | backup_and_shutdown
        enable_signal_handlers=True) # SIGINT/SIGTERM -> emergency save

Everything below uses aggressive intervals so the demo finishes
quickly.""")
    cfg = ResourceConfig(
        thresholds=ResourceThresholds(memory_warning=50.0,
                                      memory_critical=98.0),
        backup=BackupConfig(emergency_dir=f"{tmp}/em",
                            min_interval_seconds=0),
        enable_signal_handlers=False)
    return cfg.replace(intervals=cfg.intervals.replace(
        memory_seconds=0.2, cpu_seconds=0.2, disk_seconds=0.5))


def section_monitors():
    banner("2. Individual monitors (one sample each)")
    print("Each monitor is a tiny sampler class; `sample()` works without\n"
          "starting the background thread:\n")
    mons = {
        "cpu": CPUMonitor(1.0, 80, 95, 16, None),
        "memory": MemoryMonitor(1.0, 70, 90, 16, None),
        "disk": DiskMonitor(1.0, 80, 95, 16, None),
        "device": DeviceMemoryMonitor(1.0, 80, 95, 16, None),
    }
    for name, m in mons.items():
        snap = m.sample()
        extra = ""
        if name == "device":
            extra = "  (the card's memory via torch.cuda.mem_get_info;\n" \
                    "            0% on a host without a card)"
        detail = {k: v for k, v in list(snap.detail.items())[:2]}
        print(f"  {name:>7}: {snap.percent:5.1f}%  {detail}{extra}")


def section_aggregator(cfg):
    banner("3. The aggregator: threads + alert fan-out")
    print("""ResourceMonitor owns one daemon thread per resource; alerts flow
to registered callbacks (reference resource_monitor.py:764-1007).
Forcing an alert by setting the CPU warning threshold to 0%:
""")
    seen = []
    forced = cfg.replace(thresholds=cfg.thresholds.replace(cpu_warning=0.0))
    rm = ResourceMonitor(forced, on_alert=seen.append)
    rm.start()
    time.sleep(1.0)
    rm.stop()
    if seen:
        a = seen[0]
        print(f"  alert: resource={a.resource} level={a.level} "
              f"percent={a.percent:.1f}%  msg='{a.message}'")
    print(f"  total alerts in 1s: {len(seen)}")
    print("  Alerts are data (dataclass), not exceptions — the training\n"
          "  loop never unwinds; the callback decides what to do.")


def section_backup(cfg, device):
    banner("4. Emergency backups and the auto-backup trigger")
    print("""BackupHandler persists whatever state providers are registered;
AutoBackupTrigger connects alerts to it with throttling
(reference backup_handler.py:188-455, 620-829):
""")
    handler = BackupHandler(cfg.backup)
    handler.register_state_provider(
        "model", lambda: {"w": torch.ones(4, 4, device=device), "step": 7})
    path = handler.create_backup("demo")
    print(f"  manual backup -> {pathlib.Path(path).name}")
    trigger = AutoBackupTrigger(handler, action="backup_and_shutdown",
                                min_interval=0.0)
    trigger.on_resource_alert(Alert(resource="memory", level="critical",
                                    percent=97.0, timestamp=time.time(),
                                    message="demo"))
    print(f"  after critical alert: backups={len(handler.backups)}, "
          f"shutdown_requested={trigger.shutdown_requested.is_set()}")
    print("  The trainer polls shutdown_requested between steps and exits\n"
          "  cleanly — no mid-step kill, the checkpoint is consistent.")
    print("  Names are microsecond-unique: alert storms can fire several\n"
          "  backups in one second without overwriting each other.")


def section_progress():
    banner("5. Progress tracking with ETA")
    pt = ProgressTracker()
    pt.create_task("index", "build KB index", total_steps=50)
    pt.start("index")
    for i in range(0, 50, 10):
        pt.update("index", i)
        time.sleep(0.02)
    info = pt.tasks["index"]
    print(f"  generic task: step {info.current_step}/{info.total_steps} "
          f"({info.progress:.0%}), ETA ~{info.eta_seconds:.2f}s")
    pt.complete("index")

    tt = TrainingProgressTracker()
    tt.create_training_task(num_epochs=2, steps_per_epoch=5)
    for epoch in range(2):
        tt.start_epoch(epoch)
        for step in range(5):
            tt.update_training_step(epoch, step, loss=1.0 / (step + 1))
        tt.end_epoch(epoch, metric=0.5 + 0.2 * epoch)
    print(f"  training task: best metric {tt.best_metric:.2f} "
          f"@ epoch {tt.best_epoch}")


def section_reports(cfg):
    banner("6. Reports")
    print("""ReportManager renders resource/progress/combined/emergency reports
and can auto-save on an interval thread (reference
report_manager.py:631-954). One combined report:
""")
    from vivqa_tpu_torch.resources.reports import ReportManager
    mon = ResourceMonitor(cfg)
    mon.start(); time.sleep(0.5)
    with tempfile.TemporaryDirectory() as report_dir:
        rep = ReportManager(mon, report_dir=report_dir)
        combined = rep.combined_report()
    mon.stop()
    print(f"  sections: {sorted(combined.keys())}")
    res = combined.get("resources", {})
    row = next(iter(res.items()), None)
    if row:
        print(f"  sample row: {row[0]} -> {row[1]}")


def section_facade(cfg, device):
    banner("7. The ResourceManager facade in a training loop")
    print("""One object wires monitors + backup + progress + reports, with a
context manager for exception-safe shutdown (reference
resource_manager.py:139-891). This is exactly how VQATrainer and the
pipelines integrate it:
""")
    with resource_managed_training(cfg) as rm:
        rm.register_model("model",
                          lambda: {"w": torch.zeros(8, 8, device=device)})
        rm.start_training(num_epochs=2, steps_per_epoch=5)
        for epoch in range(2):
            rm.start_epoch(epoch)
            for step in range(5):
                rm.update_training_step(epoch, step, loss=1.0 / (step + 1))
            rm.end_epoch(epoch, metric=0.5 + 0.1 * epoch)
        summary = rm.get_status_summary()
        print(f"  status summary keys: {sorted(summary.keys())}")
        print(f"  resources tracked:   {sorted(summary['resources'].keys())}")
    print("  (context exit stopped every monitor thread)")


def section_failure_path():
    banner("8. Failure-path walkthrough")
    print("""What actually happens under memory pressure, end to end:

  RAM 70%   MemoryMonitor fires a WARNING alert -> logged; the data
            loader's memory guard (utils/memory_guard.py) also warns.
  RAM 85%   the data-loading guard raises MemoryOverflowException —
            loading aborts BEFORE the host swaps to death (reference
            data_exception_handling.py:55-176 kill-switch).
  RAM 90%   monitor fires CRITICAL -> AutoBackupTrigger makes a
            throttled emergency backup; under
            threshold_action=backup_and_shutdown it also sets the
            shutdown flag -> trainer saves + exits at the next step
            boundary.
  SIGINT    signal handler (when enabled) runs the same emergency
            save before re-raising KeyboardInterrupt.
  Ablation  an OOM inside one experiment retries it with doubled
            gradient accumulation instead of killing the whole study
            (vivqa_tpu_torch/ablation/trainer.py).

All of it is tested: tests/test_torch_resources.py covers thresholds,
throttling, unique naming, and the shutdown flag.""")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    with tempfile.TemporaryDirectory() as tmp:
        cfg = section_config(tmp)
        section_monitors()
        section_aggregator(cfg)
        section_backup(cfg, device)
        section_progress()
        section_reports(cfg)
        section_facade(cfg, device)
        section_failure_path()
    banner("Done")


if __name__ == "__main__":
    main()
