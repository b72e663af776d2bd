"""Resource monitors: CPU / memory / disk / device-memory threads
(counterpart of vivqa_tpu/resources/monitor.py).

Counterpart of src/resource_management/resource_monitor.py:35-1007 in the
reference: per-resource background threads with interval sampling,
bounded history, threshold -> alert callbacks, and an aggregator.
The device monitor reads each card's memory through
``torch.cuda.mem_get_info`` (used = total - free, what every process
holds on the card) and ``torch.cuda.memory_stats`` (this process's
allocator), and, where pynvml is installed, the card's utilization; on a
host without CUDA it reports 0, as the JAX package does on a host
without memory stats.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from vivqa_tpu_torch.resources.config import ResourceConfig


@dataclasses.dataclass
class ResourceSnapshot:
    timestamp: float
    resource: str                  # cpu | memory | disk | device
    percent: float
    detail: Dict


@dataclasses.dataclass
class Alert:
    resource: str
    level: str                     # warning | critical
    percent: float
    timestamp: float
    message: str


class BaseResourceMonitor:
    """Daemon thread sampling one resource on an interval."""
    resource = "base"

    def __init__(self, interval: float, warning: float, critical: float,
                 history_size: int = 720,
                 on_alert: Optional[Callable[[Alert], None]] = None):
        self.interval = interval
        self.warning = warning
        self.critical = critical
        self.history: deque = deque(maxlen=history_size)
        self.on_alert = on_alert
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- to implement --------------------------------------------------------
    def sample(self) -> ResourceSnapshot:
        raise NotImplementedError

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"monitor-{self.resource}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.interval)

    def poll_once(self) -> Optional[ResourceSnapshot]:
        try:
            snap = self.sample()
        except Exception:  # sampling must never kill the thread
            return None
        with self._lock:
            self.history.append(snap)
        level = None
        if snap.percent >= self.critical:
            level = "critical"
        elif snap.percent >= self.warning:
            level = "warning"
        if level and self.on_alert is not None:
            self.on_alert(Alert(self.resource, level, snap.percent,
                                snap.timestamp,
                                f"{self.resource} at {snap.percent:.1f}% "
                                f"(>= {level} threshold)"))
        return snap

    def latest(self) -> Optional[ResourceSnapshot]:
        with self._lock:
            return self.history[-1] if self.history else None

    def stats(self) -> Dict[str, float]:
        with self._lock:
            vals = [s.percent for s in self.history]
        if not vals:
            return {}
        return {"mean": sum(vals) / len(vals), "max": max(vals),
                "last": vals[-1], "n": len(vals)}


class CPUMonitor(BaseResourceMonitor):
    resource = "cpu"

    def sample(self) -> ResourceSnapshot:
        import psutil
        pct = psutil.cpu_percent(interval=None)
        return ResourceSnapshot(time.time(), "cpu", pct,
                                {"count": psutil.cpu_count()})


class MemoryMonitor(BaseResourceMonitor):
    resource = "memory"

    def sample(self) -> ResourceSnapshot:
        import psutil
        vm = psutil.virtual_memory()
        return ResourceSnapshot(time.time(), "memory", vm.percent,
                                {"total_gb": vm.total / 1e9,
                                 "available_gb": vm.available / 1e9})


class DiskMonitor(BaseResourceMonitor):
    resource = "disk"

    def __init__(self, *args, path: str = "/", **kwargs):
        super().__init__(*args, **kwargs)
        self.path = path

    def sample(self) -> ResourceSnapshot:
        import psutil
        du = psutil.disk_usage(self.path)
        return ResourceSnapshot(time.time(), "disk", du.percent,
                                {"free_gb": du.free / 1e9})


class DeviceMemoryMonitor(BaseResourceMonitor):
    """The cards' memory (replaces the JAX package's TPU HBM monitor and
    the reference's pynvml GPU monitor, resource_monitor.py:469-671)."""
    resource = "device"

    def sample(self) -> ResourceSnapshot:
        import torch
        pcts, detail = [], {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                free, total = torch.cuda.mem_get_info(i)
                stats = torch.cuda.memory_stats(i)
                used = total - free
                pcts.append(100.0 * used / total)
                detail[str(i)] = {
                    "used_gb": used / 1e9, "limit_gb": total / 1e9,
                    "allocated_gb":
                        stats.get("allocated_bytes.all.current", 0) / 1e9,
                    "reserved_gb":
                        stats.get("reserved_bytes.all.current", 0) / 1e9,
                    **_utilization(i)}
        pct = max(pcts) if pcts else 0.0
        return ResourceSnapshot(time.time(), "device", pct, detail)


def _utilization(index: int) -> Dict[str, float]:
    """The card's compute utilization (%) where pynvml is installed."""
    try:
        import pynvml
    except ImportError:
        return {}
    try:
        pynvml.nvmlInit()
        handle = pynvml.nvmlDeviceGetHandleByIndex(index)
        return {"utilization_percent": float(
            pynvml.nvmlDeviceGetUtilizationRates(handle).gpu)}
    except Exception:       # NVML unavailable: the memory numbers stand
        return {}


class ResourceMonitor:
    """Aggregator owning all monitors + alert fan-out (reference :764)."""

    def __init__(self, config: ResourceConfig,
                 on_alert: Optional[Callable[[Alert], None]] = None):
        self.config = config
        self._callbacks: List[Callable[[Alert], None]] = []
        if on_alert:
            self._callbacks.append(on_alert)
        t, iv = config.thresholds, config.intervals
        fan = self._fan_out
        self.monitors: Dict[str, BaseResourceMonitor] = {
            "cpu": CPUMonitor(iv.cpu_seconds, t.cpu_warning, t.cpu_critical,
                              config.history_size, fan),
            "memory": MemoryMonitor(iv.memory_seconds, t.memory_warning,
                                    t.memory_critical, config.history_size,
                                    fan),
            "disk": DiskMonitor(iv.disk_seconds, t.disk_warning,
                                t.disk_critical, config.history_size, fan),
            "device": DeviceMemoryMonitor(iv.device_seconds,
                                          t.device_memory_warning,
                                          t.device_memory_critical,
                                          config.history_size, fan),
        }
        self.active_alerts: deque = deque(maxlen=100)

    def add_callback(self, cb: Callable[[Alert], None]) -> None:
        self._callbacks.append(cb)

    def _fan_out(self, alert: Alert) -> None:
        self.active_alerts.append(alert)
        for cb in self._callbacks:
            try:
                cb(alert)
            except Exception:
                pass

    def start(self) -> None:
        for m in self.monitors.values():
            m.start()

    def stop(self) -> None:
        for m in self.monitors.values():
            m.stop()

    def snapshot(self) -> Dict[str, Dict]:
        out = {}
        for name, m in self.monitors.items():
            s = m.latest() or m.poll_once()
            if s is not None:
                out[name] = {"percent": s.percent, **s.detail}
        return out

    def aggregated(self) -> Dict[str, Dict]:
        return {name: m.stats() for name, m in self.monitors.items()}

    def is_critical(self) -> bool:
        t = self.config.thresholds
        snap = self.snapshot()
        checks = (("cpu", t.cpu_critical), ("memory", t.memory_critical),
                  ("disk", t.disk_critical),
                  ("device", t.device_memory_critical))
        return any(snap.get(r, {}).get("percent", 0) >= th
                   for r, th in checks)
