"""Resource/progress reports: JSON/YAML/CSV/text + auto-save thread
(counterpart of vivqa_tpu/resources/reports.py; reference:
src/resource_management/report_manager.py:33-954)."""

from __future__ import annotations

import csv
import io
import json
import threading
import time
from pathlib import Path
from typing import Dict, Optional

REPORT_FORMATS = ("json", "yaml", "csv", "text")


def _flatten(d: Dict, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def format_report(data: Dict, fmt: str = "json") -> str:
    if fmt == "json":
        return json.dumps(data, indent=2, default=str)
    if fmt == "yaml":
        import yaml
        return yaml.safe_dump(data, sort_keys=False, default_flow_style=False)
    if fmt == "csv":
        flat = _flatten(data)
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["key", "value"])
        for k, v in flat.items():
            w.writerow([k, v])
        return buf.getvalue()
    if fmt == "text":
        flat = _flatten(data)
        width = max((len(k) for k in flat), default=0)
        lines = ["=" * (width + 24), "RESOURCE REPORT".center(width + 24),
                 "=" * (width + 24)]
        lines += [f"{k.ljust(width)}  {v}" for k, v in flat.items()]
        return "\n".join(lines)
    raise ValueError(f"unknown format '{fmt}' (choices: {REPORT_FORMATS})")


class ReportManager:
    """Generates resource/progress/combined/emergency reports and
    auto-saves on a background thread."""

    def __init__(self, monitor, progress=None, report_dir: str = "resource_reports",
                 auto_save_seconds: float = 1800.0, logger=None):
        self.monitor = monitor
        self.progress = progress
        self.report_dir = Path(report_dir)
        self.auto_save_seconds = auto_save_seconds
        self.log = logger
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- reports ---------------------------------------------------------------
    def resource_report(self) -> Dict:
        return {"type": "resource", "timestamp": time.strftime("%F %T"),
                "snapshot": self.monitor.snapshot(),
                "aggregated": self.monitor.aggregated(),
                "alerts": [vars(a) for a in
                           list(self.monitor.active_alerts)[-10:]]}

    def progress_report(self) -> Dict:
        return {"type": "progress", "timestamp": time.strftime("%F %T"),
                "tasks": self.progress.summary() if self.progress else {}}

    def combined_report(self) -> Dict:
        return {"type": "combined",
                **{k: v for k, v in self.resource_report().items()
                   if k != "type"},
                "tasks": self.progress.summary() if self.progress else {}}

    def emergency_report(self, reason: str) -> Dict:
        return {"type": "emergency", "reason": reason,
                **{k: v for k, v in self.combined_report().items()
                   if k != "type"}}

    # -- persistence -------------------------------------------------------------
    def save(self, report: Dict, fmt: str = "json",
             name: Optional[str] = None) -> Path:
        self.report_dir.mkdir(parents=True, exist_ok=True)
        name = name or f"{report.get('type', 'report')}_" \
                       f"{time.strftime('%Y%m%d_%H%M%S')}.{fmt}"
        path = self.report_dir / name
        path.write_text(format_report(report, fmt))
        return path

    # -- auto-save thread -----------------------------------------------------------
    def start_auto_save(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="report-autosave")
        self._thread.start()

    def stop_auto_save(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.auto_save_seconds):
            try:
                self.save(self.combined_report())
            except Exception:
                pass

    def cleanup(self, keep: int = 20) -> int:
        if not self.report_dir.exists():
            return 0
        files = sorted(self.report_dir.iterdir(),
                       key=lambda p: p.stat().st_mtime)
        victims = files[:-keep] if keep > 0 else files
        removed = 0
        for p in victims:
            p.unlink(missing_ok=True)
            removed += 1
        return removed
