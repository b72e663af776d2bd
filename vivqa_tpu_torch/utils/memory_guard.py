"""Data-loading memory guard: a copy of vivqa_tpu/utils/memory_guard.py
(the port imports nothing of the JAX package).

Counterpart of src/exception/data_exception_handling.py:55-176 in the
reference: check RAM usage during bulk loading, warn at one threshold and
raise MemoryOverflowException at the kill threshold (the reference's 70%
warn / 85% kill defaults, middleware/config.py:77-78).
"""

from __future__ import annotations

import logging

_log = logging.getLogger("vivqa_tpu_torch.memory_guard")


class MemoryOverflowException(MemoryError):
    """Raised when host RAM crosses the kill threshold during loading."""


class MemoryGuard:
    def __init__(self, warn_percent: float = 70.0,
                 kill_percent: float = 85.0, check_every: int = 100):
        self.warn_percent = warn_percent
        self.kill_percent = kill_percent
        self.check_every = max(1, check_every)
        self._count = 0
        self._warned = False

    def check(self, force: bool = False) -> float | None:
        """Call once per item; samples every `check_every` calls.
        Returns the sampled percent (or None when skipped)."""
        self._count += 1
        if not force and self._count % self.check_every:
            return None
        import psutil
        pct = psutil.virtual_memory().percent
        if pct >= self.kill_percent:
            raise MemoryOverflowException(
                f"host RAM at {pct:.1f}% >= kill threshold "
                f"{self.kill_percent}% — aborting load")
        if pct >= self.warn_percent and not self._warned:
            _log.warning("host RAM at %.1f%% (warn threshold %.0f%%)",
                         pct, self.warn_percent)
            self._warned = True
        return pct


_GUARD: MemoryGuard | None = None


def get_memory_guard(**kwargs) -> MemoryGuard:
    """Singleton (reference src/middleware/monitor.py:1-7)."""
    global _GUARD
    if _GUARD is None or kwargs:
        _GUARD = MemoryGuard(**kwargs)
    return _GUARD
