"""Consumer-side stall statistics (time the trainer spent blocked waiting
for its next batch, the stall metric of the train path) and the
process-wide watchdog and fault records (own copies of the JAX package's
``WatchdogStats`` and ``FaultStats``, keeping what the port records)."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class BatchWaitStats:
    wait_times: List[float] = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def record(self, wait_s: float) -> None:
        with self._lock:
            self.wait_times.append(wait_s)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            arr = np.asarray(self.wait_times, dtype=np.float64)
        if arr.size == 0:
            return {"mean": 0.0, "std": 0.0, "max": 0.0, "min": 0.0,
                    "total": 0.0, "count": 0}
        return {
            "mean": float(arr.mean()), "std": float(arr.std()),
            "max": float(arr.max()), "min": float(arr.min()),
            "total": float(arr.sum()), "count": int(arr.size),
        }


class WatchdogStats:
    """Process-wide sink for the watchdog's stall reports and the
    degradations they caused (``runtime/watchdog.py`` records stalls,
    ``device_dataset`` its fallbacks). Totals are monotonic: snapshot
    before and after a run to count that run's events."""

    _RECENT = 32  # the most recent stalls and fallbacks kept

    def __init__(self):
        self._lock = threading.Lock()
        self._events = 0
        self._escalations = 0
        self._fallbacks = 0
        self._by_name: Dict[str, int] = {}
        self._recent: List[Dict[str, Any]] = []

    def _remember(self, entry: Dict[str, Any]) -> None:
        self._recent.append(entry)
        del self._recent[:-self._RECENT]

    def record_stall(self, report) -> None:
        """``report`` is a ``runtime.watchdog.StallReport``."""
        with self._lock:
            self._events += 1
            if report.escalation > 1:
                self._escalations += 1
            self._by_name[report.name] = self._by_name.get(report.name,
                                                           0) + 1
            self._remember({
                "name": report.name,
                "waited_s": float(report.waited_s),
                "deadline_s": float(report.deadline_s),
                "escalation": int(report.escalation),
                "detail": report.detail,
                "timestamp": float(report.timestamp),
            })

    def record_fallback(self, component: str, reason: str) -> None:
        with self._lock:
            self._fallbacks += 1
            self._remember({"name": f"{component}:fallback",
                            "detail": reason, "timestamp": time.time()})

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "watchdog_events": self._events,
                "stall_escalations": self._escalations,
                "fallbacks_engaged": self._fallbacks,
                "stalls_by_name": dict(self._by_name),
                "recent_stalls": list(self._recent),
            }


class FaultStats:
    """Process-wide sink for injected faults and their recoveries
    (``runtime/faults.py`` injects, ``runtime/retry.py`` retries,
    ``device_dataset`` records a copy recovered after a failure as a
    recompute). Totals are monotonic, as :class:`WatchdogStats`'s."""

    def __init__(self):
        self._lock = threading.Lock()
        self._injected = 0
        self._injected_by_site: Dict[str, int] = {}
        self._retries = 0
        self._recomputes = 0
        self._recovery_s_total = 0.0
        self._recovery_s_max = 0.0

    def record_injected(self, site: str) -> None:
        with self._lock:
            self._injected += 1
            self._injected_by_site[site] = self._injected_by_site.get(
                site, 0) + 1

    def record_retry(self, component: str) -> None:
        with self._lock:
            self._retries += 1

    def record_recompute(self, component: str, latency_s: float) -> None:
        with self._lock:
            self._recomputes += 1
            self._recovery_s_total += latency_s
            self._recovery_s_max = max(self._recovery_s_max, latency_s)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "injected": self._injected,
                "injected_by_site": dict(self._injected_by_site),
                "retries": self._retries,
                "recomputes": self._recomputes,
                "recovery_latency_total_s": self._recovery_s_total,
                "recovery_latency_max_s": self._recovery_s_max,
            }

    def __getitem__(self, key: str):
        """Mapping-style access (``fault_stats()["recomputes"]``)."""
        return self.snapshot()[key]


_watchdog_stats = WatchdogStats()
_fault_stats = FaultStats()


def watchdog_stats() -> WatchdogStats:
    """The process-wide stall recorder."""
    return _watchdog_stats


def fault_stats() -> FaultStats:
    """The process-wide fault and recovery recorder."""
    return _fault_stats
