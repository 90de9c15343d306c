"""Stats of the shuffle and the train path (own copies of the JAX
package's ``stats.py`` pieces the port records):

- the per-stage shuffle stats: :class:`TrialStats` (one
  :class:`EpochStats` per epoch: map, reduce and consume stage spans and
  task durations, the launch throttle's wait), collected by
  :class:`TrialStatsCollector` (one :class:`EpochStatsCollector` per
  epoch, first-start to last-done edges) when a shuffle runs with
  ``collect_stats=True``; :func:`trial_summary` flattens one to a line per
  epoch;
- the memory sampler of ``shuffle.shuffle_with_stats`` (process RSS and
  the buffer ledger's bytes);
- consumer-side stall statistics (:class:`BatchWaitStats`: time the
  trainer spent blocked waiting for its next batch);
- the process-wide watchdog and fault records (:class:`WatchdogStats`,
  :class:`FaultStats`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import timeit
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Shuffle stage stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageStats:
    task_durations: List[float]
    stage_duration: float


@dataclasses.dataclass
class MapStats(StageStats):
    read_durations: List[float]


@dataclasses.dataclass
class ReduceStats(StageStats):
    pass


@dataclasses.dataclass
class ConsumeStats(StageStats):
    consume_times: List[float]


@dataclasses.dataclass
class ThrottleStats:
    wait_duration: float


@dataclasses.dataclass
class EpochStats:
    duration: float
    map_stats: MapStats
    reduce_stats: ReduceStats
    consume_stats: ConsumeStats
    throttle_stats: ThrottleStats


@dataclasses.dataclass
class TrialStats:
    epoch_stats: List[EpochStats]
    duration: float


class EpochStatsCollector:
    """Per-epoch stage spans with first-start / last-done edge detection.
    Thread-safe: map, reduce and consume tasks report from pool threads."""

    def __init__(self, num_maps: int, num_reduces: int, num_consumes: int):
        self._num_maps = num_maps
        self._num_reduces = num_reduces
        self._num_consumes = num_consumes
        self._lock = threading.Lock()
        self._epoch_start_time: Optional[float] = None
        self._duration: Optional[float] = None
        self._started = {"map": 0, "reduce": 0, "consume": 0}
        self._maps_done = 0
        self._map_durations: List[float] = []
        self._read_durations: List[float] = []
        self._reduces_done = 0
        self._reduce_durations: List[float] = []
        self._consumes_done = 0
        self._consume_durations: List[float] = []
        self._consume_times: List[float] = []
        self._throttle_duration = 0.0
        self._stage_start: Dict[str, Optional[float]] = {
            "map": None, "reduce": None, "consume": None}
        self._stage_duration: Dict[str, Optional[float]] = {
            "map": None, "reduce": None, "consume": None}
        self._done_event = threading.Event()
        if num_reduces == 0:
            # A host that owns no reducer (more hosts than reducers) has
            # nothing to wait for.
            self._duration = 0.0
            self._done_event.set()

    def epoch_start(self) -> None:
        with self._lock:
            self._epoch_start_time = timeit.default_timer()

    def map_start(self) -> None:
        self._stage_task_start("map")

    def map_done(self, duration: float, read_duration: float) -> None:
        with self._lock:
            self._maps_done += 1
            self._map_durations.append(duration)
            self._read_durations.append(read_duration)
            # ">=": a retried or recomputed map records again; the
            # last-done edge extends to the latest completion.
            if self._maps_done >= self._num_maps:
                self._stage_done_locked("map")

    def reduce_start(self) -> None:
        self._stage_task_start("reduce")

    def reduce_done(self, duration: float) -> None:
        with self._lock:
            self._reduces_done += 1
            self._reduce_durations.append(duration)
            if self._reduces_done >= self._num_reduces:
                self._stage_done_locked("reduce")
                # The epoch's "shuffle done" edge is its last reduce.
                assert self._epoch_start_time is not None
                self._duration = (timeit.default_timer()
                                  - self._epoch_start_time)
                self._done_event.set()

    def consume_start(self) -> None:
        self._stage_task_start("consume")

    def consume_done(self, duration: float,
                     trial_time_to_consume: float) -> None:
        with self._lock:
            self._consumes_done += 1
            self._consume_durations.append(duration)
            self._consume_times.append(trial_time_to_consume)
            if self._consumes_done >= self._num_consumes:
                self._stage_done_locked("consume")

    def throttle_done(self, duration: float) -> None:
        with self._lock:
            self._throttle_duration += duration

    def _stage_task_start(self, stage: str) -> None:
        with self._lock:
            if self._started[stage] == 0:
                self._stage_start[stage] = timeit.default_timer()
            self._started[stage] += 1

    def _stage_done_locked(self, stage: str) -> None:
        start = self._stage_start[stage]
        assert start is not None, f"{stage} stage never started"
        self._stage_duration[stage] = timeit.default_timer() - start

    def wait_until_done(self, timeout: Optional[float] = None) -> bool:
        return self._done_event.wait(timeout)

    def get_stats(self) -> EpochStats:
        with self._lock:
            assert self._maps_done >= self._num_maps, (
                f"epoch incomplete: {self._maps_done}/{self._num_maps} maps")
            assert self._reduces_done >= self._num_reduces, (
                f"epoch incomplete: {self._reduces_done}/{self._num_reduces}"
                " reduces")
            return EpochStats(
                duration=self._duration or 0.0,
                map_stats=MapStats(list(self._map_durations),
                                   self._stage_duration["map"] or 0.0,
                                   list(self._read_durations)),
                reduce_stats=ReduceStats(list(self._reduce_durations),
                                         self._stage_duration["reduce"]
                                         or 0.0),
                consume_stats=ConsumeStats(list(self._consume_durations),
                                           self._stage_duration["consume"]
                                           or 0.0,
                                           list(self._consume_times)),
                throttle_stats=ThrottleStats(self._throttle_duration))


class TrialStatsCollector:
    """Whole-trial collector: one :class:`EpochStatsCollector` per epoch
    plus the trial's wall clock; the shuffle's tasks call the per-epoch
    hooks by epoch index."""

    def __init__(self, num_epochs: int, num_maps: int, num_reduces: int,
                 num_consumes: int):
        self._epochs = [
            EpochStatsCollector(num_maps, num_reduces, num_consumes)
            for _ in range(num_epochs)]
        self._trial_start_time: Optional[float] = None
        self._trial_duration: Optional[float] = None
        self._lock = threading.Lock()

    def trial_start(self) -> None:
        with self._lock:
            self._trial_start_time = timeit.default_timer()

    @property
    def trial_start_time(self) -> float:
        assert self._trial_start_time is not None
        return self._trial_start_time

    def epoch(self, epoch: int) -> EpochStatsCollector:
        return self._epochs[epoch]

    def epoch_start(self, epoch: int) -> None:
        self._epochs[epoch].epoch_start()

    def map_start(self, epoch: int) -> None:
        self._epochs[epoch].map_start()

    def map_done(self, epoch: int, duration: float,
                 read_duration: float) -> None:
        self._epochs[epoch].map_done(duration, read_duration)

    def reduce_start(self, epoch: int) -> None:
        self._epochs[epoch].reduce_start()

    def reduce_done(self, epoch: int, duration: float) -> None:
        self._epochs[epoch].reduce_done(duration)

    def consume_start(self, epoch: int) -> None:
        self._epochs[epoch].consume_start()

    def consume_done(self, epoch: int, duration: float,
                     trial_time_to_consume: float) -> None:
        self._epochs[epoch].consume_done(duration, trial_time_to_consume)

    def throttle_done(self, epoch: int, duration: float) -> None:
        self._epochs[epoch].throttle_done(duration)

    def trial_done(self) -> None:
        with self._lock:
            assert self._trial_start_time is not None
            self._trial_duration = (timeit.default_timer()
                                    - self._trial_start_time)

    def get_stats(self, timeout: Optional[float] = None) -> TrialStats:
        for collector in self._epochs:
            collector.wait_until_done(timeout)
        with self._lock:
            duration = self._trial_duration
        if duration is None:
            assert self._trial_start_time is not None
            duration = timeit.default_timer() - self._trial_start_time
        return TrialStats(epoch_stats=[c.get_stats() for c in self._epochs],
                          duration=duration)


def trial_summary(trial: TrialStats) -> List[Dict[str, Any]]:
    """One flat dict per epoch of a :class:`TrialStats`: the epoch's
    seconds (first map start to last reduce done), each stage's span and
    task count, the sums of the map, read and reduce task seconds, and the
    launch throttle's wait."""
    out = []
    for epoch, e in enumerate(trial.epoch_stats):
        out.append({
            "epoch": epoch,
            "epoch_s": e.duration,
            "map_stage_s": e.map_stats.stage_duration,
            "map_tasks": len(e.map_stats.task_durations),
            "map_task_s": float(sum(e.map_stats.task_durations)),
            "read_s": float(sum(e.map_stats.read_durations)),
            "reduce_stage_s": e.reduce_stats.stage_duration,
            "reduce_tasks": len(e.reduce_stats.task_durations),
            "reduce_task_s": float(sum(e.reduce_stats.task_durations)),
            "consume_stage_s": e.consume_stats.stage_duration,
            "consumes": len(e.consume_stats.task_durations),
            "throttle_s": e.throttle_stats.wait_duration,
        })
    return out


# ---------------------------------------------------------------------------
# Memory sampler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MemorySample:
    """One utilization sample: process RSS and the buffer ledger's bytes
    (in use, and held in its free list for reuse)."""
    timestamp: float
    rss_bytes: int
    pool_bytes: int
    pool_cached_bytes: int = 0


def _read_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


def get_memory_stats() -> MemorySample:
    from ray_shuffling_data_loader_tpu_torch import native
    ledger = native.buffer_ledger()
    return MemorySample(timestamp=time.time(), rss_bytes=_read_rss_bytes(),
                        pool_bytes=ledger.bytes_in_use(),
                        pool_cached_bytes=ledger.freelist_bytes())


def start_store_stats_sampler(stats_list: List[Tuple[float, MemorySample]],
                              sample_period_s: float = 5.0
                              ) -> threading.Event:
    """Append ``(timestamp, sample)`` to ``stats_list`` every
    ``sample_period_s`` on a daemon thread; returns the event that stops
    it."""
    done = threading.Event()

    def run() -> None:
        while not done.is_set():
            sample = get_memory_stats()
            stats_list.append((sample.timestamp, sample))
            done.wait(sample_period_s)

    threading.Thread(target=run, daemon=True,
                     name="rsdl-store-stats").start()
    return done


# ---------------------------------------------------------------------------
# Consumer stalls, watchdog and fault records
# ---------------------------------------------------------------------------


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
    recompute, the shuffle records a map recomputed from lineage, a
    reduce re-run and a spill recomputed, a file quarantined and a
    recovery that ran out of attempts). Totals are monotonic, as
    :class:`WatchdogStats`'s."""

    _RECENT = 32  # the most recent quarantine reports kept

    def __init__(self):
        self._lock = threading.Lock()
        self._injected = 0
        self._injected_by_site: Dict[str, int] = {}
        self._retries = 0
        self._recomputes = 0
        self._recovery_s_total = 0.0
        self._recovery_s_max = 0.0
        self._recomputes_by_component: Dict[str, int] = {}
        self._quarantines = 0
        self._recent_quarantines: List[Dict[str, Any]] = []
        self._exhausted = 0

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
            self._recomputes_by_component[component] = \
                self._recomputes_by_component.get(component, 0) + 1
            self._recovery_s_total += latency_s
            self._recovery_s_max = max(self._recovery_s_max, latency_s)

    def record_quarantine(self, report) -> None:
        """``report`` is a ``runtime.faults.QuarantinedFile``."""
        with self._lock:
            self._quarantines += 1
            self._recent_quarantines.append(report.as_dict())
            del self._recent_quarantines[:-self._RECENT]

    def record_exhausted(self, component: str) -> None:
        """A recovery (e.g. a lineage recompute) ran out of attempts."""
        with self._lock:
            self._exhausted += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "recomputes_by_component": dict(
                    self._recomputes_by_component),
                "quarantines": self._quarantines,
                "recent_quarantines": list(self._recent_quarantines),
                "recoveries_exhausted": self._exhausted,
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
