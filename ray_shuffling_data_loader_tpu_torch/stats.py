"""Stats of the shuffle and the train path (own copies of the JAX
package's ``stats.py`` pieces the port records):

- the per-stage shuffle stats: :class:`TrialStats` (one
  :class:`EpochStats` per epoch: map, reduce and consume stage spans and
  task durations, the launch throttle's wait), collected by
  :class:`TrialStatsCollector` (one :class:`EpochStatsCollector` per
  epoch, first-start to last-done edges) when a shuffle runs with
  ``collect_stats=True``; :func:`trial_summary` flattens one to a line per
  epoch;
- the memory sampler of ``shuffle.shuffle_with_stats`` (process RSS, the
  buffer ledger's bytes and, when asked for, the device's allocated
  bytes);
- consumer-side stall statistics (:class:`BatchWaitStats`: time the
  trainer spent blocked waiting for its next batch);
- the process-wide watchdog and fault records (:class:`WatchdogStats`,
  :class:`FaultStats`), which keep their counts in the metrics registry
  (``runtime/metrics.py``), and the registry totals the JAX package's
  trial CSV reads (:func:`process_recovery_totals`,
  :func:`queue_serve_totals`: counters of a queue service the port does
  not have yet, so they read 0);
- the trial and epoch CSV writers (:func:`process_stats`: the JAX
  package's columns, with the telemetry verdict of the run).
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import os
import threading
import time
import timeit
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils import fileio
from ray_shuffling_data_loader_tpu_torch.utils.humanize import (
    human_readable_big_num, human_readable_size)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)


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
            # The caller declared this finite count (stats are collected
            # per bounded trial; a stream passes no collector), so the
            # list has a static shape.
            # rsdl-lint: disable=static-epoch-assumption
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
    """One utilization sample: process RSS, the buffer ledger's bytes (in
    use, and held in its free list for reuse) and, when asked for, the
    device memory the caching allocator has handed out."""
    timestamp: float
    rss_bytes: int
    pool_bytes: int
    pool_cached_bytes: int = 0
    hbm_bytes: int = 0

    @property
    def object_store_bytes_used(self) -> int:
        """The bytes the CSV reports call object-store utilization."""
        return self.pool_bytes if self.pool_bytes else self.rss_bytes


def _read_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


def _device_allocated_bytes() -> int:
    """``torch.cuda.memory_stats()``'s current allocated bytes on the
    current device; 0 where torch is not loaded or no CUDA context exists
    (a sampler never creates one)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_stats().get(
        "allocated_bytes.all.current", 0))


def get_memory_stats(sample_hbm: bool = False) -> MemorySample:
    """One utilization sample: process RSS, the buffer ledger's bytes
    and, with ``sample_hbm``, the device's allocated bytes."""
    from ray_shuffling_data_loader_tpu_torch import native
    ledger = native.buffer_ledger()
    return MemorySample(timestamp=time.time(), rss_bytes=_read_rss_bytes(),
                        pool_bytes=ledger.bytes_in_use(),
                        pool_cached_bytes=ledger.freelist_bytes(),
                        hbm_bytes=(_device_allocated_bytes()
                                   if sample_hbm else 0))


def collect_store_stats(stats_list: List[Tuple[float, MemorySample]],
                        done_event: threading.Event,
                        sample_period_s: float = 5.0,
                        sample_hbm: bool = False) -> None:
    """Sampler loop: append ``(timestamp, sample)`` every
    ``sample_period_s`` until ``done_event`` is set."""
    while not done_event.is_set():
        sample = get_memory_stats(sample_hbm=sample_hbm)
        stats_list.append((sample.timestamp, sample))
        done_event.wait(sample_period_s)


def start_store_stats_sampler(stats_list: List[Tuple[float, MemorySample]],
                              sample_period_s: float = 5.0,
                              sample_hbm: bool = False
                              ) -> threading.Event:
    """Run :func:`collect_store_stats` on a daemon thread; returns the
    event that stops it."""
    done = threading.Event()
    threading.Thread(target=collect_store_stats,
                     args=(stats_list, done, sample_period_s, sample_hbm),
                     daemon=True, name="rsdl-store-stats").start()
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
    ``device_dataset`` its fallbacks). The counts live in the metrics
    registry (``rsdl_watchdog_*``: one set of cells per process, shared
    by every instance, as in the JAX package); only the ring of recent
    stalls is per instance. Totals are monotonic: snapshot before and
    after a run to count that run's events."""

    _RECENT = 32  # the most recent stalls and fallbacks kept

    def __init__(self):
        self._lock = threading.Lock()
        self._events = rt_metrics.counter(
            "rsdl_watchdog_events_total", "watchdog deadline misses")
        self._escalations = rt_metrics.counter(
            "rsdl_watchdog_escalations_total",
            "stalls persisting past further deadline multiples")
        self._fallbacks = rt_metrics.counter(
            "rsdl_watchdog_fallbacks_total",
            "automatic degradations engaged")
        self._recent: List[Dict[str, Any]] = []

    def _remember(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._recent.append(entry)
            del self._recent[:-self._RECENT]

    def record_stall(self, report) -> None:
        """``report`` is a ``runtime.watchdog.StallReport``."""
        self._events.inc()
        if report.escalation > 1:
            self._escalations.inc()
        rt_metrics.counter("rsdl_watchdog_stalls_total",
                           "deadline misses by watch name",
                           name=report.name).inc()
        rt_telemetry.record("watchdog_stall", name=report.name,
                            escalation=int(report.escalation),
                            waited_s=float(report.waited_s),
                            detail=report.detail)
        self._remember({
            "name": report.name,
            "waited_s": float(report.waited_s),
            "deadline_s": float(report.deadline_s),
            "escalation": int(report.escalation),
            "detail": report.detail,
            "timestamp": float(report.timestamp),
        })

    def record_fallback(self, component: str, reason: str) -> None:
        self._fallbacks.inc()
        rt_telemetry.record("fallback", component=component, reason=reason)
        self._remember({"name": f"{component}:fallback",
                        "detail": reason, "timestamp": time.time()})

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            recent = list(self._recent)
        return {
            "watchdog_events": int(self._events.value),
            "stall_escalations": int(self._escalations.value),
            "fallbacks_engaged": int(self._fallbacks.value),
            "stalls_by_name": _children_by(
                "rsdl_watchdog_stalls_total", "name"),
            "recent_stalls": recent,
        }


def _children_by(name: str, label: str) -> Dict[str, int]:
    """``{label value: count}`` over a labelled registry counter."""
    out: Dict[str, int] = {}
    family = rt_metrics.get(name)
    if family is not None and hasattr(family, "children"):
        for labels, metric in family.children().items():
            out[dict(labels).get(label, "?")] = int(metric.value)
    return out


class FaultStats:
    """Process-wide sink for injected faults and their recoveries
    (``runtime/faults.py`` injects, ``runtime/retry.py`` retries,
    ``device_dataset`` records a copy recovered after a failure as a
    recompute, the shuffle records a map recomputed from lineage, a
    reduce re-run and a spill recomputed, a file quarantined and a
    recovery that ran out of attempts). The counts live in the metrics
    registry (``rsdl_fault*_total``, ``rsdl_fault_recovery_seconds``);
    the ring of quarantine reports and the recomputes by component (no
    registry family has that label) are per instance. Totals are
    monotonic, as :class:`WatchdogStats`'s."""

    _RECENT = 32  # the most recent quarantine reports kept

    def __init__(self):
        self._lock = threading.Lock()
        self._injected = rt_metrics.counter(
            "rsdl_faults_injected_total", "chaos faults fired")
        self._retries = rt_metrics.counter(
            "rsdl_fault_retries_total", "RetryPolicy backoffs taken")
        self._recomputes = rt_metrics.counter(
            "rsdl_fault_recomputes_total",
            "tasks re-executed successfully after a failure")
        self._quarantines = rt_metrics.counter(
            "rsdl_fault_quarantines_total",
            "input files dropped by on_bad_file='skip'")
        self._exhausted = rt_metrics.counter(
            "rsdl_fault_exhausted_total",
            "recoveries that ran out of attempts")
        self._recovery_latency = rt_metrics.histogram(
            "rsdl_fault_recovery_seconds", "recompute/recovery latency")
        self._recovery_latency_max = rt_metrics.gauge(
            "rsdl_fault_recovery_max_seconds",
            "largest single recovery latency")
        self._recomputes_by_component: Dict[str, int] = {}
        self._recent_quarantines: List[Dict[str, Any]] = []

    def record_injected(self, site: str, epoch: Optional[int] = None,
                        task: Optional[int] = None) -> None:
        self._injected.inc()
        rt_metrics.counter("rsdl_faults_injected_by_site_total",
                           "chaos faults fired by site", site=site).inc()

    def record_retry(self, component: str) -> None:
        self._retries.inc()
        rt_telemetry.record("fault_retry", component=component)

    def record_recompute(self, component: str, latency_s: float) -> None:
        self._recomputes.inc()
        self._recovery_latency.observe(latency_s)
        self._recovery_latency_max.max(latency_s)
        with self._lock:
            self._recomputes_by_component[component] = \
                self._recomputes_by_component.get(component, 0) + 1
        rt_telemetry.record("fault_recompute", component=component,
                            latency_s=latency_s)

    def record_quarantine(self, report) -> None:
        """``report`` is a ``runtime.faults.QuarantinedFile``."""
        self._quarantines.inc()
        rt_telemetry.record("fault_quarantine",
                            epoch=getattr(report, "epoch", None),
                            task=getattr(report, "file_index", None))
        with self._lock:
            self._recent_quarantines.append(report.as_dict())
            del self._recent_quarantines[:-self._RECENT]

    def record_exhausted(self, component: str) -> None:
        """A recovery (e.g. a lineage recompute) ran out of attempts."""
        self._exhausted.inc()
        rt_telemetry.record("fault_exhausted", component=component)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            by_component = dict(self._recomputes_by_component)
            recent = list(self._recent_quarantines)
        return {
            "recomputes_by_component": by_component,
            "quarantines": int(self._quarantines.value),
            "recent_quarantines": recent,
            "recoveries_exhausted": int(self._exhausted.value),
            "injected": int(self._injected.value),
            "injected_by_site": _children_by(
                "rsdl_faults_injected_by_site_total", "site"),
            "retries": int(self._retries.value),
            "recomputes": int(self._recomputes.value),
            "recovery_latency_total_s": self._recovery_latency.sum,
            "recovery_latency_max_s": self._recovery_latency_max.value,
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


# ---------------------------------------------------------------------------
# Registry totals and the CSV reports (the JAX package's column sets)
# ---------------------------------------------------------------------------


def _counter_total(name: str) -> int:
    """Process-lifetime total of a registry counter (0 if never made)."""
    family = rt_metrics.get(name)
    if family is None:
        return 0
    if hasattr(family, "children"):
        return int(sum(m.value for m in family.children().values()))
    return int(family.value)


def process_recovery_totals() -> Dict[str, int]:
    """Queue-service crash-recovery counters (monotonic; snapshot before
    and after a run)."""
    return {
        "queue_frames_replayed": _counter_total(
            "rsdl_queue_frames_replayed_total"),
        "queue_server_restarts": _counter_total(
            "rsdl_queue_server_restarts_total"),
        "queue_lease_expiries": _counter_total(
            "rsdl_queue_lease_expiries_total"),
        "queue_frames_nacked": _counter_total(
            "rsdl_queue_frames_nacked_total"),
        "queue_frames_corrupt": _counter_total(
            "rsdl_queue_frames_corrupt_total"),
        "queue_client_reconnects": _counter_total(
            "rsdl_queue_client_reconnects_total"),
    }


def queue_serve_totals() -> Dict[str, Any]:
    """Serving-plane byte and handle accounting (monotonic process
    totals). ``queue_compression_ratio`` is logical over wire bytes
    (1.0: no compression)."""
    payload = _counter_total("rsdl_queue_payload_bytes_total")
    wire = _counter_total("rsdl_queue_bytes_on_wire_total")
    saved = _counter_total("rsdl_queue_compression_saved_bytes_total")
    ratio = (wire + saved) / max(1, wire) if saved else 1.0
    return {
        "queue_payload_bytes": payload,
        "queue_bytes_on_wire": wire,
        "queue_handle_hits": _counter_total(
            "rsdl_queue_handle_hits_total"),
        "queue_handle_misses": _counter_total(
            "rsdl_queue_handle_misses_total"),
        "queue_compression_saved_bytes": saved,
        "queue_compression_ratio": round(ratio, 4),
        "serve_shards": int(_counter_total("rsdl_queue_serve_shards")),
    }


def _spread(prefix: str, values: List[float]) -> Dict[str, float]:
    arr = np.asarray(values) if values else np.asarray([0.0])
    return {
        f"avg_{prefix}": float(arr.mean()),
        f"std_{prefix}": float(arr.std()),
        f"max_{prefix}": float(arr.max()),
        f"min_{prefix}": float(arr.min()),
    }


TRIAL_FIELDNAMES = [
    "num_files", "num_row_groups_per_file", "num_reducers", "num_trainers",
    "num_epochs", "max_concurrent_epochs", "trial", "duration",
    "row_throughput", "batch_throughput", "batch_throughput_per_trainer",
    "avg_object_store_utilization", "max_object_store_utilization",
    "avg_epoch_duration", "std_epoch_duration", "max_epoch_duration",
    "min_epoch_duration",
    "avg_map_stage_duration", "std_map_stage_duration",
    "max_map_stage_duration", "min_map_stage_duration",
    "avg_reduce_stage_duration", "std_reduce_stage_duration",
    "max_reduce_stage_duration", "min_reduce_stage_duration",
    "avg_consume_stage_duration", "std_consume_stage_duration",
    "max_consume_stage_duration", "min_consume_stage_duration",
    "avg_map_task_duration", "std_map_task_duration",
    "max_map_task_duration", "min_map_task_duration",
    "avg_read_duration", "std_read_duration", "max_read_duration",
    "min_read_duration",
    "avg_reduce_task_duration", "std_reduce_task_duration",
    "max_reduce_task_duration", "min_reduce_task_duration",
    "avg_consume_task_duration", "std_consume_task_duration",
    "max_consume_task_duration", "min_consume_task_duration",
    "avg_time_to_consume", "std_time_to_consume", "max_time_to_consume",
    "min_time_to_consume",
    "watchdog_events", "stall_escalations", "fallbacks_engaged",
    "faults_injected", "fault_retries", "fault_recomputes",
    "fault_quarantines", "fault_recoveries_exhausted",
    # The telemetry verdict of the whole run at write time.
    "bottleneck_stage", "telemetry_stall_pct",
    "p95_map_read_ms", "p95_reduce_ms", "p95_queue_wait_ms",
    "p95_fetch_ms", "p95_convert_ms", "p95_device_transfer_ms",
    "p95_train_step_ms",
    "queue_frames_replayed", "queue_server_restarts",
    "queue_lease_expiries",
    "queue_bytes_on_wire", "queue_handle_hits", "queue_handle_misses",
    "queue_compression_ratio", "serve_shards",
]

EPOCH_FIELDNAMES = [
    "num_files", "num_row_groups_per_file", "num_reducers", "num_trainers",
    "num_epochs", "max_concurrent_epochs", "trial", "epoch", "duration",
    "row_throughput", "batch_throughput", "batch_throughput_per_trainer",
    "map_stage_duration", "reduce_stage_duration", "consume_stage_duration",
    "avg_map_task_duration", "std_map_task_duration",
    "max_map_task_duration", "min_map_task_duration",
    "avg_read_duration", "std_read_duration", "max_read_duration",
    "min_read_duration",
    "avg_reduce_task_duration", "std_reduce_task_duration",
    "max_reduce_task_duration", "min_reduce_task_duration",
    "avg_consume_task_duration", "std_consume_task_duration",
    "max_consume_task_duration", "min_consume_task_duration",
    "avg_time_to_consume", "std_time_to_consume", "max_time_to_consume",
    "min_time_to_consume",
]


def process_stats(all_stats: List[Tuple[TrialStats,
                                        List[Tuple[float, MemorySample]]]],
                  overwrite_stats: bool,
                  stats_dir: str,
                  no_epoch_stats: bool,
                  unique_stats: bool,
                  num_rows: int,
                  num_files: int,
                  num_row_groups_per_file: int,
                  batch_size: int,
                  num_reducers: int,
                  num_trainers: int,
                  num_epochs: int,
                  max_concurrent_epochs: int) -> None:
    """Write the trial and epoch CSVs (the JAX package's signature and
    columns; local paths or URIs through ``utils.fileio``) and print the
    summary."""
    fileio.makedirs(stats_dir)
    stats_list = [s for s, _ in all_stats]
    store_stats_list = [ss for _, ss in all_stats]
    times = [s.duration for s in stats_list]
    mean, std = float(np.mean(times)), float(np.std(times))
    all_samples = [sample.object_store_bytes_used
                   for trial_ss in store_stats_list
                   for _, sample in trial_ss]
    max_util = human_readable_size(max(all_samples)) if all_samples else "0 B"
    throughput_std = float(np.std(
        [num_epochs * num_rows / t for t in times]))
    batch_tp_std = float(np.std(
        [(num_epochs * num_rows / batch_size) / t for t in times]))
    print(f"\nMean over {len(times)} trials: {mean:.3f}s +- {std}")
    print(f"Mean throughput over {len(times)} trials: "
          f"{num_epochs * num_rows / mean:.2f} rows/s +- {throughput_std:.2f}")
    print(f"Mean batch throughput over {len(times)} trials: "
          f"{(num_epochs * num_rows / batch_size) / mean:.2f} batches/s +- "
          f"{batch_tp_std:.2f}")
    print(f"Max memory utilization over {len(all_samples)} samples: "
          f"{max_util}\n")

    write_mode = "w+" if overwrite_stats else "a+"
    hr_rows = human_readable_big_num(num_rows)
    hr_batch = human_readable_big_num(batch_size)
    now = datetime.datetime.now(datetime.timezone.utc).isoformat()

    def _open_report(kind: str):
        filename = f"{kind}_stats_{hr_rows}_rows_{hr_batch}_batch_size"
        filename += f"_{now}.csv" if unique_stats else ".csv"
        path = fileio.join(stats_dir, filename)
        return path, (overwrite_stats or fileio.file_size(path) == 0)

    static = {
        "num_files": num_files,
        "num_row_groups_per_file": num_row_groups_per_file,
        "num_reducers": num_reducers,
        "num_trainers": num_trainers,
        "num_epochs": num_epochs,
        "max_concurrent_epochs": max_concurrent_epochs,
    }
    wd = watchdog_stats().snapshot()
    fs = fault_stats().snapshot()
    recovery = process_recovery_totals()
    serve = queue_serve_totals()
    verdict = rt_telemetry.attribution().run_summary() or {}
    verdict_stages = verdict.get("stages", {})

    path, header = _open_report("trial")
    logger.info("Writing trial stats to %s", path)
    with fileio.open_text(path, write_mode) as f:
        writer = csv.DictWriter(f, fieldnames=TRIAL_FIELDNAMES)
        if header:
            writer.writeheader()
        for trial, (stats, trial_ss) in enumerate(all_stats):
            row: Dict[str, Any] = dict(static)
            row["trial"] = trial
            row["watchdog_events"] = wd["watchdog_events"]
            row["stall_escalations"] = wd["stall_escalations"]
            row["fallbacks_engaged"] = wd["fallbacks_engaged"]
            row["faults_injected"] = fs["injected"]
            row["fault_retries"] = fs["retries"]
            row["fault_recomputes"] = fs["recomputes"]
            row["fault_quarantines"] = fs["quarantines"]
            row["fault_recoveries_exhausted"] = fs["recoveries_exhausted"]
            row["bottleneck_stage"] = verdict.get("bottleneck_stage", "")
            row["telemetry_stall_pct"] = verdict.get("stall_pct", 0.0)
            for key in ("queue_frames_replayed", "queue_server_restarts",
                        "queue_lease_expiries"):
                row[key] = recovery[key]
            for key in ("queue_bytes_on_wire", "queue_handle_hits",
                        "queue_handle_misses", "queue_compression_ratio",
                        "serve_shards"):
                row[key] = serve[key]
            for stage in rt_telemetry.STAGES:
                row[f"p95_{stage}_ms"] = verdict_stages.get(
                    stage, {}).get("p95_ms", 0.0)
            row["duration"] = stats.duration
            row_tp = num_epochs * num_rows / stats.duration
            row["row_throughput"] = row_tp
            row["batch_throughput"] = row_tp / batch_size
            row["batch_throughput_per_trainer"] = (
                row_tp / batch_size / num_trainers)
            samples = [s.object_store_bytes_used for _, s in trial_ss]
            row["avg_object_store_utilization"] = (
                float(np.mean(samples)) if samples else 0.0)
            row["max_object_store_utilization"] = (
                float(np.max(samples)) if samples else 0.0)
            epochs = stats.epoch_stats
            row.update(_spread("epoch_duration",
                               [e.duration for e in epochs]))
            row.update(_spread("map_stage_duration",
                               [e.map_stats.stage_duration for e in epochs]))
            row.update(_spread(
                "reduce_stage_duration",
                [e.reduce_stats.stage_duration for e in epochs]))
            row.update(_spread(
                "consume_stage_duration",
                [e.consume_stats.stage_duration for e in epochs]))
            row.update(_spread("map_task_duration",
                               [d for e in epochs
                                for d in e.map_stats.task_durations]))
            row.update(_spread("read_duration",
                               [d for e in epochs
                                for d in e.map_stats.read_durations]))
            row.update(_spread("reduce_task_duration",
                               [d for e in epochs
                                for d in e.reduce_stats.task_durations]))
            row.update(_spread("consume_task_duration",
                               [d for e in epochs
                                for d in e.consume_stats.task_durations]))
            row.update(_spread("time_to_consume",
                               [d for e in epochs
                                for d in e.consume_stats.consume_times]))
            writer.writerow(row)

    if no_epoch_stats:
        return
    path, header = _open_report("epoch")
    logger.info("Writing epoch stats to %s", path)
    with fileio.open_text(path, write_mode) as f:
        writer = csv.DictWriter(f, fieldnames=EPOCH_FIELDNAMES)
        if header:
            writer.writeheader()
        for trial, (stats, _) in enumerate(all_stats):
            for epoch, e in enumerate(stats.epoch_stats):
                row = dict(static)
                row["trial"] = trial
                row["epoch"] = epoch
                row["duration"] = e.duration
                row_tp = num_rows / e.duration if e.duration else 0.0
                row["row_throughput"] = row_tp
                row["batch_throughput"] = row_tp / batch_size
                row["batch_throughput_per_trainer"] = (
                    row_tp / batch_size / num_trainers)
                row["map_stage_duration"] = e.map_stats.stage_duration
                row["reduce_stage_duration"] = e.reduce_stats.stage_duration
                row["consume_stage_duration"] = (
                    e.consume_stats.stage_duration)
                row.update(_spread("map_task_duration",
                                   e.map_stats.task_durations))
                row.update(_spread("read_duration",
                                   e.map_stats.read_durations))
                row.update(_spread("reduce_task_duration",
                                   e.reduce_stats.task_durations))
                row.update(_spread("consume_task_duration",
                                   e.consume_stats.task_durations))
                row.update(_spread("time_to_consume",
                                   e.consume_stats.consume_times))
                writer.writerow(row)
