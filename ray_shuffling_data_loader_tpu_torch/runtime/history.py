"""Bounded time series of metrics-registry snapshots (own copy of the JAX
package's ``runtime/history.py``).

The registry (runtime/metrics.py) answers "what are the totals now";
every health judgment (did throughput droop, does the ledger creep, is a
queue saturating) asks "what were they a few seconds ago". This module
keeps a fixed-memory ring of periodic registry snapshots, ticked on the
watchdog's monitor thread (``runtime/watchdog.py`` ``every()``), with the
views the detectors and the capsules read:

- :meth:`HistoryRing.series`: a gauge's or a counter's value over time,
  summed over the label children that match a filter;
- :meth:`HistoryRing.rate`: counter deltas over a smoothing window of
  ticks, as events/s (a negative delta, a counter reset, clamps to 0);
- :meth:`HistoryRing.slice`: a JSON window of the ring (what incident
  capsules embed), loadable by :func:`load_slice` and mergeable across
  pids by :func:`merged_series` (per-pid slices align on wall-clock
  buckets and sum).

The slice format is ``rsdl-history-v1``, the JAX package's byte for
byte: either package's :func:`load_slice` reads the other's slices, and
``tools/rsdl_incident.py`` reads the port's.

Each tick first refreshes ``rsdl_process_rss_bytes`` (from
``/proc/self/statm``) and ``rsdl_ledger_bytes_in_use`` (the native
buffer ledger), so the creep detector has series to judge; a gauge whose
source cannot be read stays absent.

Memory bound: ``history_capacity`` snapshots (600 by default: ten
minutes at the default 1 s ``history_interval_s``); the deque drops the
oldest.

Host code: stdlib only, imports no torch.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.runtime import metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy
from ray_shuffling_data_loader_tpu_torch.runtime import watchdog
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

_PAGE_SIZE = os.sysconf("SC_PAGESIZE") if hasattr(os, "sysconf") else 4096
_ledger_unavailable = False


def _rss_bytes() -> Optional[int]:
    """Resident set size from /proc (None off-Linux)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None


def _ledger_bytes() -> Optional[int]:
    """In-use bytes of the native buffer ledger (None, and never asked
    again, when the native library cannot load)."""
    global _ledger_unavailable
    if _ledger_unavailable:
        return None
    try:
        from ray_shuffling_data_loader_tpu_torch import native
        return int(native.buffer_ledger().bytes_in_use())
    except Exception:  # noqa: BLE001 - a library that cannot load: no series
        _ledger_unavailable = True
        return None


def _labels_key(labels: Tuple[Tuple[str, str], ...]) -> str:
    """JSON-object key for a label tuple (stable, round-trippable)."""
    return json.dumps(list(labels))


def _labels_from_key(key: str) -> Tuple[Tuple[str, str], ...]:
    return tuple((str(k), str(v)) for k, v in json.loads(key))


class HistoryRing:
    """Fixed-capacity ring of ``{t, t_unix, samples}`` snapshots."""

    def __init__(self, capacity: Optional[int] = None,
                 interval_s: Optional[float] = None):
        if capacity is None:
            capacity = policy.resolve("history", "history_capacity")
        if interval_s is None:
            interval_s = policy.resolve("history", "history_interval_s")
        self.capacity = int(capacity)
        self.interval_s = float(interval_s)
        self._snaps: "collections.deque" = collections.deque(
            maxlen=max(2, self.capacity))
        self._types: Dict[str, str] = {}
        self._listeners: List[Callable[["HistoryRing"], None]] = []
        self._lock = threading.Lock()
        self.ticks = 0

    # -- capture -------------------------------------------------------------

    def tick(self) -> Dict[str, Any]:
        """Snapshot the process registry (refreshing the resource gauges
        first) and notify the listeners (the health monitor). Runs on the
        watchdog's monitor thread."""
        rss = _rss_bytes()
        if rss is not None:
            metrics.gauge("rsdl_process_rss_bytes",
                          "resident set size sampled at history ticks"
                          ).set(rss)
        ledger = _ledger_bytes()
        if ledger is not None:
            metrics.gauge("rsdl_ledger_bytes_in_use",
                          "native buffer-ledger bytes sampled at history "
                          "ticks").set(ledger)
        samples, types = metrics.parse_exposition_typed(metrics.render())
        snap = {
            # t is monotonic (interval math); t_unix is SERIALIZED only —
            # the cross-pid alignment key of merged_series.
            "t": time.monotonic(),
            "t_unix": time.time(),
            "samples": samples,
        }
        with self._lock:
            self._types.update(types)
            self._snaps.append(snap)
            self.ticks += 1
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(self)
            except Exception:  # noqa: BLE001 - observers must not kill ticks
                logger.exception("history listener failed")
        return snap

    def append_snapshot(self, snap: Dict[str, Any]) -> None:
        """Append a pre-built snapshot (synthetic-series tests, slice
        loading). Listeners fire exactly as for a live tick."""
        with self._lock:
            self._snaps.append(snap)
            self.ticks += 1
            listeners = list(self._listeners)
        for listener in listeners:
            listener(self)

    def add_listener(self, fn: Callable[["HistoryRing"], None]) -> None:
        """Run ``fn(ring)`` after every tick — ordered AFTER the snapshot
        is appended, which is what lets the health engine evaluate the
        tick it was woken for instead of lagging one interval."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[["HistoryRing"], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    # -- views ---------------------------------------------------------------

    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._snaps)

    @staticmethod
    def _sample_value(snap: Dict[str, Any], name: str,
                      labels: Optional[Dict[str, str]]) -> Optional[float]:
        series = snap["samples"].get(name)
        if series is None:
            return None
        if labels is None:
            return sum(series.values())
        total = None
        for sample_labels, value in series.items():
            d = dict(sample_labels)
            if all(d.get(k) == str(v) for k, v in labels.items()):
                total = (total or 0.0) + value
        return total

    def series(self, name: str, labels: Optional[Dict[str, str]] = None
               ) -> List[Tuple[float, float]]:
        """``[(t_mono, value)]`` of a metric over the retained window,
        summed across label children matching the ``labels`` filter
        (None = all children). Snapshots predating the metric are
        skipped, not zero-filled."""
        out = []
        for snap in self.snapshots():
            value = self._sample_value(snap, name, labels)
            if value is not None:
                out.append((snap["t"], value))
        return out

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             window_ticks: int = 1) -> List[Tuple[float, float]]:
        """``[(t_mono, per-second rate)]`` from counter deltas over a
        smoothing window of ``window_ticks`` snapshots. Window > 1 is the
        droop detector's view: epoch-bursty counters (a process-backend
        epoch completes its maps all at once) smooth into a judgeable
        rate. Negative deltas (counter reset across a registry swap)
        clamp to zero."""
        pts = self.series(name, labels)
        window_ticks = max(1, int(window_ticks))
        out = []
        for i in range(window_ticks, len(pts)):
            t0, v0 = pts[i - window_ticks]
            t1, v1 = pts[i]
            dt = t1 - t0
            if dt <= 0:
                continue
            out.append((t1, max(0.0, v1 - v0) / dt))
        return out

    # -- serialization -------------------------------------------------------

    def slice(self, last_s: Optional[float] = None) -> Dict[str, Any]:
        """JSON-serializable window of the ring (newest ``last_s``
        seconds; None = everything retained) — what incident capsules
        embed and what :func:`merged_series` merges across pids."""
        snaps = self.snapshots()
        if last_s is not None and snaps:
            horizon = snaps[-1]["t"] - last_s
            snaps = [s for s in snaps if s["t"] >= horizon]
        return {
            "schema": "rsdl-history-v1",
            "pid": os.getpid(),
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "types": dict(self._types),
            "snapshots": [{
                "t": s["t"],
                "t_unix": s["t_unix"],
                "samples": {
                    name: {_labels_key(labels): value
                           for labels, value in series.items()}
                    for name, series in s["samples"].items()
                },
            } for s in snaps],
        }


def downsample_slice(data: Dict[str, Any],
                     max_snapshots: int = 120) -> Dict[str, Any]:
    """Bound a :meth:`HistoryRing.slice` payload to ``max_snapshots``
    snapshots by even-stride decimation that always keeps the newest
    snapshot (the one incident reviews start from) and the oldest (the
    pre-incident baseline). Capsule writers call this so a long-lived
    ring cannot balloon a forensic capsule; the result is still a valid
    ``rsdl-history-v1`` slice."""
    snaps = data.get("snapshots", [])
    if max_snapshots < 2 or len(snaps) <= max_snapshots:
        return data
    stride = (len(snaps) - 1) / float(max_snapshots - 1)
    keep = sorted({round(i * stride) for i in range(max_snapshots)}
                  | {0, len(snaps) - 1})
    out = dict(data)
    out["snapshots"] = [snaps[i] for i in keep if i < len(snaps)]
    return out


def load_slice(data: Dict[str, Any]) -> HistoryRing:
    """Rebuild a ring from :meth:`HistoryRing.slice` output."""
    if data.get("schema") != "rsdl-history-v1":
        raise ValueError(
            f"not an rsdl history slice (schema={data.get('schema')!r})")
    ring = HistoryRing(capacity=max(2, len(data.get("snapshots", []))),
                       interval_s=data.get("interval_s", 1.0))
    ring._types.update(data.get("types", {}))
    for s in data["snapshots"]:
        ring.append_snapshot({
            "t": s["t"],
            "t_unix": s["t_unix"],
            "samples": {
                name: {_labels_from_key(key): value
                       for key, value in series.items()}
                for name, series in s["samples"].items()
            },
        })
    return ring


def merged_series(slices: List[Dict[str, Any]], name: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> List[Tuple[float, float]]:
    """Cross-pid series: each slice's series aligns onto wall-clock
    buckets (the coarsest slice interval) with forward-fill, then the
    per-pid values SUM per bucket — counters and additive gauges both
    merge this way, mirroring :func:`metrics.merge_series` through time.
    Returns ``[(t_unix_bucket, value)]``."""
    if not slices:
        return []
    bucket_s = max(float(s.get("interval_s", 1.0)) for s in slices)
    per_slice: List[List[Tuple[float, float]]] = []
    for data in slices:
        ring = data if isinstance(data, HistoryRing) else load_slice(data)
        pts = []
        for snap in ring.snapshots():
            value = HistoryRing._sample_value(snap, name, labels)
            if value is not None:
                pts.append((snap["t_unix"], value))
        if pts:
            per_slice.append(pts)
    if not per_slice:
        return []
    buckets = sorted({round(t / bucket_s) * bucket_s
                      for pts in per_slice for t, _ in pts})
    out = []
    for bucket in buckets:
        total = 0.0
        seen = False
        for pts in per_slice:
            last = None
            for t, value in pts:
                if t <= bucket + bucket_s / 2:
                    last = value
                else:
                    break
            if last is not None:
                total += last
                seen = True
        if seen:
            out.append((bucket, total))
    return out


# ---------------------------------------------------------------------------
# Process-wide wiring: ONE ring ticked from the watchdog monitor thread
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[HistoryRing] = None
_periodic = None


def get_history() -> Optional[HistoryRing]:
    """The process-wide ring (None until :func:`start`)."""
    with _global_lock:
        return _global


def start(interval_s: Optional[float] = None,
          capacity: Optional[int] = None) -> HistoryRing:
    """Start (or restart with fresh state) the process-wide history
    ring, ticked by the watchdog's periodic facility. Returns the ring."""
    global _global, _periodic
    ring = HistoryRing(capacity=capacity, interval_s=interval_s)
    wd = watchdog.get_watchdog()
    with _global_lock:
        if _periodic is not None:
            wd.cancel(_periodic)
        _global = ring
        _periodic = wd.every(ring.interval_s, ring.tick,
                             name="history-tick")
    return ring


def stop() -> None:
    """Stop the process-wide ring's ticks and forget it."""
    global _global, _periodic
    with _global_lock:
        if _periodic is not None:
            watchdog.get_watchdog().cancel(_periodic)
            _periodic = None
        _global = None
