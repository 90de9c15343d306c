"""Windowed epoch assembly: events accumulate, windows seal, epochs run
(own copy of the JAX package's ``streaming/window.py``).

A window is an epoch. The :class:`WindowAssembler` admits events from a
``streaming.source.StreamSource``, seals a window at the first policy
bound hit (file count, payload bytes or stream-time age,
``RSDL_STREAM_WINDOW_*``) and turns each sealed window into a
``plan.ir.EpochSpec`` whose ``window`` carries its provenance. The shuffle
driver, the serving plane and the exactly-once resume take it as any
other epoch.

The ingest watermark is the largest stream timestamp sealed into a closed
window: monotone, and journaled (``checkpoint.StreamJournal``). An event
behind it is late: ``admit`` puts it into the open window (nothing is
lost), ``quarantine`` excludes it into :attr:`WindowAssembler.quarantined`
and counts it.

Recovery: assembly is deterministic in the admitted events, so a
restarted stream reads from its journal how many events are sealed
(:func:`resume_state`), skips that prefix of the source's re-yielded
sequence and seals the same windows at the same boundaries.

Host code: imports no torch.
"""

from __future__ import annotations

import dataclasses
import time
import timeit
from typing import Any, Dict, Iterator, List, Optional

from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.streaming.source import (
    StreamEvent, StreamSource)

#: ``window_late_policy``'s values.
LATE_POLICIES = ("admit", "quarantine")


@dataclasses.dataclass(frozen=True)
class WindowPolicy:
    """When a window seals (the first bound hit; 0 disables a bound) and
    what happens to late events."""

    max_files: int = 4
    max_bytes: int = 0
    max_wait_s: float = 0.0
    late_policy: str = "admit"

    def __post_init__(self):
        if self.late_policy not in LATE_POLICIES:
            raise ValueError(
                f"late_policy {self.late_policy!r} not in {LATE_POLICIES}")

    @classmethod
    def resolve(cls, max_files: Optional[int] = None,
                max_bytes: Optional[int] = None,
                max_wait_s: Optional[float] = None,
                late_policy: Optional[str] = None) -> "WindowPolicy":
        """Resolve through the policy registry (component ``stream``);
        arguments override. With every bound disabled, ``max_files`` is
        1."""
        def res(key, override):
            return rt_policy.resolve("stream", key, override=override)
        max_files = int(res("window_max_files", max_files))
        max_bytes = int(res("window_max_bytes", max_bytes))
        max_wait_s = float(res("window_max_wait_s", max_wait_s))
        if max_files <= 0 and max_bytes <= 0 and max_wait_s <= 0:
            max_files = 1
        return cls(max_files=max_files, max_bytes=max_bytes,
                   max_wait_s=max_wait_s,
                   late_policy=str(res("window_late_policy", late_policy)))

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Window:
    """One sealed window: its events and its ingest watermark."""

    index: int
    events: List[StreamEvent]
    ingest_watermark: float
    late_events: int = 0

    @property
    def filenames(self) -> List[str]:
        return [e.path for e in self.events]

    @property
    def size_bytes(self) -> int:
        return sum(e.size_bytes for e in self.events)

    def meta(self, policy: WindowPolicy) -> Dict[str, Any]:
        """The provenance stamped on the window's epoch plan."""
        return {"index": self.index,
                "events": [e.index for e in self.events],
                "ingest_watermark": self.ingest_watermark,
                "late_events": self.late_events,
                "policy": policy.as_dict()}

    def to_epoch_spec(self, epoch: int,
                      policy: WindowPolicy) -> plan_ir.EpochSpec:
        return plan_ir.EpochSpec(epoch=epoch,
                                 filenames=tuple(self.filenames),
                                 window=self.meta(policy))


class WindowAssembler:
    """Admit events, seal windows, journal the ingest watermark.

    Window 0 is epoch ``first_epoch``; ``first_window`` is the first
    window's index (a resumed stream's). Each sealed window appends one
    durable record to ``journal`` (a ``checkpoint.StreamJournal``), which
    :func:`resume_state` reads back.
    """

    def __init__(self, policy: Optional[WindowPolicy] = None, journal=None,
                 first_epoch: int = 0, first_window: int = 0):
        self.policy = policy or WindowPolicy.resolve()
        self._journal = journal
        self._first_epoch = first_epoch
        self._window_index = first_window
        self._pending: List[StreamEvent] = []
        self._pending_late = 0
        self._opened_at: Optional[float] = None  # wall clock, close timing
        self.ingest_watermark = float("-inf")
        self.events_sealed = 0
        self.quarantined: List[StreamEvent] = []
        self._late_total = 0
        self._gauge_window = rt_metrics.gauge(
            "rsdl_stream_window", "index of the currently-open window")
        self._gauge_ingest = rt_metrics.gauge(
            "rsdl_stream_ingest_watermark",
            "stream time sealed into closed windows")
        self._counter_closed = rt_metrics.counter(
            "rsdl_stream_windows_closed_total", "windows sealed")
        self._counter_admitted = rt_metrics.counter(
            "rsdl_stream_events_admitted_total",
            "events admitted into windows")
        self._hist_close = rt_metrics.histogram(
            "rsdl_stream_window_close_seconds",
            "wall time from a window's first event to its seal")

    @property
    def window_index(self) -> int:
        """The open window's index."""
        return self._window_index

    @property
    def next_epoch(self) -> int:
        return self._first_epoch + self._window_index

    @property
    def pending_events(self) -> int:
        return len(self._pending)

    @property
    def late_events(self) -> int:
        """Late events seen so far, under either policy."""
        return self._late_total

    def admit(self, event: StreamEvent) -> bool:
        """Admit one event into the open window; False when it was
        quarantined (late, under ``quarantine``)."""
        if event.timestamp < self.ingest_watermark:
            self._late_total += 1
            rt_metrics.counter(
                "rsdl_stream_late_events_total",
                "events arriving behind the ingest watermark",
                policy=self.policy.late_policy).inc()
            rt_telemetry.record("stream_late_event", index=event.index,
                                policy=self.policy.late_policy)
            if self.policy.late_policy == "quarantine":
                self.quarantined.append(event)
                return False
            self._pending_late += 1
        if self._opened_at is None:
            self._opened_at = timeit.default_timer()
        self._pending.append(event)
        self._counter_admitted.inc()
        self._gauge_window.set(self._window_index)
        return True

    def should_close(self) -> bool:
        if not self._pending:
            return False
        policy = self.policy
        if policy.max_files > 0 and len(self._pending) >= policy.max_files:
            return True
        if policy.max_bytes > 0 and sum(
                e.size_bytes for e in self._pending) >= policy.max_bytes:
            return True
        if policy.max_wait_s > 0:
            stamps = [e.timestamp for e in self._pending]
            if max(stamps) - min(stamps) >= policy.max_wait_s:
                return True
        return False

    def close_window(self) -> Optional[Window]:
        """Seal the open window whatever the bounds (the stream's end);
        None when nothing is pending."""
        if not self._pending:
            return None
        events, self._pending = self._pending, []
        late, self._pending_late = self._pending_late, 0
        # A window of late events alone cannot move the watermark back.
        watermark = max(self.ingest_watermark,
                        max(e.timestamp for e in events))
        window = Window(index=self._window_index, events=events,
                        ingest_watermark=watermark, late_events=late)
        self.ingest_watermark = watermark
        self.events_sealed += len(events)
        self._window_index += 1
        if self._opened_at is not None:
            self._hist_close.observe(
                timeit.default_timer() - self._opened_at)
            self._opened_at = None
        if self._journal is not None:
            self._journal.append({
                "kind": "watermark", "window": window.index,
                "events": self.events_sealed,
                "watermark": window.ingest_watermark,
                "late": window.late_events,
                "files": len(window.events)})
        self._counter_closed.inc()
        self._gauge_ingest.set(watermark)
        rt_telemetry.record("stream_window_closed", window=window.index,
                            files=len(window.events), late=late)
        return window

    def maybe_close(self) -> Optional[Window]:
        return self.close_window() if self.should_close() else None

    def specs(self, source: StreamSource,
              max_windows: Optional[int] = None,
              clock_step_s: Optional[float] = None,
              poll_interval_s: float = 0.05
              ) -> Iterator[plan_ir.EpochSpec]:
        """Poll ``source``, admit, seal and yield one ``EpochSpec`` per
        sealed window: the iterator ``shuffle.shuffle_epochs`` drives. It
        ends when the source exhausts (the remainder sealed) or after
        ``max_windows``. ``clock_step_s`` advances a self-clocked source
        by that much stream time per poll (None: unclocked polls). An
        empty poll of a live source sleeps ``poll_interval_s``: this
        generator blocks between arrivals while the driver's launched
        epochs go on draining."""
        now = None
        produced = 0
        while max_windows is None or produced < max_windows:
            if clock_step_s is not None:
                now = clock_step_s if now is None else now + clock_step_s
            events = source.poll(now)
            for event in events:
                self.admit(event)
                window = self.maybe_close()
                if window is not None:
                    yield window.to_epoch_spec(
                        self._first_epoch + window.index, self.policy)
                    produced += 1
                    if max_windows is not None and produced >= max_windows:
                        return
            if not events:
                if source.exhausted:
                    window = self.close_window()
                    if window is not None:
                        yield window.to_epoch_spec(
                            self._first_epoch + window.index, self.policy)
                    return
                if clock_step_s is None and poll_interval_s > 0:
                    time.sleep(poll_interval_s)


def resume_state(journal_path: str) -> Dict[str, Any]:
    """What a restarted stream reads from its ingest journal: the first
    unsealed window (``next_window``), the events already in sealed
    windows (``events_sealed``: the prefix of the source's sequence to
    skip) and the ``ingest_watermark``. A torn tail is skipped."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    state = {"next_window": 0, "events_sealed": 0,
             "ingest_watermark": float("-inf")}
    for entry in ckpt.StreamJournal.load(journal_path):
        if entry.get("kind") != "watermark":
            continue
        state["next_window"] = max(state["next_window"],
                                   int(entry["window"]) + 1)
        state["events_sealed"] = max(state["events_sealed"],
                                     int(entry["events"]))
        state["ingest_watermark"] = max(state["ingest_watermark"],
                                        float(entry["watermark"]))
    return state


def freeze_schedule(source: StreamSource,
                    policy: Optional[WindowPolicy] = None,
                    max_windows: Optional[int] = None,
                    first_epoch: int = 0,
                    journal=None) -> List[plan_ir.EpochSpec]:
    """Drain a bounded source into a frozen window schedule: the explicit
    per-epoch file lists a supervised queue server
    (``multiqueue_service.serve_pipeline``, ``config["epochs"]``)
    re-derives the same way on every restart."""
    assembler = WindowAssembler(policy=policy, journal=journal,
                                first_epoch=first_epoch)
    return list(assembler.specs(source, max_windows=max_windows))


def specs_to_dicts(specs: List[plan_ir.EpochSpec]) -> List[Dict[str, Any]]:
    """The JSON form of a frozen schedule (the served config's
    ``epochs``); ``tenant_id`` and ``num_reducers`` appear only when
    set."""
    out = []
    for s in specs:
        d = {"epoch": s.epoch, "filenames": list(s.filenames),
             "window": s.window}
        if s.tenant_id is not None:
            d["tenant_id"] = s.tenant_id
        if s.num_reducers is not None:
            d["num_reducers"] = int(s.num_reducers)
        out.append(d)
    return out


def specs_from_dicts(data) -> List[plan_ir.EpochSpec]:
    return [plan_ir.EpochSpec(
                epoch=int(d["epoch"]),
                filenames=tuple(str(f) for f in d["filenames"]),
                window=(dict(d["window"])
                        if d.get("window") is not None else None),
                tenant_id=d.get("tenant_id"),
                num_reducers=(int(d["num_reducers"])
                              if d.get("num_reducers") is not None
                              else None))
            for d in data]
