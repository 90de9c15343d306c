"""Stream sources: where unbounded input comes from (own copy of the JAX
package's ``streaming/source.py``).

A :class:`StreamSource` yields :class:`StreamEvent` records, arriving
Parquet files with a monotone discovery index and a stream-time
timestamp. The events a source yields are a pure function of its
construction arguments and its journal, so a recovered source re-yields
the same sequence and the window assembler (``streaming/window.py``)
re-derives the same epochs: the ingest half of exactly once. The delivery
half is the queue service's watermark journal.

- :class:`DirectoryTailSource` tails a directory of arriving files. A
  directory's listing order is not stable across filesystems or a
  crash, so the discovery order is journaled (``checkpoint.StreamJournal``),
  and a recovered tail replays the manifest first.
- :class:`SyntheticEventSource` is a seeded arrival process over a fixed
  file pool: arrival times are pure functions of ``(seed, event_index)``
  through sha256, so a seed reproduces the same events on any host.

Host code: stdlib only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional, Sequence

from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One arrived file. ``index`` is the monotone discovery index (the
    event's identity in every journal); ``timestamp`` is stream time (a
    tailed file's mtime, a synthetic event's seeded arrival), in which
    watermarks and lateness are measured."""

    index: int
    path: str
    timestamp: float
    size_bytes: int


class StreamSource:
    """The contract: :meth:`poll` returns newly arrived events in a
    deterministic order, each once per instance. A recovered instance
    (same arguments, same journal) re-yields the same prefix before any
    new discovery; ``exhausted`` turns True when no event will ever
    arrive again (a bounded synthetic stream; a directory tail never
    exhausts)."""

    def poll(self, now: Optional[float] = None) -> List[StreamEvent]:
        """Events arrived since the last poll. ``now`` advances a source
        with its own clock (synthetic stream time); others ignore it."""
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        return False

    def close(self) -> None:
        """Release journal handles. Idempotent."""


class DirectoryTailSource(StreamSource):
    """Tail ``directory`` with a journaled discovery order.

    Each :meth:`poll` lists the directory and admits the files ending in
    ``suffix`` it has not seen, in lexicographic order, once they are
    non-empty (stage a file elsewhere and rename it in), giving each the
    next discovery index and appending its manifest record to the journal.
    At construction the manifest replays: journaled files come first, in
    journal order, with their journaled timestamps and sizes.
    """

    def __init__(self, directory: str, journal_path: Optional[str] = None,
                 suffix: str = ".parquet"):
        from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
        self._directory = directory
        self._suffix = suffix
        self._known = set()
        self._next_index = 0
        self._replay: List[StreamEvent] = []
        self._journal = None
        if journal_path:
            for entry in ckpt.StreamJournal.load(journal_path):
                if entry.get("kind") != "file":
                    continue
                event = StreamEvent(index=int(entry["n"]),
                                    path=str(entry["path"]),
                                    timestamp=float(entry["ts"]),
                                    size_bytes=int(entry["size"]))
                self._replay.append(event)
                self._known.add(event.path)
                self._next_index = max(self._next_index, event.index + 1)
            self._journal = ckpt.StreamJournal(journal_path)
            if self._replay:
                logger.info(
                    "directory tail %s: recovered %d journaled events "
                    "(next index %d)", directory, len(self._replay),
                    self._next_index)

    def poll(self, now: Optional[float] = None) -> List[StreamEvent]:
        events, self._replay = self._replay, []
        try:
            names = sorted(os.listdir(self._directory))
        except FileNotFoundError:
            names = []
        for name in names:
            if not name.endswith(self._suffix):
                continue
            path = os.path.join(self._directory, name)
            if path in self._known:
                continue
            try:
                stat = os.stat(path)
            except OSError:
                continue  # gone between the listing and the stat
            if stat.st_size == 0:
                continue  # still being written
            event = StreamEvent(index=self._next_index, path=path,
                                timestamp=float(stat.st_mtime),
                                size_bytes=int(stat.st_size))
            if self._journal is not None:
                self._journal.append({"kind": "file", "n": event.index,
                                      "path": event.path,
                                      "ts": event.timestamp,
                                      "size": event.size_bytes})
            self._known.add(path)
            self._next_index += 1
            events.append(event)
        return events

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None


class SyntheticEventSource(StreamSource):
    """A seeded arrival process over a fixed file pool.

    Event ``i`` names ``files[i % len(files)]`` and arrives after a gap of
    ``mean_interarrival_s`` times a jitter factor drawn from sha256 of
    ``(seed, i)`` (no RNG state). ``poll(now)`` releases every event not
    yet yielded whose arrival is at most ``now``; ``poll()`` releases
    exactly the next one. ``total_events`` bounds the stream (None:
    forever).
    """

    def __init__(self, files: Sequence[str], seed: int = 0,
                 mean_interarrival_s: float = 1.0,
                 jitter_pct: float = 25.0,
                 total_events: Optional[int] = None,
                 start_time: float = 0.0):
        if not files:
            raise ValueError("SyntheticEventSource needs at least one file")
        self._files = [str(f) for f in files]
        self.seed = int(seed)
        self.mean_interarrival_s = float(mean_interarrival_s)
        self.jitter_pct = float(jitter_pct)
        self.total_events = total_events
        self.start_time = float(start_time)
        self._cursor = 0
        self._sizes = {}
        self._arrivals: List[float] = []  # prefix sums, memoized

    def _draw(self, event_index: int) -> float:
        """Uniform in [0, 1) from a stable hash."""
        digest = hashlib.sha256(
            f"{self.seed}:arrival:{event_index}".encode()).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64)

    def _gap(self, event_index: int) -> float:
        jitter = 1.0 + (self.jitter_pct / 100.0) * (
            2.0 * self._draw(event_index) - 1.0)
        return self.mean_interarrival_s * max(0.0, jitter)

    def arrival_time(self, event_index: int) -> float:
        """The stream time event ``event_index`` arrives, a pure function
        of ``(seed, event_index)``."""
        while len(self._arrivals) <= event_index:
            prev = self._arrivals[-1] if self._arrivals else self.start_time
            self._arrivals.append(prev + self._gap(len(self._arrivals)))
        return self._arrivals[event_index]

    def _size(self, path: str) -> int:
        size = self._sizes.get(path)
        if size is None:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            self._sizes[path] = size
        return size

    def event(self, event_index: int) -> StreamEvent:
        path = self._files[event_index % len(self._files)]
        return StreamEvent(index=event_index, path=path,
                           timestamp=self.arrival_time(event_index),
                           size_bytes=self._size(path))

    def poll(self, now: Optional[float] = None) -> List[StreamEvent]:
        events: List[StreamEvent] = []
        while not self.exhausted:
            nxt = self.event(self._cursor)
            if now is not None and nxt.timestamp > now:
                break
            events.append(nxt)
            self._cursor += 1
            if now is None:
                break  # an unclocked poll releases exactly one event
        return events

    @property
    def exhausted(self) -> bool:
        return (self.total_events is not None
                and self._cursor >= self.total_events)
