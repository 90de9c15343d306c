"""Elastic world membership: journaled views, failure-detected shrink,
boundary grow and generation fencing (own copy of the JAX package's
``membership/``).

- :class:`MembershipView`: one immutable world composition
  ``(view_id, ranks, incarnations)``. The rank set is the reducer hosts;
  the incarnation of a rank counts its process generations (a rank that
  dies and rejoins comes back one higher, which lets the transport fence
  the frames of its zombie predecessor).
- :func:`apply_event`: the one pure transition function. Every view is a
  fold of events over the bootstrap view, with no wall clock and no
  dict-order dependence, so a journal replays byte for byte.
- :class:`MembershipJournal`: a crc'd append-only JSONL journal
  (``checkpoint.crc_line``; torn tails skipped, atomic compact) of view
  changes; :func:`replay` re-derives every journaled view through
  :func:`apply_event` and raises on any byte that differs. A journal
  written by either package replays in the other.
- :class:`MembershipManager`: the runtime hub. It owns the current view,
  journals transitions, fans them out to listeners (the elastic runner,
  transports) and records the ``member_*`` events and the
  ``rsdl_member_*`` metrics.

Resize semantics (``membership/elastic.py``): on ``member_down`` the
current epoch completes degraded. The dead rank's reducers are placed on
the survivors (``plan.ir.reduce_placement`` over the shrunken rank set)
and their outputs regenerated from ``(seed, epoch, reducer)`` lineage,
exactly once against the delivery ledger. On ``member_join`` the world
grows at the next epoch. Placement never changes content: a reducer output
is a pure function of its lineage key, so a resized run's stream equals
the fixed world's bit for bit.

The serving plane's listener is the queue server's
(``multiqueue_service.QueueServer.attach_membership``: a ``down`` verdict
expires the rank's consumer leases). A stream resizes at window
boundaries: ``streaming.StreamingShuffleRunner(membership=)`` reads the
view at each window's seal and gives the window the live world's reducer
count (:func:`reducers_for_view`).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: Journaled event kinds. ``bootstrap``/``snapshot`` carry a whole view
#: (journal base lines); ``down``/``join`` are the deltas folded over it.
EVENT_KINDS = ("bootstrap", "snapshot", "down", "join")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One world transition. ``rank``/``incarnation`` mean something for
    ``down``/``join``; base records (``bootstrap``/``snapshot``) use rank
    -1. ``reason`` is free text, inside the crc'd line, so it replays
    byte for byte too."""

    kind: str
    rank: int = -1
    incarnation: int = 0
    reason: str = ""

    def to_dict(self) -> dict:
        return {"kind": self.kind, "rank": self.rank,
                "incarnation": self.incarnation, "reason": self.reason}

    @classmethod
    def from_dict(cls, data: dict) -> "MembershipEvent":
        return cls(kind=data["kind"], rank=int(data["rank"]),
                   incarnation=int(data["incarnation"]),
                   reason=data.get("reason", ""))


@dataclasses.dataclass(frozen=True)
class MembershipView:
    """One immutable world composition.

    ``ranks`` is the sorted live rank set; ``incarnations`` maps every rank
    ever seen, live or not, to its latest process generation, so that a
    rejoin resumes at the next generation and the transport can fence the
    dead generation's frames.
    """

    view_id: int
    ranks: Tuple[int, ...]
    incarnations: Tuple[Tuple[int, int], ...]  # sorted (rank, incarnation)

    def live(self, rank: int) -> bool:
        return rank in self.ranks

    def incarnation(self, rank: int) -> int:
        for r, inc in self.incarnations:
            if r == rank:
                return inc
        return 0

    def to_dict(self) -> dict:
        return {"view_id": self.view_id, "ranks": list(self.ranks),
                "incarnations": [[r, i] for r, i in self.incarnations]}

    @classmethod
    def from_dict(cls, data: dict) -> "MembershipView":
        return cls(view_id=int(data["view_id"]),
                   ranks=tuple(int(r) for r in data["ranks"]),
                   incarnations=tuple((int(r), int(i))
                                      for r, i in data["incarnations"]))

    @classmethod
    def bootstrap(cls, ranks: Sequence[int],
                  incarnations: Optional[Dict[int, int]] = None
                  ) -> "MembershipView":
        ranks = tuple(sorted(set(int(r) for r in ranks)))
        incarnations = incarnations or {}
        pairs = tuple(sorted((r, int(incarnations.get(r, 0)))
                             for r in ranks))
        return cls(view_id=0, ranks=ranks, incarnations=pairs)


def apply_event(view: MembershipView,
                event: MembershipEvent) -> MembershipView:
    """The pure view transition ``(view, event) -> view``.

    Events that would not change the world (downing an absent rank, a join
    that is not a newer generation of the rank) return ``view`` itself:
    the manager never journals those, so replay never sees them.
    """
    if event.kind not in EVENT_KINDS:
        raise ValueError(f"unknown membership event kind {event.kind!r}")
    if event.kind in ("bootstrap", "snapshot"):
        raise ValueError(
            f"{event.kind} records carry their own view; apply_event "
            "folds only down/join deltas")
    incarnations = dict(view.incarnations)
    if event.kind == "down":
        if event.rank not in view.ranks:
            return view
        ranks = tuple(r for r in view.ranks if r != event.rank)
        pairs = tuple(sorted(incarnations.items()))
        return MembershipView(view.view_id + 1, ranks, pairs)
    # join: only a strictly newer generation of a live rank (a restart the
    # detector never saw die), or a generation of an absent rank at or
    # above its last known incarnation, changes the world.
    known = incarnations.get(event.rank, -1) if event.rank in view.ranks \
        else incarnations.get(event.rank, 0) - 1
    if event.incarnation <= known:
        return view
    incarnations[event.rank] = event.incarnation
    ranks = tuple(sorted(set(view.ranks) | {event.rank}))
    pairs = tuple(sorted(incarnations.items()))
    return MembershipView(view.view_id + 1, ranks, pairs)


def next_incarnation(view: MembershipView, rank: int) -> int:
    """The generation a (re)joining ``rank`` must announce: one past its
    latest known incarnation (0 for a rank never seen)."""
    for r, inc in view.incarnations:
        if r == rank:
            return inc + 1
    return 0


def _checkpoint():
    # Imported on first use: ``checkpoint`` loads torch, which a process
    # that only probes heartbeats (``membership.detector``) never needs.
    from ray_shuffling_data_loader_tpu_torch import checkpoint
    return checkpoint


class MembershipJournal:
    """Crc'd append-only journal of membership view changes.

    Each line is ``{"event": ..., "view": ...}`` in the
    :func:`checkpoint.crc_line` discipline. The recorded view is the
    result of folding the event over the previous line's view, which makes
    the file self-verifying: :func:`replay` re-runs the fold and any
    difference (tamper, version skew, an unjournaled transition) raises.
    The first line is always a base record (``bootstrap``, or ``snapshot``
    after :meth:`compact`) that carries the whole view.

    ``path=None`` keeps the journal in memory; with a path every line is
    flushed and fsync'd before the transition is visible, so a crashed
    coordinator restarts into the world it last advertised.
    """

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = threading.Lock()
        self._file = None
        self._lines: List[str] = []

    @property
    def path(self) -> Optional[str]:
        return self._path

    @staticmethod
    def encode(event: MembershipEvent, view: MembershipView) -> str:
        return _checkpoint().crc_line({"event": event.to_dict(),
                                       "view": view.to_dict()})

    def record(self, event: MembershipEvent, view: MembershipView) -> None:
        line = self.encode(event, view)
        with self._lock:
            self._lines.append(line)
            if self._path is not None:
                if self._file is None:
                    directory = os.path.dirname(os.path.abspath(self._path))
                    os.makedirs(directory, exist_ok=True)
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(line + "\n")
                self._file.flush()
                os.fsync(self._file.fileno())

    def journal_bytes(self) -> bytes:
        """The journal as written (what replay is compared against)."""
        with self._lock:
            return "".join(line + "\n" for line in self._lines).encode()

    @classmethod
    def load(cls, path: str) -> List[dict]:
        """Every intact ``{"event", "view", "line"}`` record in append
        order. A torn tail line (a crash mid-write) is skipped with a
        warning; an unreadable line with intact lines after it is
        corruption and raises, since an interior gap would rewrite
        history."""
        records: List[dict] = []
        bad: Optional[Tuple[int, str]] = None
        if not os.path.exists(path):
            return records
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = _checkpoint().parse_crc_line(line)
                    record = {"event": MembershipEvent.from_dict(
                                  entry["event"]),
                              "view": MembershipView.from_dict(
                                  entry["view"]),
                              "line": line}
                except (ValueError, KeyError, TypeError) as e:
                    if bad is not None:
                        raise ValueError(
                            f"membership journal {path}: multiple "
                            f"unreadable lines ({bad[0]}: {bad[1]}; "
                            f"{lineno}: {e}): corruption, not a torn "
                            "tail")
                    bad = (lineno, str(e))
                    continue
                if bad is not None:
                    raise ValueError(
                        f"membership journal {path}: line {bad[0]} "
                        f"unreadable ({bad[1]}) but line {lineno} is "
                        "intact: interior corruption, not a torn tail")
                records.append(record)
        if bad is not None:
            logger.warning(
                "membership journal %s line %d unreadable (%s); skipping "
                "(a torn tail from a crash)", path, bad[0], bad[1])
        return records

    def compact(self) -> None:
        """Rewrite the journal as one snapshot record of the latest view:
        temporary file, fsync, rename, directory fsync."""
        if self._path is None:
            raise ValueError("an in-memory journal has nothing to compact")
        records = self.load(self._path)
        if not records:
            return
        view = records[-1]["view"]
        line = self.encode(MembershipEvent(kind="snapshot",
                                           reason="compact"), view)
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            directory = os.path.dirname(os.path.abspath(self._path))
            os.makedirs(directory, exist_ok=True)
            fd, tmp_path = tempfile.mkstemp(dir=directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(line + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp_path, self._path)
                dir_fd = os.open(directory, os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
            except BaseException:
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
                raise
            self._lines = [line]

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def replay(path: str) -> MembershipView:
    """Rebuild the latest view from a journal and prove it: every
    ``down``/``join`` record's line must equal the encoding of
    ``apply_event(previous_view, event)``, and the journal must begin with
    a base record. Any difference raises ``ValueError``. Returns the
    verified latest view."""
    records = MembershipJournal.load(path)
    if not records:
        raise ValueError(f"membership journal {path} has no records")
    first = records[0]
    if first["event"].kind not in ("bootstrap", "snapshot"):
        raise ValueError(
            f"membership journal {path} does not begin with a "
            f"bootstrap/snapshot record (got {first['event'].kind!r})")
    view = first["view"]
    for index, record in enumerate(records[1:], 2):
        event = record["event"]
        if event.kind in ("bootstrap", "snapshot"):
            raise ValueError(
                f"membership journal {path} record {index}: base record "
                "after the journal head (history rewrite)")
        derived = apply_event(view, event)
        if MembershipJournal.encode(event, derived) != record["line"]:
            raise ValueError(
                f"membership journal {path} record {index} diverged on "
                f"replay: event {event.to_dict()} over view "
                f"{view.view_id} re-derives view {derived.to_dict()}, "
                "journal disagrees (tamper, corruption, or transition "
                "version skew)")
        if derived == view:
            raise ValueError(
                f"membership journal {path} record {index}: journaled "
                f"no-op event {event.to_dict()} (the manager never "
                "journals unchanged views)")
        view = derived
    return view


class MembershipManager:
    """The runtime membership hub: current view, journal and fan-out.

    Transitions come from the failure detector (``member_down``), from join
    announcements (``member_join``) or from chaos (``member_crash`` through
    :meth:`maybe_crash`). Each folds through :func:`apply_event`, is
    journaled, records its telemetry and metrics and is delivered to every
    listener ``cb(event, view)``.
    """

    def __init__(self, ranks: Sequence[int],
                 journal_path: Optional[str] = None,
                 incarnations: Optional[Dict[int, int]] = None):
        self._lock = threading.Lock()
        self._view = MembershipView.bootstrap(ranks, incarnations)
        self._journal = MembershipJournal(journal_path)
        self._listeners: List[Callable[[MembershipEvent, MembershipView],
                                       None]] = []
        self._journal.record(MembershipEvent(kind="bootstrap",
                                             reason="initial world"),
                             self._view)
        self._suspects: set = set()
        self._export(self._view)

    # -- state ---------------------------------------------------------------

    def current_view(self) -> MembershipView:
        with self._lock:
            return self._view

    @property
    def journal(self) -> MembershipJournal:
        return self._journal

    def add_listener(self, callback: Callable[[MembershipEvent,
                                               MembershipView],
                                              None]) -> None:
        with self._lock:
            self._listeners.append(callback)

    # -- transitions ---------------------------------------------------------

    def member_down(self, rank: int, reason: str = "") -> MembershipView:
        """A rank left the world (a detector verdict, an operator's
        drain). Downing an absent rank is a no-op."""
        return self._transition(MembershipEvent(
            kind="down", rank=int(rank),
            incarnation=self.current_view().incarnation(rank),
            reason=reason))

    def member_join(self, rank: int, incarnation: Optional[int] = None,
                    reason: str = "") -> MembershipView:
        """A rank (re)joined. ``incarnation=None`` assigns the rank's next
        generation: the number the joining process must announce on its
        transport so that frames from before its death stay fenced."""
        if incarnation is None:
            incarnation = next_incarnation(self.current_view(), int(rank))
        return self._transition(MembershipEvent(
            kind="join", rank=int(rank), incarnation=int(incarnation),
            reason=reason))

    def member_suspect(self, rank: int, flap: bool = False) -> None:
        """The detector's soft verdict: telemetry and a gauge only
        (suspicion is not a view change)."""
        with self._lock:
            self._suspects.add(int(rank))
            count = len(self._suspects)
        if flap:
            rt_metrics.counter(
                "rsdl_member_flaps_total",
                "suspect->alive->suspect flaps absorbed by "
                "hysteresis").inc()
            rt_telemetry.record("member_flap", task=int(rank))
        else:
            rt_metrics.counter(
                "rsdl_member_suspects_total",
                "ranks marked suspect by the failure detector").inc()
            rt_telemetry.record("member_suspect", task=int(rank))
        rt_metrics.gauge("rsdl_member_suspect",
                         "ranks currently suspect").set(count)

    def member_alive(self, rank: int) -> None:
        """The detector cleared a suspicion (the rank's beats resumed)."""
        with self._lock:
            self._suspects.discard(int(rank))
            count = len(self._suspects)
        rt_metrics.gauge("rsdl_member_suspect",
                         "ranks currently suspect").set(count)

    def maybe_crash(self, epoch: int, rank: int) -> bool:
        """The ``member_crash`` chaos site, asked by runners once per
        ``(epoch, rank)`` pickup: where the active spec matches, the rank
        is downed through the normal transition and the caller simulates
        the process's death. Returns whether the crash fired."""
        from ray_shuffling_data_loader_tpu_torch.runtime import (
            faults as rt_faults)
        try:
            rt_faults.inject("member_crash", epoch=epoch, task=rank)
        except rt_faults.InjectedFault as fault:
            self.member_down(rank, reason=f"member_crash chaos "
                                          f"({fault.rule})")
            return True
        return False

    def _transition(self, event: MembershipEvent) -> MembershipView:
        with self._lock:
            view = apply_event(self._view, event)
            if view == self._view:
                return view  # a no-op: never journaled, never fanned out
            self._view = view
            self._journal.record(event, view)
            if event.kind == "down":
                self._suspects.discard(event.rank)
            listeners = list(self._listeners)
        logger.warning(
            "membership: %s rank %d (incarnation %d) -> view %d with "
            "ranks %s%s", event.kind, event.rank, event.incarnation,
            view.view_id, list(view.ranks),
            f" ({event.reason})" if event.reason else "")
        rt_telemetry.record(f"member_{event.kind}", task=event.rank,
                            view=view.view_id,
                            incarnation=event.incarnation,
                            reason=event.reason)
        rt_metrics.counter(
            "rsdl_member_transitions_total",
            "membership view transitions by kind",
            kind=event.kind).inc()
        if event.kind == "down":
            rt_metrics.counter("rsdl_member_downs_total",
                               "ranks removed from the world").inc()
        else:
            rt_metrics.counter("rsdl_member_joins_total",
                               "ranks added to the world").inc()
        self._export(view)
        for callback in listeners:
            callback(event, view)
        return view

    def _export(self, view: MembershipView) -> None:
        rt_metrics.gauge("rsdl_member_view_id",
                         "current membership view id").set(view.view_id)
        rt_metrics.gauge("rsdl_member_live",
                         "live ranks in the current view").set(
            len(view.ranks))
        for rank, inc in view.incarnations:
            rt_metrics.gauge("rsdl_member_incarnation",
                             "latest process generation per rank",
                             rank=str(rank)).set(inc)
        rt_metrics.gauge(
            "rsdl_member_last_transition_unixtime",
            "wall-clock time of the last view transition").set(
            time.time())

    def close(self) -> None:
        self._journal.close()


def reducers_for_view(base_reducers: int, base_world: int,
                      view: MembershipView) -> int:
    """The reducer count a streaming window opened on ``view`` runs: the
    bootstrap ratio ``base_reducers / base_world`` scaled to the live rank
    count (at least 1). Batch mode never calls this: there the reducer
    count is fixed and only placement moves, which keeps a resized batch
    run bit-identical."""
    if base_world <= 0:
        raise ValueError("base_world must be > 0")
    per_rank = max(1, round(base_reducers / base_world))
    return max(1, per_rank * len(view.ranks))


__all__ = ["MembershipEvent", "MembershipView", "MembershipJournal",
           "MembershipManager", "apply_event", "next_incarnation",
           "replay", "reducers_for_view", "EVENT_KINDS"]
