"""Live queue rebalancing: journaled placement decisions and the
two-phase handoff that moves a live rank's queues between shards (own
copy of the JAX package's ``rebalance/``).

This package is the decision plane. The actuator, the PREPARE / ADOPT /
RELEASE wire protocol that moves a rank's queues from one shard to
another, is in ``multiqueue_service.py``; :func:`migrate` drives it end
to end.

- :class:`PlacementDecision`: one journaled decision (``intent``,
  ``commit``, ``abort``; ``bootstrap`` and ``snapshot`` are journal
  bases).
- :class:`PlacementState`: the immutable fold target: the committed
  ``overrides`` (rank -> shard), the placement ``generation`` (the fence
  stamped into every data frame) and at most one ``pending`` move.
- :func:`apply_decision`: the one pure transition. No wall clock and no
  dict-order dependence: a journal is a fold of decisions over its base,
  so :func:`replay` re-derives every line byte for byte and raises on any
  difference.
- :class:`RebalanceJournal`: a crc'd append-only JSONL journal
  (``checkpoint.crc_line``; a torn tail skipped, interior corruption
  raises, atomic compact). A journal written by either package replays
  in the other.
- :class:`RebalanceController`: owns the state, journals each decision
  before it takes effect, applies the ``RSDL_REBALANCE_*`` policy (the
  cooldown window and the most moves inside it) and, at a restart over a
  journal whose tail is an uncommitted intent, journals its abort: a
  driver killed mid-decision recovers to "source authoritative".

Crash matrix: a SIGKILL of the source shard mid-PREPARE or of the target
mid-ADOPT leaves the commit unjournaled, so the source stays
authoritative and its supervised restart resumes from its watermark
journal; a driver killed mid-decision aborts at its restart. In every
case the delivered stream is the fault-free one: adoption replays the
source's unacked frames from a CRC'd manifest and the client drops by
seq what it already delivered. A source that serves on after the move
stamps its frames with the old generation, and the client fences them
(``rsdl_rebalance_fenced_frames_total``).

The trigger closes the loop: :func:`slo_trigger` attaches a
``runtime.health.HealthMonitor`` with the one ``tenant_delivery_slo``
detector to a history ring. It reads the clients' per-tenant
``birth_to_delivered`` sketch, windowed over the ring's ticks, against
the controller's ``rebalance_slo_p99_s``. A breach that outlives the
monitor's hysteresis fires once per episode, and the fire calls
:func:`migrate` with the fire's ``detail`` as the journaled reason. The
controller's ``rebalance_cooldown_s`` and ``rebalance_max_moves`` still
gate a repeated fire. An operator or chaos can drive :func:`migrate`
directly too.

Host code: imports no torch.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: Journaled decision kinds. ``bootstrap``/``snapshot`` carry a whole
#: state (journal base lines); the rest are the deltas folded over it.
DECISION_KINDS = ("bootstrap", "snapshot", "intent", "commit", "abort")


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """One placement transition. ``rank``/``source``/``target`` mean
    something for ``intent``/``commit``/``abort``; base records use rank
    -1. ``reason`` is free text, inside the crc'd line, so it replays
    byte for byte too."""

    kind: str
    rank: int = -1
    source: int = -1
    target: int = -1
    reason: str = ""

    def to_dict(self) -> dict:
        return {"kind": self.kind, "rank": self.rank,
                "source": self.source, "target": self.target,
                "reason": self.reason}

    @classmethod
    def from_dict(cls, data: dict) -> "PlacementDecision":
        return cls(kind=data["kind"], rank=int(data["rank"]),
                   source=int(data["source"]), target=int(data["target"]),
                   reason=data.get("reason", ""))


@dataclasses.dataclass(frozen=True)
class PlacementState:
    """One immutable placement: the committed rank -> shard ``overrides``
    over the static ``rank % num_shards``, the placement ``generation``
    (one higher per commit: the wire fence) and at most one ``pending``
    move ``(rank, source, target)`` between its intent and its commit or
    abort."""

    num_trainers: int
    num_shards: int
    generation: int
    overrides: Tuple[Tuple[int, int], ...]  # sorted (rank, shard)
    pending: Optional[Tuple[int, int, int]] = None

    def shard_for_rank(self, rank: int) -> int:
        for r, shard in self.overrides:
            if r == rank:
                return shard
        return rank % self.num_shards

    def to_dict(self) -> dict:
        return {"num_trainers": self.num_trainers,
                "num_shards": self.num_shards,
                "generation": self.generation,
                "overrides": [[r, s] for r, s in self.overrides],
                "pending": list(self.pending) if self.pending else None}

    @classmethod
    def from_dict(cls, data: dict) -> "PlacementState":
        pending = data.get("pending")
        return cls(num_trainers=int(data["num_trainers"]),
                   num_shards=int(data["num_shards"]),
                   generation=int(data["generation"]),
                   overrides=tuple((int(r), int(s))
                                   for r, s in data["overrides"]),
                   pending=tuple(int(v) for v in pending)
                   if pending else None)

    @classmethod
    def bootstrap(cls, shard_map: plan_ir.ShardMap) -> "PlacementState":
        return cls(num_trainers=shard_map.num_trainers,
                   num_shards=shard_map.num_shards,
                   generation=shard_map.generation,
                   overrides=tuple(sorted(
                       (int(r), int(s))
                       for r, s in shard_map.overrides.items())))


def apply_decision(state: PlacementState,
                   decision: PlacementDecision) -> PlacementState:
    """The pure placement transition ``(state, decision) -> state``.

    An ``intent`` whose target is the rank's current shard is a no-op
    (``state`` itself comes back; the controller never journals it). An
    intent over a pending move, or a commit or abort that does not name
    the pending move, raises: one move is in flight at a time."""
    if decision.kind not in DECISION_KINDS:
        raise ValueError(
            f"unknown placement decision kind {decision.kind!r}")
    if decision.kind in ("bootstrap", "snapshot"):
        raise ValueError(
            f"{decision.kind} records carry their own state; "
            "apply_decision folds only intent/commit/abort deltas")
    if decision.kind == "intent":
        if state.pending is not None:
            raise ValueError(
                f"intent for rank {decision.rank} while move "
                f"{state.pending} is pending (one move in flight)")
        if not 0 <= decision.rank < state.num_trainers:
            raise ValueError(f"intent for unknown rank {decision.rank}")
        if not 0 <= decision.target < state.num_shards:
            raise ValueError(
                f"intent routes rank {decision.rank} to unknown shard "
                f"{decision.target}")
        source = state.shard_for_rank(decision.rank)
        if decision.source != source:
            raise ValueError(
                f"intent names source {decision.source} but rank "
                f"{decision.rank} lives on shard {source}")
        if decision.target == source:
            return state  # a no-op: never journaled, never replayed
        return dataclasses.replace(
            state, pending=(decision.rank, source, decision.target))
    move = (decision.rank, decision.source, decision.target)
    if state.pending != move:
        raise ValueError(
            f"{decision.kind} for move {move} but pending is "
            f"{state.pending}")
    if decision.kind == "abort":
        return dataclasses.replace(state, pending=None)
    overrides = {r: s for r, s in state.overrides}
    if decision.target == decision.rank % state.num_shards:
        overrides.pop(decision.rank, None)  # back on its static home
    else:
        overrides[decision.rank] = decision.target
    return dataclasses.replace(
        state, generation=state.generation + 1,
        overrides=tuple(sorted(overrides.items())), pending=None)


class RebalanceJournal:
    """Crc'd append-only journal of placement decisions.

    Each line is ``{"decision": ..., "placement": ...}`` in the
    :func:`checkpoint.crc_line` discipline; the placement is the result
    of folding the decision over the previous line's, which is what makes
    the file self-verifying (:func:`replay`). The first line is a base
    record (``bootstrap``, or ``snapshot`` after :meth:`compact`).

    ``path=None`` keeps the journal in memory; with a path every line is
    flushed and fsync'd before the decision takes effect anywhere, so a
    crashed driver restarts into the decisions it last made."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = threading.Lock()
        self._file = None
        self._lines: List[str] = []

    @property
    def path(self) -> Optional[str]:
        return self._path

    @staticmethod
    def encode(decision: PlacementDecision, state: PlacementState) -> str:
        return ckpt.crc_line({"decision": decision.to_dict(),
                              "placement": state.to_dict()})

    def record(self, decision: PlacementDecision,
               state: PlacementState) -> None:
        line = self.encode(decision, state)
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
        """The journal as this process wrote it."""
        with self._lock:
            return "".join(line + "\n" for line in self._lines).encode()

    @classmethod
    def load(cls, path: str) -> List[dict]:
        """Every intact ``{"decision", "placement", "line"}`` record in
        order. A torn last line (a crash mid-write) is skipped with a
        warning; an unreadable line with intact lines after it is
        corruption and raises."""
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
                    entry = ckpt.parse_crc_line(line)
                    record = {"decision": PlacementDecision.from_dict(
                                  entry["decision"]),
                              "placement": PlacementState.from_dict(
                                  entry["placement"]),
                              "line": line}
                except (ValueError, KeyError, TypeError) as e:
                    if bad is not None:
                        raise ValueError(
                            f"rebalance journal {path}: multiple "
                            f"unreadable lines ({bad[0]}: {bad[1]}; "
                            f"{lineno}: {e}) — corruption, not a torn "
                            "tail")
                    bad = (lineno, str(e))
                    continue
                if bad is not None:
                    raise ValueError(
                        f"rebalance journal {path}: line {bad[0]} "
                        f"unreadable ({bad[1]}) but line {lineno} is "
                        "intact — interior corruption, not a torn tail")
                records.append(record)
        if bad is not None:
            logger.warning(
                "rebalance journal %s line %d unreadable (%s); skipping "
                "(torn tail from a crash is expected)", path, bad[0],
                bad[1])
        return records

    def compact(self) -> None:
        """Rewrite the journal as one snapshot record of the latest
        state (temporary file, fsync, rename, directory fsync)."""
        if self._path is None:
            raise ValueError("an in-memory journal has nothing to compact")
        records = self.load(self._path)
        if not records:
            return
        line = self.encode(PlacementDecision(kind="snapshot",
                                             reason="compact"),
                           records[-1]["placement"])
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            ckpt._atomic_write(self._path, line + "\n")
            self._lines = [line]

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def replay(path: str) -> PlacementState:
    """The latest placement of a journal, proven: every delta record's
    state must equal ``apply_decision`` of the previous state, re-encoded
    byte for byte against the journaled line, and the journal must start
    with a base record. Any difference raises ``ValueError`` (tamper,
    corruption or a changed transition)."""
    records = RebalanceJournal.load(path)
    if not records:
        raise ValueError(f"rebalance journal {path} has no records")
    first = records[0]
    if first["decision"].kind not in ("bootstrap", "snapshot"):
        raise ValueError(
            f"rebalance journal {path} does not begin with a "
            f"bootstrap/snapshot record (got {first['decision'].kind!r})")
    state = first["placement"]
    for index, record in enumerate(records[1:], 2):
        decision = record["decision"]
        if decision.kind in ("bootstrap", "snapshot"):
            raise ValueError(
                f"rebalance journal {path} record {index}: base record "
                "after the journal head (history rewrite)")
        derived = apply_decision(state, decision)
        if RebalanceJournal.encode(decision, derived) != record["line"]:
            raise ValueError(
                f"rebalance journal {path} record {index} diverged on "
                f"replay: decision {decision.to_dict()} over generation "
                f"{state.generation} re-derives {derived.to_dict()}, "
                "journal disagrees (tamper, corruption, or transition "
                "version skew)")
        if derived == state:
            raise ValueError(
                f"rebalance journal {path} record {index}: journaled "
                f"no-op decision {decision.to_dict()} (the controller "
                "never journals unchanged placements)")
        state = derived
    return state


class RebalanceController:
    """The placement decision hub: the current state, its journal and the
    policy.

    Decisions come from the ``tenant_delivery_slo`` detector's fire
    (:func:`slo_trigger`), an operator or chaos. Each folds through
    :func:`apply_decision`, is journaled before any actuator byte moves,
    and records the ``rebalance_*`` telemetry and metrics.

    A controller built over an existing journal replays it and, if its
    last record is an uncommitted ``intent``, journals the matching
    ``abort``: the driver died mid-decision, no commit was journaled, so
    the source shard is authoritative. ``rebalance_cooldown_s`` is the
    sliding window of :meth:`may_move` and ``rebalance_max_moves`` the
    commits allowed inside it."""

    def __init__(self, shard_map: plan_ir.ShardMap,
                 journal_path: Optional[str] = None,
                 component: str = "rebalance", **overrides: Any):
        def resolve(key):
            return rt_policy.resolve(component, key,
                                     override=overrides.get(key))

        self.slo_p99_s = float(resolve("rebalance_slo_p99_s"))
        self.cooldown_s = float(resolve("rebalance_cooldown_s"))
        self.max_moves = int(resolve("rebalance_max_moves"))
        self._lock = threading.Lock()
        self._base_map = shard_map
        self._journal = RebalanceJournal(journal_path)
        self._commit_times: List[float] = []
        self.moves_total = 0
        recovered = journal_path is not None and os.path.exists(
            journal_path) and os.path.getsize(journal_path) > 0
        if recovered:
            self._state = replay(journal_path)
        else:
            self._state = PlacementState.bootstrap(shard_map)
            self._journal.record(PlacementDecision(
                kind="bootstrap", reason="initial placement"), self._state)
        self._export(self._state)
        if recovered and self._state.pending is not None:
            self.abort(self._state.pending[0],
                       reason="controller restart with uncommitted "
                              "intent: source authoritative")

    def current_state(self) -> PlacementState:
        with self._lock:
            return self._state

    def current_map(self) -> plan_ir.ShardMap:
        """The live :class:`plan.ir.ShardMap`: the base addresses with the
        committed overrides and generation."""
        state = self.current_state()
        shard_map = plan_ir.ShardMap(
            num_trainers=self._base_map.num_trainers,
            addresses=[tuple(a) for a in self._base_map.addresses],
            version=self._base_map.version,
            overrides={r: s for r, s in state.overrides
                       if s != r % state.num_shards},
            generation=state.generation)
        shard_map.validate()
        return shard_map

    @property
    def journal(self) -> RebalanceJournal:
        return self._journal

    def may_move(self, now: Optional[float] = None) -> bool:
        """True while fewer than ``rebalance_max_moves`` commits fall in
        the trailing ``rebalance_cooldown_s`` window."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._commit_times = [t for t in self._commit_times
                                  if now - t < self.cooldown_s]
            return len(self._commit_times) < self.max_moves

    def pick_target(self, rank: int) -> int:
        """The least-loaded shard other than ``rank``'s current one (ranks
        per shard under the current placement; the lowest index breaks
        ties)."""
        state = self.current_state()
        source = state.shard_for_rank(rank)
        loads = {shard: 0 for shard in range(state.num_shards)}
        for r in range(state.num_trainers):
            loads[state.shard_for_rank(r)] += 1
        candidates = [(load, shard) for shard, load in sorted(loads.items())
                      if shard != source]
        if not candidates:
            return source
        return min(candidates)[1]

    def begin(self, rank: int, target: Optional[int] = None,
              reason: str = "") -> Optional[PlacementDecision]:
        """Journal an ``intent`` to move ``rank`` (to ``target``, or to
        :meth:`pick_target`'s choice). None when the move is a no-op or the
        budget is spent. The ``rebalance_abort`` chaos site fires here,
        after the intent is durable and before any actuator byte moves:
        the driver killed mid-decision."""
        if not self.may_move():
            logger.warning(
                "rebalance: move budget exhausted (%d moves / %.1fs "
                "window); skipping rank %d", self.max_moves,
                self.cooldown_s, rank)
            return None
        state = self.current_state()
        source = state.shard_for_rank(rank)
        if target is None:
            target = self.pick_target(rank)
        decision = PlacementDecision(kind="intent", rank=int(rank),
                                     source=int(source),
                                     target=int(target), reason=reason)
        if self._transition(decision) is None:
            return None
        # Keyed by the move's target generation, as the actuator's sites
        # and their telemetry are.
        rt_faults.inject("rebalance_abort", epoch=state.generation + 1,
                         task=int(rank))
        return decision

    def commit(self, rank: int, reason: str = "") -> PlacementState:
        """Journal the commit of the pending move. From this line on the
        target shard owns the rank and the generation is one higher (the
        source's later frames are fenced). Before the source's
        release."""
        pending = self.current_state().pending
        if pending is None or pending[0] != rank:
            raise ValueError(f"commit for rank {rank} but pending move "
                             f"is {pending}")
        state = self._transition(PlacementDecision(
            kind="commit", rank=pending[0], source=pending[1],
            target=pending[2], reason=reason))
        with self._lock:
            self._commit_times.append(time.monotonic())
            self.moves_total += 1
        rt_metrics.counter(
            "rsdl_rebalance_moves_total",
            "committed live queue migrations").inc()
        rt_metrics.gauge(
            "rsdl_rebalance_last_move_unixtime",
            "wall-clock time of the last committed migration").set(
            time.time())
        return state

    def abort(self, rank: int, reason: str = "") -> PlacementState:
        """Journal the abort of the pending move: the source shard stays
        authoritative and the placement does not change."""
        pending = self.current_state().pending
        if pending is None or pending[0] != rank:
            raise ValueError(f"abort for rank {rank} but pending move "
                             f"is {pending}")
        return self._transition(PlacementDecision(
            kind="abort", rank=pending[0], source=pending[1],
            target=pending[2], reason=reason))

    def _transition(self,
                    decision: PlacementDecision) -> Optional[PlacementState]:
        with self._lock:
            state = apply_decision(self._state, decision)
            if state == self._state:
                return None  # a no-op: never journaled
            self._state = state
            self._journal.record(decision, state)
        logger.warning(
            "rebalance: %s rank %d shard %d -> %d (generation %d)%s",
            decision.kind, decision.rank, decision.source,
            decision.target, state.generation,
            f" ({decision.reason})" if decision.reason else "")
        # ``epoch`` is the move's target generation (a commit's is the
        # folded one; an intent's and an abort's one short of it): the
        # key the chaos sites and the actuator's records share.
        move_gen = (state.generation if decision.kind == "commit"
                    else state.generation + 1)
        rt_telemetry.record(f"rebalance_{decision.kind}", epoch=move_gen,
                            task=decision.rank, source=decision.source,
                            target=decision.target,
                            generation=state.generation,
                            reason=decision.reason)
        rt_metrics.counter(
            "rsdl_rebalance_decisions_total",
            "journaled placement decisions by kind",
            kind=decision.kind).inc()
        self._export(state)
        return state

    def _export(self, state: PlacementState) -> None:
        rt_metrics.gauge(
            "rsdl_rebalance_generation",
            "current placement generation (bumps once per committed "
            "migration)").set(state.generation)
        rt_metrics.gauge(
            "rsdl_rebalance_overrides",
            "ranks currently living off their static home shard").set(
            len(state.overrides))

    def close(self) -> None:
        self._journal.close()


def migrate(controller: RebalanceController, rank: int,
            target: Optional[int] = None, reason: str = "",
            timeout_s: float = 30.0,
            phases: Optional[dict] = None) -> Optional[PlacementState]:
    """One live queue migration, end to end:

    1. journal the ``intent`` (:meth:`RebalanceController.begin`);
    2. PREPARE the source shard: it seals the rank and exports a CRC'd
       manifest (unacked frames, births, seq cursors);
    3. ADOPT the manifest on the target shard, at the new generation;
    4. journal the ``commit`` (a crash before this line recovers as an
       abort, the source authoritative);
    5. RELEASE the source: it drops the rank's queues and answers later
       GETs with a ``KIND_MOVED`` redirect to the target.

    A failure between the intent and the commit journals an ``abort``,
    unseals the source (a dead source unseals itself by restarting from
    its journal) and raises. A RELEASE that fails after the commit only
    warns: the target is authoritative and the fence drops the source's
    frames. Returns the committed state, or None when no move began.
    ``phases``, when given, gets each phase's seconds
    (``intent_to_commit_s``, ``prepare_s``, ``adopt_s``, ``release_s``)
    and the manifest's ``manifest_bytes`` and ``manifest_frames``."""
    from ray_shuffling_data_loader_tpu_torch import multiqueue_service as mqs
    t0 = time.perf_counter()
    decision = controller.begin(rank, target=target, reason=reason)
    if decision is None:
        return None
    shard_map = controller.current_map()
    generation = controller.current_state().generation + 1
    source_addr = tuple(shard_map.addresses[decision.source])
    target_addr = tuple(shard_map.addresses[decision.target])
    timing = {} if phases is None else phases
    try:
        t = time.perf_counter()
        manifest = mqs.rebalance_prepare(source_addr, rank,
                                         generation=generation,
                                         timeout_s=timeout_s)
        timing["prepare_s"] = time.perf_counter() - t
        timing["manifest_bytes"] = len(manifest)
        # One '"seq":' key per frame in the canonical JSON (the cursors
        # are "next_seq" and "acked_seq"; base64 has no quotes).
        timing["manifest_frames"] = manifest.count('"seq":')
        t = time.perf_counter()
        mqs.rebalance_adopt(target_addr, manifest, timeout_s=timeout_s)
        timing["adopt_s"] = time.perf_counter() - t
    except BaseException as e:
        controller.abort(rank, reason=f"handoff failed: {e}")
        try:
            mqs.rebalance_unseal(source_addr, rank, timeout_s=timeout_s)
        except OSError:
            pass  # a dead source unseals itself at its restart
        raise
    state = controller.commit(rank, reason=reason)
    timing["intent_to_commit_s"] = time.perf_counter() - t0
    t = time.perf_counter()
    try:
        mqs.rebalance_release(source_addr, rank, generation=generation,
                              target=target_addr, timeout_s=timeout_s)
        timing["release_s"] = time.perf_counter() - t
    except OSError as e:
        logger.warning("rebalance: release of rank %d on %s failed (%s); "
                       "relying on the generation fence", rank,
                       source_addr, e)
    return state


def slo_trigger(ring, controller: RebalanceController, rank: int,
                target: Optional[int] = None,
                fire_ticks: Optional[int] = None,
                clear_ticks: Optional[int] = None,
                phases: Optional[dict] = None, **threshold_overrides: Any):
    """Attach to ``ring`` (a ``runtime.history.HistoryRing``) a health
    monitor with the one ``tenant_delivery_slo`` detector, at the
    controller's ``rebalance_slo_p99_s``, whose fire migrates ``rank``
    (to ``target``, or to :meth:`RebalanceController.pick_target`'s
    choice) with the fire's ``detail`` as the reason. The fire runs where
    the ring ticks (a live ring: the watchdog's monitor thread). Returns
    the attached monitor; ``detach()`` it when done. ``fire_ticks`` and
    ``clear_ticks`` are the monitor's hysteresis (the ``health`` policy
    keys by default), ``phases`` goes to :func:`migrate`, and
    ``threshold_overrides`` (``slo_droop_window_ticks``) to the
    detector."""
    from ray_shuffling_data_loader_tpu_torch.runtime import health

    def on_fire(fire: dict) -> None:
        migrate(controller, rank, target=target, reason=fire["detail"],
                phases=phases)

    detectors = health.default_detectors(
        names=["tenant_delivery_slo"],
        rebalance_slo_p99_s=controller.slo_p99_s, **threshold_overrides)
    return health.HealthMonitor(
        ring, detectors=detectors, fire_ticks=fire_ticks,
        clear_ticks=clear_ticks, on_fire=on_fire, capture=False).attach()


__all__ = ["PlacementDecision", "PlacementState", "RebalanceJournal",
           "RebalanceController", "apply_decision", "replay", "migrate",
           "slo_trigger", "DECISION_KINDS"]
