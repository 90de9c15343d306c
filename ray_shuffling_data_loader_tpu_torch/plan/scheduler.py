"""Plan-driven execution engine: dependency-ordered dispatch, speculative
re-execution of stragglers, work-stealing placement, stage barriers and
idle-lane prefetch (own copy of the JAX package's ``plan/scheduler.py``;
its membership rewrites come with membership).

It executes an :class:`plan.ir.EpochPlan` on any pool with the
``executor.Executor`` contract:

- **Dependency-ordered dispatch**: a node is submitted only when every
  dependency has *resolved* (completed, successfully or not: failure
  semantics stay with the consumer, e.g. a reduce's ``EpochLineage``
  recovery of a failed map). No worker is parked on an unfinished input.
- **Speculative re-execution** (``RSDL_PLAN_SPECULATION``, off by
  default): when a running task has run longer than a multiple of its
  stage's rolling median (``RSDL_PLAN_SPECULATION_MULTIPLIER``, floored
  by ``RSDL_PLAN_SPECULATION_MIN_S``) and a lane is idle, a backup attempt
  of the same node launches. Every task is a pure function of its
  lineage key, so duplicates are bit-identical; the first completion
  wins and the loser is cancelled if still queued, else discarded.
- **Work stealing** (``RSDL_PLAN_STEALING``, on by default): nodes are
  placed on lanes (one per pool worker, ``task % lanes``); an idle lane
  whose queue is empty takes the oldest ready node of the longest
  sibling queue. Outputs are the same either way.
- **Stage barriers** (``barriers={stage: fn}``): ``fn`` runs once on the
  driver thread when every node of the stage has resolved, before any
  dependent dispatches. The process pool collects its maps' segment
  replies in one (with its lineage re-run), never blocking a pool
  dispatcher thread.
- **Idle-lane prefetch** (``prefetcher=``, ``storage/prefetch.py``): a
  lane with no real work, nothing to steal and no speculation candidate
  runs a cache-warming task instead, on a daemon thread of its own (never
  a pool worker, so a remote fetch holds no slot a real task would queue
  behind). The lane stays claimable: real work landing on it cancels the
  prefetch (a fetch already running finishes and still warms the cache).
  Warms still running when the plan resolves are left to finish: they
  warm the files the next epoch reads.

One named driver thread per plan runs the loop, woken by completion
events (it polls only while speculation is on).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import queue as queue_mod
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch import executor as ex
from ray_shuffling_data_loader_tpu_torch.plan import ir
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: Dispatcher signature: submit one attempt of a node to the pool.
Dispatcher = Callable[[ir.PlanNode, int], ex.TaskRef]

#: Completed durations kept per stage for the speculation median.
_MEDIAN_WINDOW = 64

_totals_lock = threading.Lock()
_totals = {"speculative_launched": 0, "speculative_won": 0,
           "speculative_wasted": 0, "steals": 0}


def speculation_totals() -> Dict[str, int]:
    """Process-wide ``{speculative_launched, speculative_won,
    speculative_wasted, steals}`` across all schedulers (monotonic:
    snapshot before and after a run)."""
    with _totals_lock:
        return dict(_totals)


def _bump(name: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[name] += n


class SchedulerPolicy:
    """Resolved ``plan`` policy knobs (kwarg > ``RSDL_PLAN_*`` > default)."""

    def __init__(self, speculation: Optional[bool] = None,
                 stealing: Optional[bool] = None,
                 multiplier: Optional[float] = None,
                 min_task_s: Optional[float] = None,
                 check_interval_s: Optional[float] = None):
        self.speculation = rt_policy.resolve("plan", "plan_speculation",
                                             override=speculation)
        self.stealing = rt_policy.resolve("plan", "plan_stealing",
                                          override=stealing)
        self.multiplier = rt_policy.resolve(
            "plan", "plan_speculation_multiplier", override=multiplier)
        self.min_task_s = rt_policy.resolve(
            "plan", "plan_speculation_min_s", override=min_task_s)
        self.check_interval_s = rt_policy.resolve(
            "plan", "plan_speculation_check_s", override=check_interval_s)


class _NodeState:
    __slots__ = ("node", "future", "lane", "indegree", "attempts",
                 "backup_launched")

    def __init__(self, node: ir.PlanNode, lane: int, indegree: int):
        self.node = node
        self.future: cf.Future = cf.Future()
        self.lane = lane
        self.indegree = indegree
        #: attempt -> (ref, start monotonic) of the attempts in flight.
        self.attempts: Dict[int, Tuple[ex.TaskRef, float]] = {}
        self.backup_launched = False


class PlanScheduler:
    """Execute the scheduled stages of one :class:`ir.EpochPlan`.

    ``dispatchers`` maps a stage name to a callable submitting one attempt
    of a node; stages without one (``route``) are not scheduled: they are
    the driver's consumption plan. ``barriers`` maps a stage name to a
    hook run once on the driver thread when that stage has resolved,
    before its dependents dispatch; ``prefetcher`` (duck-typed: ``next()``
    gives a task with ``run``/``cancel``, or None) feeds idle lanes.
    :meth:`start` returns at once; each node's result is a ``TaskRef``
    (:meth:`ref_for` / :meth:`refs`).
    """

    def __init__(self, plan: ir.EpochPlan, pool,
                 dispatchers: Dict[str, Dispatcher],
                 barriers: Optional[Dict[str, Callable[[], None]]] = None,
                 policy: Optional[SchedulerPolicy] = None,
                 prefetcher=None):
        plan.validate()
        self.plan = plan
        self.policy = policy if policy is not None else SchedulerPolicy()
        self._dispatchers = dict(dispatchers)
        self._barriers = dict(barriers or {})
        self._prefetcher = prefetcher
        self._lane_prefetch: Dict[int, object] = {}
        self._lanes = max(1, pool.num_workers)
        self._name = f"rsdl-plan-e{plan.epoch}"
        self._events: "queue_mod.Queue[tuple]" = queue_mod.Queue()
        # No lock: every field below belongs to the driver thread, and
        # completion callbacks reach it only through self._events.
        self._lane_busy = [False] * self._lanes
        self._lane_queues: List["collections.deque[_NodeState]"] = [
            collections.deque() for _ in range(self._lanes)]
        self._durations: Dict[str, "collections.deque[float]"] = {}
        self._stage_outstanding: Dict[str, int] = {}
        self._barrier_done: set = set()
        self._states: Dict[str, _NodeState] = {}
        self._started = False
        self._driver: Optional[threading.Thread] = None
        dependents = plan.dependents()
        scheduled = set(self._dispatchers)
        for node in plan.nodes.values():
            if node.stage not in scheduled:
                continue
            indegree = sum(1 for dep in node.deps
                           if plan.nodes[dep].stage in scheduled)
            self._states[node.id] = _NodeState(
                node, node.key.task % self._lanes, indegree)
            self._stage_outstanding[node.stage] = \
                self._stage_outstanding.get(node.stage, 0) + 1
        self._dependents = {
            nid: [d for d in dependents.get(nid, ()) if d in self._states]
            for nid in self._states}
        self._unresolved = len(self._states)

    # -- public surface -------------------------------------------------

    def start(self) -> "PlanScheduler":
        assert not self._started, "scheduler already started"
        self._started = True
        for state in self._states.values():
            if state.indegree == 0 and self._deps_barriers_done(state.node):
                self._lane_queues[state.lane].append(state)
        self._driver = threading.Thread(target=self._drive,
                                        name=self._name, daemon=True)
        self._driver.start()
        return self

    def ref_for(self, nid: str) -> ex.TaskRef:
        return ex.TaskRef(self._states[nid].future)

    def refs(self, stage: str) -> List[ex.TaskRef]:
        """The stage's refs in task order (``refs[i]`` is task ``i``)."""
        nodes = sorted((s.node for s in self._states.values()
                        if s.node.stage == stage), key=lambda n: n.key.task)
        return [self.ref_for(n.id) for n in nodes]

    def futures(self, stage: str) -> List[cf.Future]:
        """The stage's futures in task order."""
        nodes = sorted((s.node for s in self._states.values()
                        if s.node.stage == stage), key=lambda n: n.key.task)
        return [self._states[n.id].future for n in nodes]

    # -- driver loop -----------------------------------------------------

    def _drive(self) -> None:
        try:
            self._fill_lanes()
            while self._unresolved:
                timeout = (self.policy.check_interval_s
                           if self.policy.speculation else None)
                try:
                    event = self._events.get(timeout=timeout)
                except queue_mod.Empty:
                    self._maybe_speculate()
                    continue
                self._handle_done(*event)
                while True:  # drain what else arrived, without blocking
                    try:
                        event = self._events.get_nowait()
                    except queue_mod.Empty:
                        break
                    self._handle_done(*event)
                self._fill_lanes()
                if self.policy.speculation:
                    self._maybe_speculate()
        except BaseException as e:  # noqa: BLE001 - surfaced via futures
            logger.exception("%s: plan driver failed", self._name)
            for state in self._states.values():
                if not state.future.done():
                    state.future.set_exception(e)
        finally:
            # The dispatchers' closures usually reach back to this
            # scheduler (a reduce looks up its map refs here): dropping
            # them breaks that cycle, so the epoch's map outputs and
            # results go with their last reference, not at a later
            # garbage collection.
            self._dispatchers.clear()
            self._barriers.clear()

    def _deps_barriers_done(self, node: ir.PlanNode) -> bool:
        for dep in node.deps:
            stage = self.plan.nodes[dep].stage
            if stage in self._barriers and stage not in self._barrier_done:
                return False
        return True

    def _fill_lanes(self) -> None:
        for lane in range(self._lanes):
            while not self._lane_busy[lane]:
                state = self._take_work(lane)
                if state is None:
                    break
                self._cancel_prefetch(lane)  # real work outranks a warm
                self._dispatch(state, attempt=0, lane=lane)
        if self._prefetcher is not None:
            self._fill_prefetch()

    def _cancel_prefetch(self, lane: int) -> None:
        task = self._lane_prefetch.pop(lane, None)
        if task is not None:
            task.cancel()

    def _fill_prefetch(self) -> None:
        """The bottom of the priority order: a lane with no real work and
        nothing to steal runs a warm on a daemon thread of its own and
        stays claimable."""
        for lane in range(self._lanes):
            if (self._lane_busy[lane] or lane in self._lane_prefetch
                    or self._lane_queues[lane]):
                continue
            task = self._prefetcher.next()
            if task is None:
                return

            def warm(task=task, lane=lane):
                try:
                    task.run()
                finally:
                    self._events.put(("__prefetch__", lane))
            self._lane_prefetch[lane] = task
            threading.Thread(target=warm, daemon=True,
                             name=f"{self._name}-prefetch-l{lane}").start()

    def _take_work(self, lane: int) -> Optional[_NodeState]:
        own = self._lane_queues[lane]
        if own:
            return own.popleft()
        if not self.policy.stealing:
            return None
        victim = max(self._lane_queues, key=len)
        if not victim:
            return None
        _bump("steals")
        return victim.popleft()

    def _dispatch(self, state: _NodeState, attempt: int, lane: int) -> None:
        node = state.node
        try:
            ref = self._dispatchers[node.stage](node, attempt)
        except BaseException as e:  # noqa: BLE001 - surfaced via future
            if attempt > 0:
                # A failed backup submission never poisons a node whose
                # first attempt is still running.
                logger.warning("%s: speculative dispatch of %s failed "
                               "(%s); original attempt continues",
                               self._name, node.id, e)
            elif not state.future.done():
                state.future.set_exception(e)
                self._on_resolved(state)
            return
        now = time.monotonic()
        if attempt == 0:
            self._lane_busy[lane] = True
            state.lane = lane
        state.attempts[attempt] = (ref, now)
        nid = node.id
        ref.add_done_callback(lambda _f: self._events.put((nid, attempt)))

    def _handle_done(self, nid: str, attempt: int) -> None:
        if nid == "__prefetch__":
            # A warm ended (or was canceled): free its lane's slot.
            self._lane_prefetch.pop(attempt, None)
            return
        state = self._states.get(nid)
        if state is None:
            return
        entry = state.attempts.pop(attempt, None)
        if entry is None:
            return
        ref, started = entry
        if state.future.done():
            _bump("speculative_wasted")  # a sibling attempt already won
            return
        try:
            result = ref.result()
        except BaseException as e:  # noqa: BLE001 - consumer semantics
            state.future.set_exception(e)
        else:
            state.future.set_result(result)
        self._durations.setdefault(
            state.node.stage, collections.deque(maxlen=_MEDIAN_WINDOW)
        ).append(time.monotonic() - started)
        if attempt > 0:
            _bump("speculative_won")
        for other_ref, _ in list(state.attempts.values()):
            other_ref.cancel()
        self._on_resolved(state)

    def _on_resolved(self, state: _NodeState) -> None:
        node = state.node
        self._unresolved -= 1
        self._lane_busy[state.lane] = False
        self._stage_outstanding[node.stage] -= 1
        if self._stage_outstanding[node.stage] == 0:
            hook = self._barriers.get(node.stage)
            if hook is not None:
                hook()
            self._barrier_done.add(node.stage)
        for child_id in self._dependents[node.id]:
            child = self._states[child_id]
            child.indegree -= 1
            if child.indegree == 0 and self._deps_barriers_done(child.node):
                self._lane_queues[child.lane].append(child)
        # The barrier may have released nodes whose indegree reached 0
        # earlier in the stage (held back only by the hook).
        if node.stage in self._barrier_done and node.stage in self._barriers:
            for child in self._states.values():
                if (child.indegree == 0 and not child.future.done()
                        and not child.attempts
                        and child not in self._lane_queues[child.lane]
                        and self._deps_barriers_done(child.node)):
                    self._lane_queues[child.lane].append(child)

    # -- speculation ----------------------------------------------------

    def _threshold(self, stage: str) -> Optional[float]:
        window = self._durations.get(stage)
        if not window:
            return None
        return max(self.policy.min_task_s,
                   self.policy.multiplier * statistics.median(window))

    def _maybe_speculate(self) -> None:
        idle = [lane for lane in range(self._lanes)
                if not self._lane_busy[lane]
                and not self._lane_queues[lane]]
        now = time.monotonic()
        for state in self._states.values():
            if not idle:
                return
            node = state.node
            if (state.backup_launched or state.future.done()
                    or 0 not in state.attempts):
                continue
            threshold = self._threshold(node.stage)
            if threshold is None:
                continue
            elapsed = now - state.attempts[0][1]
            if elapsed <= threshold:
                continue
            state.backup_launched = True
            self._cancel_prefetch(idle.pop())  # speculation outranks it
            logger.warning(
                "%s: task %s running %.3fs (> %.3fs threshold); "
                "launching speculative backup", self._name, node.id,
                elapsed, threshold)
            _bump("speculative_launched")
            self._dispatch(state, attempt=1, lane=-1)
