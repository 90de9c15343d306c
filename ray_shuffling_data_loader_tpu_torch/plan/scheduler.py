"""Plan-driven execution engine: dependency-ordered dispatch, speculative
re-execution of stragglers and work-stealing placement (own copy of the
JAX package's ``plan/scheduler.py``; its idle-lane cache prefetch, stage
barriers and membership rewrites come with the storage tiers, the process
pool and membership).

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
    the driver's consumption plan. :meth:`start` returns at once; each
    node's result is a ``TaskRef`` (:meth:`ref_for` / :meth:`refs`).
    """

    def __init__(self, plan: ir.EpochPlan, pool,
                 dispatchers: Dict[str, Dispatcher],
                 policy: Optional[SchedulerPolicy] = None):
        plan.validate()
        self.plan = plan
        self.policy = policy if policy is not None else SchedulerPolicy()
        self._dispatchers = dict(dispatchers)
        self._lanes = max(1, pool.num_workers)
        self._name = f"rsdl-plan-e{plan.epoch}"
        self._events: "queue_mod.Queue[tuple]" = queue_mod.Queue()
        # No lock: every field below belongs to the driver thread, and
        # completion callbacks reach it only through self._events.
        self._lane_busy = [False] * self._lanes
        self._lane_queues: List["collections.deque[_NodeState]"] = [
            collections.deque() for _ in range(self._lanes)]
        self._durations: Dict[str, "collections.deque[float]"] = {}
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
        self._dependents = {
            nid: [d for d in dependents.get(nid, ()) if d in self._states]
            for nid in self._states}
        self._unresolved = len(self._states)

    # -- public surface -------------------------------------------------

    def start(self) -> "PlanScheduler":
        assert not self._started, "scheduler already started"
        self._started = True
        for state in self._states.values():
            if state.indegree == 0:
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

    def _fill_lanes(self) -> None:
        for lane in range(self._lanes):
            while not self._lane_busy[lane]:
                state = self._take_work(lane)
                if state is None:
                    break
                self._dispatch(state, attempt=0, lane=lane)

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
        self._unresolved -= 1
        self._lane_busy[state.lane] = False
        for child_id in self._dependents[state.node.id]:
            child = self._states[child_id]
            child.indegree -= 1
            if child.indegree == 0:
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
            idle.pop()
            logger.warning(
                "%s: task %s running %.3fs (> %.3fs threshold); "
                "launching speculative backup", self._name, node.id,
                elapsed, threshold)
            _bump("speculative_launched")
            self._dispatch(state, attempt=1, lane=-1)
