"""Elastic shuffle execution: a resize is a plan rewrite over a live view
(own copy of the JAX package's ``membership/elastic.py``).

Each epoch opens by reading the :class:`membership.MembershipManager`'s
current view, places the fixed reducer set over the live ranks with
``plan.ir.reduce_placement`` and runs one worker per live rank. Every
reducer output is a pure function of ``(seed, epoch, reducer)``
(``shuffle.recompute_reducer_output``, the lineage the spill tier's
recovery uses), so moving a reducer to another rank moves where it is
computed, never what it holds: an elastic run's stream equals the fixed
world's bit for bit.

Shrink (``member_down`` mid-epoch): the dead rank's undelivered reducers
go back to an orphan queue that the survivors drain, recomputing them from
lineage. The runner's delivery ledger, keyed by reducer, makes delivery
exactly once: a reducer the dead rank delivered is never recomputed, and a
racing duplicate is dropped, so the stream misses and repeats no row. If
every rank dies, the calling thread finishes the epoch itself. Grow
(``member_join``): the joined rank takes part from the next epoch; an
epoch's placement never changes once it started, so a join causes no
replay.

The ``member_crash`` chaos site fires here, through
``MembershipManager.maybe_crash``, as a rank's worker picks up its next
reducer. Workers are threads of the caller's process; each reducer is
recomputed inline on its worker thread (no executor pool).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ray_shuffling_data_loader_tpu_torch import shuffle
from ray_shuffling_data_loader_tpu_torch.membership import MembershipManager
from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)


class ElasticShuffleRunner:
    """Run shuffle epochs over an elastic world.

    Args:
        filenames: the epoch's input files (the same every epoch; each
            epoch's reshuffle comes from the ``(seed, epoch)`` lineage).
        num_reducers: the fixed reducer count: elasticity moves placement,
            not partitioning, which keeps the stream bit-identical across
            resizes.
        seed: the shuffle seed (the lineage root).
        manager: the membership manager whose view drives placement; its
            ``maybe_crash`` is asked at each pickup, so a
            ``member_crash:rankN`` chaos rule kills that rank mid-epoch.
    """

    def __init__(self, filenames: Sequence[str], num_reducers: int,
                 seed: int, manager: MembershipManager,
                 map_transform: Optional[Callable] = None,
                 reduce_transform: Optional[Callable] = None,
                 on_bad_file: str = "raise"):
        if num_reducers < 1:
            raise ValueError("num_reducers must be >= 1")
        self.filenames = list(filenames)
        self.num_reducers = int(num_reducers)
        self.seed = int(seed)
        self.manager = manager
        self.map_transform = map_transform
        self.reduce_transform = reduce_transform
        self.on_bad_file = on_bad_file
        #: Figures of the last :meth:`run_epoch`: ``epoch``, ``view_id``,
        #: ``live_ranks``, ``recomputed``, ``duplicates_dropped``,
        #: ``resize_stall_ms`` (from the first death to the epoch's end)
        #: and ``dur_s``.
        self.last_stats: Dict[str, float] = {}

    def run_epoch(self, epoch: int) -> List:
        """Run one epoch; returns the reducer outputs (``pa.Table``) in
        reducer order, each delivered exactly once, whatever ranks died
        (through the ``member_crash`` site, or already downed in the view
        by a failure detector)."""
        view = self.manager.current_view()
        live = list(view.ranks)
        placement = plan_ir.reduce_placement(self.num_reducers, live)
        queues: Dict[int, collections.deque] = {
            rank: collections.deque() for rank in live}
        for reducer in range(self.num_reducers):
            queues[placement[reducer]].append(reducer)

        lock = threading.Lock()
        ledger: Dict[int, object] = {}       # reducer -> delivered table
        orphans: collections.deque = collections.deque()
        dead: set = set()
        death_times: List[float] = []
        stats = {"epoch": epoch, "view_id": view.view_id,
                 "live_ranks": len(live), "recomputed": 0,
                 "duplicates_dropped": 0, "resize_stall_ms": 0.0}

        def compute(reducer: int):
            return shuffle.recompute_reducer_output(
                self.filenames, self.num_reducers, self.seed, epoch,
                reducer, self.map_transform, self.reduce_transform,
                self.on_bad_file)

        def deliver(reducer: int, table) -> None:
            with lock:
                if reducer in ledger:
                    # Exactly once: a racing recompute of a reducer that
                    # was in fact delivered is dropped.
                    stats["duplicates_dropped"] += 1
                    return
                ledger[reducer] = table

        def worker(rank: int) -> None:
            while True:
                with lock:
                    if rank in dead:
                        return
                    if queues[rank]:
                        reducer = queues[rank].popleft()
                        recovered = False
                    elif orphans:
                        reducer = orphans.popleft()
                        recovered = True
                    else:
                        return
                if self.manager.maybe_crash(epoch, rank):
                    # The rank died holding `reducer` undelivered: it goes
                    # to the orphans with the rest of the rank's queue.
                    with lock:
                        dead.add(rank)
                        orphans.append(reducer)
                        orphans.extend(queues[rank])
                        queues[rank].clear()
                        death_times.append(time.monotonic())
                    return
                deliver(reducer, compute(reducer))
                if recovered:
                    with lock:
                        stats["recomputed"] += 1

        start = time.monotonic()
        threads = [threading.Thread(target=worker, args=(rank,),
                                    daemon=True,
                                    name=f"rsdl-elastic-r{rank}")
                   for rank in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        # The backstop: every rank died, or one died after the survivors
        # had drained and exited. The calling thread finishes the epoch from
        # lineage, so it never ends with a hole.
        leftovers = list(orphans)
        for rank in live:
            leftovers.extend(queues[rank])
        missing = [r for r in range(self.num_reducers) if r not in ledger]
        for reducer in sorted(set(leftovers) | set(missing)):
            if reducer in ledger:
                continue
            deliver(reducer, compute(reducer))
            stats["recomputed"] += 1

        end = time.monotonic()
        stats["dur_s"] = end - start
        if death_times:
            stats["resize_stall_ms"] = (end - min(death_times)) * 1000.0
        self.last_stats = stats
        if stats["recomputed"] or dead:
            rt_telemetry.record(
                "member_resize", epoch=epoch, view=view.view_id,
                recomputed=stats["recomputed"],
                dead=sorted(dead), dur_s=stats["dur_s"])
            logger.warning(
                "elastic epoch %d completed DEGRADED: ranks %s died, "
                "%d reducer(s) recomputed on survivors", epoch,
                sorted(dead), stats["recomputed"])
        if len(ledger) != self.num_reducers:
            raise RuntimeError(
                f"elastic epoch {epoch} delivered {len(ledger)} of "
                f"{self.num_reducers} reducers")
        return [ledger[r] for r in range(self.num_reducers)]

    def run(self, num_epochs: int) -> List[List]:
        """Run ``num_epochs`` epochs; view changes (a shrink from chaos or
        a detector, a grow from ``member_join``) take effect at each epoch
        boundary."""
        return [self.run_epoch(e)
                for e in plan_ir.epoch_range(0, num_epochs)]


def trainer_streams(reducer_outputs: Sequence, num_trainers: int) -> List:
    """Slice the reducer outputs into per-trainer streams by the
    ``route_slices`` contract the queue uses (the trainer count never
    changes under elasticity)."""
    spans = plan_ir.route_slices(len(reducer_outputs), num_trainers)
    return [list(reducer_outputs[start:stop]) for start, stop in spans]


def total_rows(reducer_outputs: Sequence) -> int:
    """Rows over the reducer outputs (``rows_lost`` compares it with the
    fixed world's)."""
    return sum(t.num_rows for t in reducer_outputs)


__all__ = ["ElasticShuffleRunner", "trainer_streams", "total_rows"]
