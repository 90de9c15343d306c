"""Multi-host distributed shuffle: per-host map/reduce and an all-to-all of
the map->reduce chunks over ``parallel.transport`` (own copy of the JAX
package's ``parallel/distributed.py``).

One loader process per host. Host ``h`` maps the ``h``-th contiguous shard
of the global file list and reduces a contiguous range of the global
reducers: those of its trainers under the reducer->trainer routing
``contiguous_splits(range(num_reducers), num_trainers)``, so the
reduce->trainer traffic never leaves the host. Only the map->reduce
chunks that cross hosts go over the wire, as Arrow IPC streams tagged
``(epoch, reducer, file)``; a host's own chunks stay lazy index arrays
until its reducer gathers them.

Map and reduce randomness is keyed by the **global** file and reducer
indices (``partition.py``), so global trainer ``t = host *
trainers_per_host + local_rank`` gets bit for bit the reducer tables that
a one-process shuffle with ``num_trainers = world * trainers_per_host``
routes to rank ``t``, and a checkpoint resumes under any world.

Each host runs the shuffle engine's pieces (``shuffle.py``): the file
cache over its own files, the memory budget and spill tier over its own
reducer outputs, retries of its maps (a resent chunk is dropped by the
receiver) and its own ``TrialStats``.
"""

from __future__ import annotations

import functools
import timeit
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from ray_shuffling_data_loader_tpu_torch import dataset as ds_mod
from ray_shuffling_data_loader_tpu_torch import executor as ex
from ray_shuffling_data_loader_tpu_torch import multiqueue as mq
from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch import partition
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch import spill
from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.parallel.transport import (
    TcpTransport)


def serialize_table(table: pa.Table) -> pa.Buffer:
    """The table as an Arrow IPC stream, in a ``pa.Buffer`` that goes to
    the socket through the buffer protocol."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue()


def deserialize_table(payload) -> pa.Table:
    with pa.ipc.open_stream(pa.BufferReader(payload)) as reader:
        return reader.read_all()


class ShardPlan:
    """Static partition of files, reducers and trainers across hosts.

    - Global trainer ``t = host * trainers_per_host + local_rank``.
    - Reducer groups: ``contiguous_splits(range(num_reducers),
      num_trainers)``; host ``h`` owns the union of its trainers' groups
      (a contiguous reducer range).
    - File shard: ``contiguous_splits(range(num_files), world)``.
    """

    def __init__(self, num_files: int, num_reducers: int, world: int,
                 trainers_per_host: int = 1):
        if world < 1 or trainers_per_host < 1:
            raise ValueError("world and trainers_per_host must be >= 1")
        self.world = world
        self.trainers_per_host = trainers_per_host
        # The plan is fixed at launch: the trainer count never changes.
        # rsdl-lint: disable=fixed-world-assumption
        self.num_trainers = world * trainers_per_host
        self.num_files = num_files
        self.num_reducers = num_reducers
        self.file_shards: List[List[int]] = partition.contiguous_splits(
            list(range(num_files)), world)
        self.trainer_reducers: List[List[int]] = partition.contiguous_splits(
            list(range(num_reducers)), self.num_trainers)
        self._reducer_host = {r: t // trainers_per_host
                              for t, group in enumerate(self.trainer_reducers)
                              for r in group}
        self._file_host = [0] * num_files
        for h, shard in enumerate(self.file_shards):
            for f in shard:
                self._file_host[f] = h

    def file_host(self, file_index: int) -> int:
        if not 0 <= file_index < self.num_files:
            raise ValueError(f"file index {file_index} out of range")
        return self._file_host[file_index]

    def reducer_host(self, reducer_index: int) -> int:
        return self._reducer_host[reducer_index]

    def local_files(self, host: int) -> List[int]:
        return self.file_shards[host]

    def local_trainers(self, host: int) -> List[int]:
        base = host * self.trainers_per_host
        return list(range(base, base + self.trainers_per_host))

    def local_reducers(self, host: int) -> List[int]:
        return [r for t in self.local_trainers(host)
                for r in self.trainer_reducers[t]]


def _map_task(filename: str, global_file_index: int, num_reducers: int,
              seed: int, epoch: int, plan: ShardPlan,
              transport: TcpTransport, stats_collector=None,
              map_transform: Optional[sh.MapTransform] = None,
              file_cache: Optional[sh.FileTableCache] = None):
    """Map one local file, send each remote reducer its rows and keep the
    map output (lazy) for the local reducers. A retried map sends its
    chunks again; the receivers keep the first copy of each."""
    shard = sh.shuffle_map(filename, num_reducers, seed, epoch,
                           global_file_index, stats_collector, map_transform,
                           file_cache)
    for reducer, chunk in enumerate(shard):
        owner = plan.reducer_host(reducer)
        if owner != transport.host_id:
            transport.send(owner, (epoch, reducer, global_file_index),
                           serialize_table(chunk.materialize()))
    return shard


def _reduce_task(reducer: int, seed: int, epoch: int, plan: ShardPlan,
                 transport: TcpTransport,
                 local_maps: Dict[int, ex.TaskRef], stats_collector=None,
                 reduce_transform: Optional[sh.ReduceTransform] = None,
                 spill_manager=None,
                 gather_threads: Optional[int] = None):
    """This reducer's rows of every global file, in file order (local map
    outputs and tables received from their hosts), then the seeded
    permutation and the memory policy (``shuffle.account_and_maybe_spill``,
    with no lineage: a corrupt spill of rows that crossed the wire stays a
    loud failure)."""
    chunks: List[sh.Chunk] = []
    for file_index in range(plan.num_files):
        src = plan.file_host(file_index)
        if src == transport.host_id:
            chunks.append(local_maps[file_index].result()[reducer])
        else:
            chunks.append(deserialize_table(
                transport.recv(src, (epoch, reducer, file_index))))
    shuffled = sh.shuffle_reduce(reducer, seed, epoch, chunks,
                                 reduce_transform, stats_collector,
                                 gather_threads)
    return sh.account_and_maybe_spill(shuffled, spill_manager, epoch=epoch,
                                      task=reducer)


def shuffle_epoch_distributed(
        epoch: int, filenames: Sequence[str],
        batch_consumer: sh.BatchConsumer, plan: ShardPlan,
        transport: TcpTransport, pool: ex.Executor, seed: int,
        trial_start: float, stats_collector=None,
        map_transform: Optional[sh.MapTransform] = None,
        file_cache: Optional[sh.FileTableCache] = None,
        reduce_transform: Optional[sh.ReduceTransform] = None,
        spill_manager=None, concurrent_epochs: int = 2
) -> List[ex.TaskRef]:
    """One epoch on this host: map the local files, reduce the owned
    reducers and route them to the local trainers (local rank ``k`` gets
    its global trainer's reducers, then ``None``).

    Every map is submitted before any reduce: a reducer blocks in its
    pool thread on ``recv``, and the maps it waits for (here and on the
    other hosts, which submit in the same order) then always hold a
    thread first. Maps go through the executor's retries; reduces through
    ``submit_once``, since a reduce consumes its messages once and a retry
    could only wait for them until the timeout. Returns the reduce and map
    refs: their completion means every chunk this host sends in the epoch
    has been sent."""
    if stats_collector is not None:
        stats_collector.epoch_start(epoch)
    host = transport.host_id
    maps = {fi: pool.submit(_map_task, filenames[fi], fi, plan.num_reducers,
                            seed, epoch, plan, transport, stats_collector,
                            map_transform, file_cache)
            for fi in plan.local_files(host)}
    local_reducers = plan.local_reducers(host)
    # A loopback world runs every host on this machine: split its cores.
    loopback = all(h in ("127.0.0.1", "localhost")
                   for h, _ in transport.addresses)
    gather_threads = sh.derive_gather_threads(
        max(1, concurrent_epochs) * len(local_reducers), pool.num_workers,
        host_share=transport.world if loopback else 1)
    reduces = {r: pool.submit_once(_reduce_task, r, seed, epoch, plan,
                                   transport, maps, stats_collector,
                                   reduce_transform, spill_manager,
                                   gather_threads)
               for r in local_reducers}
    for local_rank, trainer in enumerate(plan.local_trainers(host)):
        sh.consume(local_rank, batch_consumer, trial_start, stats_collector,
                   epoch, [reduces[r] for r in plan.trainer_reducers[trainer]])
        batch_consumer(local_rank, epoch, None)
    return list(reduces.values()) + list(maps.values())


def shuffle_distributed(filenames: Sequence[str],
                        batch_consumer: sh.BatchConsumer,
                        num_epochs: int, num_reducers: int,
                        transport: TcpTransport,
                        trainers_per_host: int = 1,
                        max_concurrent_epochs: int = 2, seed: int = 0,
                        num_workers: Optional[int] = None,
                        pool: Optional[ex.Executor] = None,
                        start_epoch: int = 0,
                        map_transform: Optional[sh.MapTransform] = None,
                        file_cache="auto",
                        reduce_transform: Optional[sh.ReduceTransform] = None,
                        task_retries: int = 0,
                        collect_stats: bool = False,
                        max_inflight_bytes: Optional[int] = None,
                        spill_dir: Optional[str] = None):
    """The multi-epoch distributed shuffle for ONE host; every host runs
    it with the same arguments, and hosts synchronise only through the
    chunk exchange. At most ``max_concurrent_epochs`` epochs are in flight
    on this host (a host cannot run far ahead anyway: its reducers wait
    for every peer's chunks of their epoch). Epochs before
    ``start_epoch`` are skipped (a resumed run).

    The engine's pieces, per host, as in ``shuffle.shuffle``:
    ``file_cache`` (``"auto"``: this host's files cached across epochs),
    ``task_retries`` (maps only), ``max_inflight_bytes`` and
    ``spill_dir`` (without a spill dir the budget drains older epochs
    before a launch; with one, over-budget reducer outputs spill and the
    consumer unwraps them), and ``collect_stats``: the return value is
    then THIS host's ``TrialStats`` (its maps, reduces and consumes),
    else the wall-clock seconds. Runs on ``num_workers`` threads (default:
    one per core) or a caller's ``pool``. A failed map or reduce raises
    here; the other hosts then fail in ``recv`` (dead source or
    timeout)."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    plan = ShardPlan(len(filenames), num_reducers, transport.world,
                     trainers_per_host)
    host = transport.host_id
    stats_collector = None
    if collect_stats:
        if start_epoch:
            raise ValueError("collect_stats with start_epoch > 0 is "
                             "unsupported (the collectors expect every "
                             "epoch to run)")
        stats_collector = stats_mod.TrialStatsCollector(
            num_epochs, num_maps=len(plan.local_files(host)),
            num_reduces=len(plan.local_reducers(host)),
            num_consumes=trainers_per_host)
        stats_collector.trial_start()
    file_cache, owns_file_cache = sh.resolve_file_cache(
        file_cache, num_epochs - start_epoch)
    over_budget, spill_manager = spill.make_budget_state(
        file_cache, max_inflight_bytes, spill_dir)
    start = timeit.default_timer()
    owns_pool = pool is None
    if pool is None:
        pool = ex.Executor(num_workers=num_workers,
                           thread_name_prefix=f"rsdl-dist-{host}",
                           task_retries=task_retries)
    failed = True
    try:
        in_progress: Dict[int, List[ex.TaskRef]] = {}
        for spec in plan_ir.static_epoch_specs(filenames, num_epochs,
                                               start_epoch):
            throttle_start = timeit.default_timer()
            # Without a spill tier, budget pressure drains older epochs
            # before a launch; no wait for consumers beyond that: hosts
            # must stay loosely in step.
            while in_progress and (len(in_progress) >= max_concurrent_epochs
                                   or (spill_manager is None
                                       and over_budget())):
                sh.wait_and_raise(in_progress.pop(min(in_progress)))
            throttled = timeit.default_timer() - throttle_start
            if stats_collector is not None and throttled > 1e-4:
                stats_collector.throttle_done(spec.epoch, throttled)
            in_progress[spec.epoch] = shuffle_epoch_distributed(
                spec.epoch, filenames, batch_consumer, plan, transport,
                pool, seed, start, stats_collector, map_transform,
                file_cache, reduce_transform, spill_manager,
                concurrent_epochs=min(max_concurrent_epochs,
                                      num_epochs - start_epoch))
        for epoch in sorted(in_progress):
            sh.wait_and_raise(in_progress.pop(epoch))
        failed = False
    finally:
        if owns_pool:
            # On a failure, fail now: reducers still blocked in recv end
            # at their timeout, or at once when the caller closes the
            # transport.
            pool.shutdown(wait_for_tasks=not failed, cancel_pending=failed)
            if not failed:
                native.trim_freelist()
        if owns_file_cache:
            file_cache.close()
        if spill_manager is not None:
            spill_manager.report()
    if stats_collector is not None:
        stats_collector.trial_done()
        return stats_collector.get_stats()
    return timeit.default_timer() - start


def create_distributed_batch_queue_and_shuffle(
        filenames: Sequence[str], num_epochs: int, num_reducers: int,
        transport: TcpTransport, trainers_per_host: int = 1,
        max_concurrent_epochs: int = 2, seed: int = 0,
        num_workers: Optional[int] = None, start_epoch: int = 0,
        map_transform: Optional[sh.MapTransform] = None,
        reduce_transform: Optional[sh.ReduceTransform] = None,
        task_retries: int = 0, file_cache="auto",
        max_inflight_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None, collect_stats: bool = False
) -> Tuple[mq.MultiQueue, ex.TaskRef]:
    """This host's queues and its distributed shuffle on a driver thread.

    The returned ``(batch_queue, shuffle_result)`` go to
    ``ShufflingDataset`` / ``DeviceShufflingDataset`` as ``batch_queue=``
    and ``shuffle_result=``, with ``rank`` the local rank in ``[0,
    trainers_per_host)`` and ``num_trainers = trainers_per_host``. The
    result resolves to :func:`shuffle_distributed`'s (this host's
    ``TrialStats`` with ``collect_stats``). A failure of the shuffle is
    put into every queue of this host, so a consumer blocked on one
    raises."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    queue = mq.MultiQueue(num_epochs * trainers_per_host)
    consumer = functools.partial(ds_mod.batch_consumer, queue,
                                 trainers_per_host)
    return queue, sh.run_in_background(
        lambda: shuffle_distributed(
            filenames, consumer, num_epochs, num_reducers, transport,
            trainers_per_host=trainers_per_host,
            max_concurrent_epochs=max_concurrent_epochs, seed=seed,
            num_workers=num_workers, start_epoch=start_epoch,
            map_transform=map_transform, file_cache=file_cache,
            reduce_transform=reduce_transform, task_retries=task_retries,
            collect_stats=collect_stats,
            max_inflight_bytes=max_inflight_bytes, spill_dir=spill_dir),
        ds_mod.make_failure_broadcaster(queue))
