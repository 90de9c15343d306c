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
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import os
import timeit
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from ray_shuffling_data_loader_tpu_torch import dataset as ds_mod
from ray_shuffling_data_loader_tpu_torch import multiqueue as mq
from ray_shuffling_data_loader_tpu_torch import partition
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch.parallel.transport import (
    TcpTransport)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)


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
              transport: TcpTransport,
              map_transform: Optional[sh.MapTransform]) -> sh.MapOutput:
    """Map one local file, send each remote reducer its rows and keep the
    map output (lazy) for the local reducers."""
    out = sh.shuffle_map(filename, num_reducers, seed, epoch,
                         global_file_index, map_transform)
    for reducer in range(num_reducers):
        owner = plan.reducer_host(reducer)
        if owner != transport.host_id:
            transport.send(owner, (epoch, reducer, global_file_index),
                           serialize_table(out.materialize(reducer)))
    return out


def _reduce_task(reducer: int, seed: int, epoch: int, plan: ShardPlan,
                 transport: TcpTransport,
                 local_maps: Dict[int, cf.Future],
                 reduce_transform: Optional[sh.ReduceTransform]
                 ) -> pa.Table:
    """This reducer's rows of every global file, in file order (local map
    outputs and tables received from their hosts), then the seeded
    permutation."""
    chunks: List[sh.Chunk] = []
    for file_index in range(plan.num_files):
        src = plan.file_host(file_index)
        if src == transport.host_id:
            chunks.append(local_maps[file_index].result())
        else:
            chunks.append(deserialize_table(
                transport.recv(src, (epoch, reducer, file_index))))
    return sh.shuffle_reduce(reducer, seed, epoch, chunks, reduce_transform)


def shuffle_epoch_distributed(
        epoch: int, filenames: Sequence[str],
        batch_consumer: sh.BatchConsumer, plan: ShardPlan,
        transport: TcpTransport, pool: cf.Executor, seed: int,
        map_transform: Optional[sh.MapTransform] = None,
        reduce_transform: Optional[sh.ReduceTransform] = None
) -> List[cf.Future]:
    """One epoch on this host: map the local files, reduce the owned
    reducers and route them to the local trainers (local rank ``k`` gets
    its global trainer's reducers, then ``None``). Every map is submitted
    before any reduce: a reducer blocks in its pool thread on ``recv``,
    and the maps it waits for (here and on the other hosts, which submit
    in the same order) then always hold a thread first. Returns the
    reduce and map futures: their completion means every chunk this host
    sends in the epoch has been sent."""
    host = transport.host_id
    maps = {fi: pool.submit(_map_task, filenames[fi], fi, plan.num_reducers,
                            seed, epoch, plan, transport, map_transform)
            for fi in plan.local_files(host)}
    reduces = {r: pool.submit(_reduce_task, r, seed, epoch, plan, transport,
                              maps, reduce_transform)
               for r in plan.local_reducers(host)}
    for local_rank, trainer in enumerate(plan.local_trainers(host)):
        batch_consumer(local_rank, epoch,
                       [reduces[r] for r in plan.trainer_reducers[trainer]])
        batch_consumer(local_rank, epoch, None)
    return list(reduces.values()) + list(maps.values())


def shuffle_distributed(filenames: Sequence[str],
                        batch_consumer: sh.BatchConsumer,
                        num_epochs: int, num_reducers: int,
                        transport: TcpTransport,
                        trainers_per_host: int = 1,
                        max_concurrent_epochs: int = 2, seed: int = 0,
                        num_workers: Optional[int] = None,
                        start_epoch: int = 0,
                        map_transform: Optional[sh.MapTransform] = None,
                        reduce_transform: Optional[sh.ReduceTransform] = None
                        ) -> float:
    """The multi-epoch distributed shuffle for ONE host; every host runs
    it with the same arguments, and hosts synchronise only through the
    chunk exchange. At most ``max_concurrent_epochs`` epochs are in flight
    on this host (a host cannot run far ahead anyway: its reducers wait
    for every peer's chunks of their epoch). Epochs before
    ``start_epoch`` are skipped (a resumed run). Runs on ``num_workers``
    threads (default: one per core); returns the wall-clock seconds. A
    failed map or reduce raises here; the other hosts then fail in
    ``recv`` (dead source or timeout)."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    plan = ShardPlan(len(filenames), num_reducers, transport.world,
                     trainers_per_host)
    start = timeit.default_timer()
    in_progress: Dict[int, List[cf.Future]] = {}
    pool = cf.ThreadPoolExecutor(
        max_workers=num_workers or os.cpu_count(),
        thread_name_prefix=f"rsdl-dist-{transport.host_id}")
    try:
        for epoch in range(start_epoch, num_epochs):
            while len(in_progress) >= max(1, max_concurrent_epochs):
                for fut in in_progress.pop(min(in_progress)):
                    fut.result()
            in_progress[epoch] = shuffle_epoch_distributed(
                epoch, filenames, batch_consumer, plan, transport, pool,
                seed, map_transform, reduce_transform)
        for epoch in sorted(in_progress):
            for fut in in_progress.pop(epoch):
                fut.result()
    except BaseException:
        # Fail now: reducers still blocked in recv end at their timeout,
        # or at once when the caller closes the transport.
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    pool.shutdown()
    return timeit.default_timer() - start


def create_distributed_batch_queue_and_shuffle(
        filenames: Sequence[str], num_epochs: int, num_reducers: int,
        transport: TcpTransport, trainers_per_host: int = 1,
        max_concurrent_epochs: int = 2, seed: int = 0,
        num_workers: Optional[int] = None, start_epoch: int = 0,
        map_transform: Optional[sh.MapTransform] = None,
        reduce_transform: Optional[sh.ReduceTransform] = None
) -> Tuple[mq.MultiQueue, cf.Future]:
    """This host's queues and its distributed shuffle on a driver thread.

    The returned ``(batch_queue, shuffle_result)`` go to
    ``ShufflingDataset`` / ``DeviceShufflingDataset`` as ``batch_queue=``
    and ``shuffle_result=``, with ``rank`` the local rank in ``[0,
    trainers_per_host)`` and ``num_trainers = trainers_per_host``. A
    failure of the shuffle is put into every queue of this host, so a
    consumer blocked on one raises."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    queue = mq.MultiQueue(num_epochs * trainers_per_host)
    consumer = functools.partial(ds_mod.batch_consumer, queue,
                                 trainers_per_host)
    on_failure = ds_mod.make_failure_broadcaster(queue)
    driver = cf.ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="rsdl-dist-driver")

    def run() -> float:
        try:
            return shuffle_distributed(
                filenames, consumer, num_epochs, num_reducers, transport,
                trainers_per_host=trainers_per_host,
                max_concurrent_epochs=max_concurrent_epochs, seed=seed,
                num_workers=num_workers, start_epoch=start_epoch,
                map_transform=map_transform,
                reduce_transform=reduce_transform)
        except BaseException as e:
            logger.error("host %d: distributed shuffle failed: %r",
                         transport.host_id, e)
            on_failure(e)
            raise

    future = driver.submit(run)
    driver.shutdown(wait=False)
    return queue, future
