"""Framework-neutral shuffling dataset: exact-size Arrow batches.

:func:`create_batch_queue_and_shuffle` (for several ranks in one process)
creates the per-``(epoch, rank)`` queues and starts the background
shuffle; without its queue, a dataset starts a shuffle of its own that
routes only its rank's reducer outputs (one loader per process: the
seeded plan is the same in every process, so ranks get disjoint parts of
each epoch). Each rank pops its reducer outputs for the epoch and
re-chunks them into exact ``batch_size``-row tables with a carry buffer
that spans table boundaries (:func:`slice_batches`). A reducer output the
memory budget spilled to disk is mapped back (``spill.unwrap``) as it is
popped.

The shuffle engine's arguments pass through as in the JAX package's
``create_batch_queue_and_shuffle``: ``num_workers``, ``task_retries``,
``file_cache``, ``max_inflight_bytes``, ``spill_dir``, ``on_bad_file``
and ``executor_backend``; ``collect_stats=True`` makes the shuffle's
result (``ShufflingDataset.shuffle_result``) a ``stats.TrialStats``.

A trainer in another process than the shuffle reads a served queue:
:func:`connect_remote_queue` dials a ``multiqueue_service`` server and
returns a ``RemoteQueue``, which goes in as ``batch_queue`` with
``shuffle_result=None``. It yields materialized tables (an in-process
queue yields task refs) and each table's absolute row position in its
queue's stream, so a resumed epoch's ``skip_batches`` stays exact when
the server replays the stream from a watermark. :meth:`commit_consumed`
commits a manual-ack remote queue (``checkpoint.resume_iterator`` calls
it after each save).

Telemetry, as in the JAX package's dataset: each blocking pop of a
reducer output is a ``queue_wait`` span keyed ``(epoch, task=queue
index)``; each table taken is observed on the ``birth_to_delivered`` hop
of the delivery-latency sketch (``queue`` label: the rank) with the
rank's freshness gauge, unless the queue observes that hop itself
(``observes_delivery``: a remote queue reads the frame's stamps first);
the end of an epoch's tables logs the epoch's bottleneck verdict
(``telemetry.epoch_complete``).
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Optional, Sequence

import pyarrow as pa

from ray_shuffling_data_loader_tpu_torch import executor as ex
from ray_shuffling_data_loader_tpu_torch import multiqueue as mq
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch import spill
from ray_shuffling_data_loader_tpu_torch.runtime import latency as rt_latency
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.config import (
    default_num_reducers)


class ShuffleFailure:
    """Put into every queue when the shuffle dies, so a consumer blocked on
    its queue raises instead of waiting forever."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


def make_failure_broadcaster(queue: mq.MultiQueue):
    """The shuffle's ``on_failure``: a :class:`ShuffleFailure` into every
    queue. A full bounded queue has items evicted to make room (the
    pipeline is dead, so its pending tables are worthless, and a consumer
    that drained them would wait forever); the JAX package's rule."""
    def broadcast(error: BaseException) -> None:
        marker = ShuffleFailure(error)
        try:
            for queue_idx in range(queue.num_queues):
                # Each round frees a slot, so maxsize rounds suffice; the
                # bound covers a consumer racing the eviction.
                for _ in range(10_000):
                    try:
                        queue.put(queue_idx, marker, block=False)
                        break
                    except mq.Full:
                        try:
                            queue.get(queue_idx, block=False)
                        except mq.Empty:
                            continue  # a consumer drained it: put again
        except mq.ShutdownError:
            pass  # every epoch was consumed: nobody is left to wake
    return broadcast


def batch_consumer(queue: mq.MultiQueue, num_trainers: int, rank: int,
                   epoch: int, batches: Optional[Sequence[ex.TaskRef]]
                   ) -> None:
    """Route reducer refs (or the ``None`` sentinel) into the
    ``(epoch, rank)`` queue."""
    queue_idx = mq.queue_index(epoch, rank, num_trainers)
    if batches is None:
        queue.put(queue_idx, None)
    else:
        queue.put_batch(queue_idx, list(batches))


def _one_rank_consumer(queue: mq.MultiQueue, num_trainers: int,
                       own_rank: int, rank: int, epoch: int,
                       batches: Optional[Sequence[ex.TaskRef]]) -> None:
    if rank == own_rank:
        batch_consumer(queue, num_trainers, rank, epoch, batches)


def create_batch_queue_and_shuffle(
        filenames: Sequence[str], num_epochs: int, num_trainers: int,
        max_concurrent_epochs: int = 2, num_reducers: Optional[int] = None,
        seed: int = 0, map_transform=None, only_rank: Optional[int] = None,
        reduce_transform=None, start_epoch: int = 0,
        max_batch_queue_size: int = 0, queue_name: Optional[str] = None,
        num_workers: Optional[int] = None, task_retries: int = 0,
        file_cache="auto", max_inflight_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None, on_bad_file: Optional[str] = None,
        executor_backend: Optional[str] = None,
        collect_stats: bool = False):
    """Create the queues and start the shuffle before any trainer exists,
    so every rank can be a pure consumer. With ``only_rank``, only that
    rank's queues are filled (the other ranks read theirs in other
    processes). Each queue holds at most ``max_batch_queue_size`` reducer
    outputs (0: unbounded; a full queue holds the shuffle back), and a
    ``queue_name`` registers the queue for ``multiqueue.connect_queue``.
    The shuffle starts at ``start_epoch`` (a resumed run).
    The engine's arguments go to ``shuffle.shuffle``. Returns ``(queue,
    shuffle_result)``; the result resolves to the shuffle's duration, or
    its ``TrialStats`` with ``collect_stats``."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    queue = mq.MultiQueue(num_epochs * num_trainers, max_batch_queue_size,
                          name=queue_name)
    if num_reducers is None:
        num_reducers = default_num_reducers(num_trainers)
    consumer = (functools.partial(batch_consumer, queue, num_trainers)
                if only_rank is None else
                functools.partial(_one_rank_consumer, queue, num_trainers,
                                  only_rank))
    result = sh.run_shuffle_in_background(
        filenames, consumer, num_epochs, num_reducers, num_trainers,
        max_concurrent_epochs, seed=seed,
        on_failure=make_failure_broadcaster(queue),
        map_transform=map_transform, reduce_transform=reduce_transform,
        start_epoch=start_epoch, num_workers=num_workers,
        task_retries=task_retries, file_cache=file_cache,
        max_inflight_bytes=max_inflight_bytes, spill_dir=spill_dir,
        on_bad_file=on_bad_file, executor_backend=executor_backend,
        collect_stats=collect_stats)
    return queue, result


def connect_remote_queue(target, **remote_kwargs):
    """The client of a served queue, for ``ShufflingDataset(batch_queue=
    ..., shuffle_result=None)``: a ``(host, port)`` gives a
    ``multiqueue_service.RemoteQueue``; a shard map (a
    ``plan.ir.ShardMap``, its dict or its JSON, as
    ``runtime.supervisor.launch_supervised_queue_shards`` returns) gives a
    ``multiqueue_service.ShardedRemoteQueue`` that routes each rank's
    stream to its shard. ``remote_kwargs`` go to the client(s)."""
    from ray_shuffling_data_loader_tpu_torch import multiqueue_service as svc
    if isinstance(target, tuple) and len(target) == 2 \
            and isinstance(target[0], str):
        return svc.RemoteQueue(target, **remote_kwargs)
    return svc.ShardedRemoteQueue(target, **remote_kwargs)


class ShufflingDataset:
    """Iterable of exact ``batch_size``-row ``pa.Table`` batches.

    Without ``batch_queue``/``shuffle_result`` from
    :func:`create_batch_queue_and_shuffle`, the dataset launches a shuffle
    of its own for its rank, with the engine's arguments
    (``shuffle_kwargs``: ``num_workers``, ``task_retries``, ``file_cache``,
    ``max_inflight_bytes``, ``spill_dir``, ``on_bad_file``,
    ``executor_backend``, ``collect_stats``). Call :meth:`set_epoch`
    before each epoch's iteration. A resumed run passes ``start_epoch``:
    the epochs before it are never shuffled.

    ``num_epochs=None`` reads an unbounded stream (a streaming runner's
    queue, or a served window schedule): epochs go on as windows are
    sealed, so it needs a ``batch_queue`` to read from.

    ``max_batch_queue_size`` bounds each queue of the shuffle this dataset
    launches. With a ``queue_name`` (the JAX package's rule), rank 0
    launches the shuffle for every rank into a queue registered under
    that name, and a dataset of another rank in the same process reads
    its queue from there (``multiqueue.connect_queue``; the engine's
    arguments are rank 0's to give).
    """

    def __init__(self, filenames: Sequence[str], num_epochs: Optional[int],
                 num_trainers: int, batch_size: int, rank: int,
                 drop_last: bool = False,
                 num_reducers: Optional[int] = None,
                 max_concurrent_epochs: int = 2,
                 batch_queue: Optional[mq.MultiQueue] = None,
                 shuffle_result: Optional[ex.TaskRef] = None,
                 seed: int = 0, map_transform=None, reduce_transform=None,
                 start_epoch: int = 0, max_batch_queue_size: int = 0,
                 queue_name: Optional[str] = None, **shuffle_kwargs):
        connects = (batch_queue is None and queue_name is not None
                    and rank != 0)
        if batch_queue is None and num_epochs is None and not connects:
            # The queues of a stream are sized by whoever produces its
            # windows; a static shuffle here would need an epoch count.
            raise ValueError(
                "num_epochs=None (unbounded streaming) requires a "
                "batch_queue from the streaming serving plane; "
                "rank 0 cannot launch a static shuffle without an "
                "epoch count")
        if num_epochs is not None and not 0 <= start_epoch <= num_epochs:
            raise ValueError(
                f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
        if num_epochs is None and start_epoch < 0:
            raise ValueError(f"start_epoch {start_epoch} must be >= 0")
        self._owns_queue = False
        if connects:
            batch_queue, shuffle_result = mq.connect_queue(queue_name), None
        elif batch_queue is None:
            batch_queue, shuffle_result = create_batch_queue_and_shuffle(
                filenames, num_epochs, num_trainers, max_concurrent_epochs,
                num_reducers, seed=seed, map_transform=map_transform,
                only_rank=None if queue_name is not None else rank,
                reduce_transform=reduce_transform, start_epoch=start_epoch,
                max_batch_queue_size=max_batch_queue_size,
                queue_name=queue_name, **shuffle_kwargs)
            self._owns_queue = True
        elif shuffle_kwargs:
            raise ValueError(
                f"{sorted(shuffle_kwargs)} configure the shuffle this "
                "dataset launches; with a batch_queue, pass them to the "
                "shuffle that fills it")
        self._batch_queue = batch_queue
        self._shuffle_result = shuffle_result
        self._batch_size = batch_size
        self._num_epochs = num_epochs
        self._start_epoch = start_epoch
        self._seed = seed
        self._num_trainers = num_trainers
        self._rank = rank
        self._drop_last = drop_last
        self._skip_batches = 0
        self._epoch: Optional[int] = None
        self._last_epoch: Optional[int] = None
        self._lat_queue = str(rank)
        self._lat_anchors = rt_latency.ClockAnchors()
        # A remote queue observes birth_to_delivered from the frame's
        # stamps; observing it here too would count the hop twice.
        self._lat_observe = not getattr(batch_queue, "observes_delivery",
                                        False)

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def shuffle_result(self) -> Optional[ex.TaskRef]:
        """The shuffle's result: its duration, or its ``TrialStats``
        with ``collect_stats``."""
        return self._shuffle_result

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def num_epochs(self) -> Optional[int]:
        """The trial's epoch count; None for an unbounded stream."""
        return self._num_epochs

    @property
    def start_epoch(self) -> int:
        return self._start_epoch

    @property
    def drop_last(self) -> bool:
        return self._drop_last

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Declare the epoch about to be iterated; ``skip_batches`` drops
        its first N batches (checkpoint resume) as zero-copy slices."""
        if epoch < 0 or (self._num_epochs is not None
                         and epoch >= self._num_epochs):
            raise ValueError(
                f"epoch {epoch} out of range [0, {self._num_epochs})")
        if epoch < self._start_epoch:
            raise ValueError(
                f"epoch {epoch} precedes start_epoch {self._start_epoch}; "
                "it is never shuffled, so iterating it would block forever")
        if skip_batches < 0:
            raise ValueError(f"skip_batches must be >= 0, got {skip_batches}")
        self._skip_batches = skip_batches
        self._epoch = epoch

    def iter_tables(self) -> Iterator[pa.Table]:
        """This epoch's raw reducer tables, after the ``skip_batches``
        row skip."""
        if self._epoch is None or self._epoch == self._last_epoch:
            raise ValueError(
                "call set_epoch() before iterating each epoch")
        skip_rows = self._skip_batches * self._batch_size
        to_skip = skip_rows
        self._skip_batches = 0
        queue_idx = mq.queue_index(self._epoch, self._rank,
                                   self._num_trainers)
        # A remote queue hands out each table's absolute row position in
        # its queue's stream: a server that replays from a watermark
        # restarts the stream mid-epoch, so the resume skip is "rows
        # before position skip_rows", not a count of rows seen here.
        get_positioned = getattr(self._batch_queue, "get_positioned", None)
        while True:
            # The epoch-tagged wait: where the consumer blocks when the
            # shuffle cannot keep up (the queue's own queue_get events
            # carry no epoch). Begin/end, so that a get that dies still
            # records the time spent here.
            wait_span = rt_telemetry.span_begin(
                "queue_wait", epoch=self._epoch, task=queue_idx)
            try:
                if get_positioned is not None:
                    ref, row_offset = get_positioned(queue_idx)
                else:
                    ref, row_offset = self._batch_queue.get(queue_idx), None
            finally:
                rt_telemetry.span_end(wait_span)
            if ref is None:
                break
            if isinstance(ref, ShuffleFailure):
                raise RuntimeError(
                    "the shuffle driver died; no more batches are coming"
                ) from ref.error
            # An in-process queue holds task refs, a remote queue
            # materialized tables. A spilled output is mapped back only
            # if some of it survives the skip.
            raw = ref.result() if hasattr(ref, "result") else ref
            if row_offset is not None:
                to_skip = max(0, skip_rows - row_offset)
            if to_skip and raw.num_rows <= to_skip:
                if row_offset is None:
                    to_skip -= raw.num_rows
                continue
            table: pa.Table = spill.unwrap(raw)
            if self._lat_observe:
                self._observe_delivered(table)
            if to_skip:
                table = table.slice(to_skip)
                to_skip = 0
            yield table
            # Not pinned by this frame while the next get blocks (the
            # budget wait wakes on its ledger release).
            ref = raw = table = None
        self._last_epoch = self._epoch
        rt_telemetry.epoch_complete(self._epoch, source="dataset")
        if (self._num_epochs is not None
                and self._epoch == self._num_epochs - 1
                and self._shuffle_result is not None):
            self._shuffle_result.result()
            self.shutdown()

    def _observe_delivered(self, table: pa.Table) -> None:
        """The ``birth_to_delivered`` hop of a reducer output, from its
        ``rsdl.birth`` stamp, and the rank's freshness gauge."""
        meta = table.schema.metadata
        birth = rt_latency.parse_stamp(
            meta.get(rt_latency.BIRTH_META_KEY) if meta else None)
        if birth is None:
            return
        age = self._lat_anchors.latency_s(birth)
        rt_latency.observe_hop(rt_latency.HOP_BIRTH_TO_DELIVERED,
                               self._lat_queue, age)
        rt_latency.set_freshness(self._lat_queue, age)

    def __iter__(self) -> Iterator[pa.Table]:
        return slice_batches(self.iter_tables(), self._batch_size,
                             self._drop_last)

    def commit_consumed(self) -> None:
        """Tell a manual-ack batch queue that consumption so far is
        durable (``checkpoint.resume_iterator`` calls this after each
        save); a no-op for in-process and auto-ack queues."""
        commit = getattr(self._batch_queue, "commit", None)
        if commit is not None:
            commit()

    def shutdown(self) -> None:
        """Close the queues if this dataset created them. Idempotent."""
        if self._owns_queue:
            self._batch_queue.shutdown()
            self._owns_queue = False


def slice_batches(tables: Iterator[pa.Table], batch_size: int,
                  drop_last: bool) -> Iterator[pa.Table]:
    """Exact-size re-batching over variable-size tables; the carry buffer
    spans table boundaries and is concatenated only when a batch fills."""
    carry: List[pa.Table] = []
    carry_rows = 0
    for table in tables:
        offset = 0
        num_rows = table.num_rows
        if carry_rows:
            take = min(batch_size - carry_rows, num_rows)
            carry.append(table.slice(0, take))
            carry_rows += take
            offset = take
            if carry_rows == batch_size:
                yield pa.concat_tables(carry, promote_options="permissive")
                carry = []
                carry_rows = 0
        while num_rows - offset >= batch_size:
            yield table.slice(offset, batch_size)
            offset += batch_size
        if offset < num_rows:
            carry.append(table.slice(offset))
            carry_rows += num_rows - offset
    if carry_rows and not drop_last:
        yield pa.concat_tables(carry, promote_options="permissive")
