"""Seeded per-epoch map/reduce shuffle engine with epoch pipelining (own
copy of the JAX package's ``shuffle.py``, thread backend).

Per epoch, one map task per Parquet file reads it, applies the optional
map-time transform (the narrow-dtype cast) and plans which reducer each
row goes to (the native counter-based plan). One reduce task per reducer
gathers its rows from every file, in file order, and permutes them with
its ``(seed, epoch, reducer)`` stream, then applies the optional
reduce-time transform (the image decode). Each trainer rank receives a
contiguous span of reducer outputs, in reducer order, then a ``None``
end-of-epoch sentinel. The output equals the JAX package's shuffle bit
for bit for the same files, seed and reducer count.

The engine:

- **Plan and scheduler**: each epoch is an explicit
  :class:`plan.ir.EpochPlan` (files -> map partitions -> reduce slices ->
  queue routes) that a :class:`plan.scheduler.PlanScheduler` dispatches
  onto the :class:`executor.Executor` in dependency order: a reduce is
  submitted only once every map has resolved, so no worker ever waits on
  an unfinished input. At most ``max_concurrent_epochs`` epochs are in
  flight; launching another first drains the oldest.
- **Maps**: a :class:`MapShard` keeps the decoded table (as numpy rows)
  and the partition plan; the reduce gathers its rows from it. Without a
  file cache the **fused streaming map** (``shuffle_fused_pipeline``, on
  by default) decodes the file record batch by record batch straight into
  per-reducer regions (:class:`FusedMapShard`) through the native
  kernels; a file outside its contract (a non-primitive or nullable
  column, a transform that is not per row) takes the read-then-plan map.
  Both give the same reducer outputs.
- **File cache** (``file_cache="auto"``): a :class:`FileTableCache` of
  decoded, map-transformed tables keyed by file name, so later epochs
  skip the read and decode; a hit is never transformed again.
  ``"disk"`` keeps them as Arrow IPC files on local scratch
  (:class:`DiskTableCache`); ``"tiered"`` is a :class:`TieredStore` (a
  RAM LRU over a CRC'd, ledger-charged disk tier over the storage source),
  whose next-epoch files the plan scheduler warms on idle lanes.
- **Storage**: every map reads through ``storage`` (the installed
  source: local files, HTTP range reads or the simulated object store),
  where the ``storage_read`` and ``storage_stall`` fault sites fire.
- **Backends** (``executor_backend``, ``executor.resolve_backend``): the
  thread pool, or the process pool (``procpool.py``), whose workers run
  the same map and reduce bodies and hand tables over as Arrow IPC
  segments in shared memory; there, the pool's segments are the file
  cache. Both give the same reducer outputs.
- **Recovery**: a failed map is recomputed from its ``(seed, epoch,
  file)`` lineage by the first reduce that observes it
  (:class:`EpochLineage`); a failed reduce body is re-run in its task;
  ``task_retries`` re-runs any failed task in the executor first.
  ``on_bad_file="skip"`` quarantines an unreadable file into a
  ``QuarantinedFile`` report and shuffles the rest. The fault sites
  ``map_read`` and ``reduce_gather`` (``runtime/faults.py``) are those of
  the JAX package.
- **Memory budget**: every decoded table, map output and reducer output
  is charged to the native buffer ledger for the lifetime of its handle.
  With ``max_inflight_bytes`` an epoch launch waits (woken by releases,
  ``runtime/release.py``) until the pipeline's transient bytes are under
  the budget; with ``spill_dir`` too, reducer outputs produced while over
  budget go to Arrow IPC files instead (``spill.py``) and the consumer
  maps them back (``spill.unwrap``).
- **Stats**: ``collect_stats=True`` returns a ``stats.TrialStats`` (map,
  reduce and consume stage spans per epoch).

Primitive and fixed-size list columns move as numpy rows (the native
``scatter_gather`` for 1/2/4/8-byte items); a table with a null-free
binary column (encoded images) is concatenated and permuted with Arrow's
``take`` instead. In the distributed shuffle (``parallel/distributed.py``)
a reducer also takes its rows of a remote file as a table received from
the host that mapped it, in global file order, so the output is the
same.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import os
import threading
import timeit
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import pyarrow as pa

from ray_shuffling_data_loader_tpu_torch import executor as ex
from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch import partition
from ray_shuffling_data_loader_tpu_torch import spill
from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
from ray_shuffling_data_loader_tpu_torch import storage as rt_storage
from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.plan import scheduler as plan_sched
from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import release as rt_release
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
# The disk caches live in storage/; re-exported under the JAX package's
# names here, as fileio is.
from ray_shuffling_data_loader_tpu_torch.storage.cache import (  # noqa: F401
    DiskTableCache, DiskTier, TieredStore)
from ray_shuffling_data_loader_tpu_torch.utils import fileio  # noqa: F401
from ray_shuffling_data_loader_tpu_torch.utils.singleflight import SingleFlight
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: ``batch_consumer(rank, epoch, refs_or_None)``: refs resolve to the
#: reducer tables (or ``spill.SpilledTable`` handles) routed to ``rank``;
#: ``None`` ends the epoch.
BatchConsumer = Callable[[int, int, Optional[Sequence[ex.TaskRef]]], None]

#: Row-order-preserving ``pa.Table -> pa.Table`` hook run right after the
#: Parquet read. One with a true ``row_elementwise`` attribute may be run
#: per record batch by the streaming map.
MapTransform = Callable[[pa.Table], pa.Table]

#: Row-order-preserving ``pa.Table -> pa.Table`` hook run on every reducer
#: output that has columns, 0-row outputs included, so that every reducer
#: hands on the same schema (e.g. encoded images -> fixed-size pixel lists).
ReduceTransform = Callable[[pa.Table], pa.Table]

#: Threads of one native plan or scatter-gather call where no pool-aware
#: count was derived (direct calls): modest, so concurrent tasks do not
#: oversubscribe the host.
_SCATTER_GATHER_THREADS = max(1, min(4, os.cpu_count() or 1))

#: How long an over-budget epoch launch waits for consumers to release
#: tables before it proceeds with a warning (policy key
#: ``budget_wait_timeout_s``).
_BUDGET_POLL_TIMEOUT_S = 30.0

#: Record-batch size of the streaming map: big enough to amortize the
#: per-batch Python work, small enough to keep one batch cache-resident.
_FUSED_STREAM_BATCH_ROWS = 1 << 16

# Shared pool for the per-column gathers of a reduce: leaf work only (no
# column task waits on another), so it cannot deadlock at any width.
_column_pool: Optional[cf.ThreadPoolExecutor] = None
_column_pool_lock = threading.Lock()


def _column_gather_pool() -> cf.ThreadPoolExecutor:
    global _column_pool
    if _column_pool is None:
        with _column_pool_lock:
            if _column_pool is None:
                _column_pool = cf.ThreadPoolExecutor(
                    max_workers=max(2, min(16, os.cpu_count() or 1)),
                    thread_name_prefix="rsdl-gather-col")
    return _column_pool


def derive_gather_threads(concurrent_reduces: int, pool_workers: int,
                          host_share: int = 1) -> int:
    """Threads per reduce task's gather: the host's cores divided across
    the reduce tasks that can run at once (``concurrent_reduces``, e.g.
    ``num_reducers * max_concurrent_epochs``, capped by the pool's
    width). ``host_share`` is how many shuffle hosts share this machine
    (a loopback world of two passes 2)."""
    cores = (os.cpu_count() or 1) // max(1, host_share)
    concurrent = max(1, min(concurrent_reduces, pool_workers))
    return max(1, min(16, cores // concurrent))


def _transient_read_retryable(error: BaseException) -> bool:
    """The map read's in-place retry: an IO blip heals on retry; corrupt
    content (``ArrowInvalid``) and injected task faults do not, and go to
    quarantine or lineage."""
    return isinstance(error, OSError) and not isinstance(
        error, rt_faults.InjectedFault)


def default_fault_policies() -> Dict[str, rt_retry.RetryPolicy]:
    """Per-stage retry policies (``RSDL_RETRY_*``, or per stage
    ``RSDL_MAP_READ_RETRY_*`` / ``RSDL_REDUCE_RETRY_*`` /
    ``RSDL_LINEAGE_RETRY_*``), built once per shuffle driver."""
    return {
        "read": rt_retry.RetryPolicy.for_component(
            "map_read", retryable=_transient_read_retryable),
        "reduce": rt_retry.RetryPolicy.for_component("reduce"),
        "lineage": rt_retry.RetryPolicy.for_component("lineage"),
    }


# ---------------------------------------------------------------------------
# Columns as numpy rows
# ---------------------------------------------------------------------------


def _is_primitive(t: pa.DataType) -> bool:
    return (pa.types.is_integer(t) or pa.types.is_floating(t)
            or pa.types.is_boolean(t))


def column_to_rows(col: pa.ChunkedArray, name: str) -> np.ndarray:
    """One ndarray row per table row: a null-free primitive column becomes
    ``(N,)``, a null-free ``FixedSizeList<primitive>[W]`` column (token
    sequences) ``(N, W)``, its child values flattened and reshaped.
    Anything else raises ``ValueError`` (a null-free binary column is not
    taken here: its table is reduced with Arrow's ``take``)."""
    t = col.type
    if col.null_count == 0 and _is_primitive(t):
        return col.combine_chunks().to_numpy(zero_copy_only=False)
    if (col.null_count == 0 and pa.types.is_fixed_size_list(t)
            and _is_primitive(t.value_type)):
        values = col.combine_chunks().flatten()
        if values.null_count == 0:
            return values.to_numpy(zero_copy_only=False).reshape(
                -1, t.list_size)
    raise ValueError(
        f"column {name!r} ({t}) is neither a null-free primitive column nor "
        "a null-free fixed-size list of one")


def _is_binary_column(col: pa.ChunkedArray) -> bool:
    """A null-free ``binary`` or ``large_binary`` column: reduced with
    Arrow's ``take`` rather than as numpy rows."""
    return col.null_count == 0 and (pa.types.is_binary(col.type)
                                    or pa.types.is_large_binary(col.type))


def _promote_large_offsets(table: pa.Table) -> pa.Table:
    """Cast ``binary`` columns (the only variable-width type a reducer
    takes) to ``large_binary``, so one reducer output may hold more than
    2 GiB of them."""
    schema = pa.schema([f.with_type(pa.large_binary())
                        if pa.types.is_binary(f.type) else f
                        for f in table.schema],
                       metadata=table.schema.metadata)
    return table.cast(schema)


def _numpy_columns(table: pa.Table) -> Optional[Dict[str, np.ndarray]]:
    """{column -> ndarray}, one row per table row (see
    :func:`column_to_rows`), or None where the table has a null-free
    binary column (its other columns are still checked, so an unsupported
    type raises)."""
    columns = [table.column(name) for name in table.column_names]
    if any(_is_binary_column(col) for col in columns):
        for name, col in zip(table.column_names, columns):
            if not _is_binary_column(col):
                column_to_rows(col, name)  # raises on an unsupported type
        return None
    return {name: column_to_rows(col, name)
            for name, col in zip(table.column_names, columns)}


def _rows_to_arrow(rows: np.ndarray, arrow_type: pa.DataType) -> pa.Array:
    """Inverse of :func:`column_to_rows` for one reduced column."""
    if rows.ndim == 1:
        return pa.array(rows, type=arrow_type)
    values = pa.array(rows.reshape(-1), type=arrow_type.value_type)
    return pa.FixedSizeListArray.from_arrays(values, type=arrow_type)


# ---------------------------------------------------------------------------
# Decoded-file cache
# ---------------------------------------------------------------------------

_cache_totals_lock = threading.Lock()
_cache_totals = {"hits": 0, "misses": 0, "puts": 0, "bytes_put": 0}


def file_cache_totals() -> Dict[str, int]:
    """``{hits, misses, puts, bytes_put}`` over every
    :class:`FileTableCache` of the process since import (monotonic:
    snapshot before and after a run)."""
    with _cache_totals_lock:
        return dict(_cache_totals)


def _count_cache(**deltas) -> None:
    with _cache_totals_lock:
        for key, value in deltas.items():
            _cache_totals[key] += value


class FileTableCache:
    """Bounded, thread-safe cache of decoded and map-transformed tables,
    keyed by file name (never by file index: a file's index moves with the
    list it is in). Insertion stops at the byte budget; there is no
    eviction, since every cached file is hit once per epoch.

    One load per file: a :meth:`get` that misses makes its caller the
    file's loader until it calls :meth:`release` (after its :meth:`put`,
    or on failure), and a :meth:`get` of the same file meanwhile waits
    for that load instead of reading the file again. Two epochs in flight
    submit their maps together, so without this epoch 1's maps would
    start while epoch 0's still read the same files, and miss. (The JAX
    package's cache has no such wait.)"""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._bytes = 0
        self._tables: Dict[str, pa.Table] = {}
        self._loads = SingleFlight()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[pa.Table]:
        """The cached table, waiting for a load of ``key`` in flight; None
        makes the caller ``key``'s loader, which must :meth:`release` it."""
        while True:
            flight = None
            with self._lock:
                table = self._tables.get(key)
                if table is not None:
                    self.hits += 1
                else:
                    flight = self._loads.claim(key)
                    if flight is None:
                        self.misses += 1
            if flight is None:
                _count_cache(hits=int(table is not None),
                             misses=int(table is None))
                return table
            flight.wait()

    def put(self, key: str, table: pa.Table) -> bool:
        """Insert if the budget allows; True if the table is cached."""
        with self._lock:
            if key in self._tables:
                return True
            nbytes = table.nbytes
            if self._bytes + nbytes > self.max_bytes:
                return False
            self._tables[key] = table
            self._bytes += nbytes
        _count_cache(puts=1, bytes_put=nbytes)
        return True

    def release(self, key: str) -> None:
        """End the caller's load of ``key``: wake the gets waiting on it
        (which find the table, or, where it was not cached, load it)."""
        self._loads.release(key)

    @property
    def bytes_cached(self) -> int:
        with self._lock:
            return self._bytes


def default_file_cache() -> Optional[FileTableCache]:
    """A cache budgeted at a third of the host's available RAM (None where
    that cannot be read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    kb = int(line.split()[1])
                    return FileTableCache(max_bytes=kb * 1024 // 3)
    except (OSError, ValueError, IndexError):
        pass
    return None


def default_disk_cache_bytes(cache_dir: Optional[str] = None) -> int:
    """The disk budget of ``file_cache="disk"``/``"tiered"``: half the
    free space of the scratch filesystem."""
    import shutil
    import tempfile
    try:
        return shutil.disk_usage(cache_dir or tempfile.gettempdir()).free // 2
    except OSError:
        return 16 << 30


def resolve_file_cache(spec, epochs_remaining: int):
    """``(cache, owned)`` for a ``file_cache`` argument: ``"auto"`` (a RAM
    :class:`FileTableCache` when a file will be mapped more than once),
    ``"disk"`` (a :class:`DiskTableCache` of
    :func:`default_disk_cache_bytes`), ``"tiered"`` (a :class:`TieredStore`:
    the RAM budget over a ledger-charged :class:`DiskTier` over the
    installed storage source), None, or an instance (anything with the
    ``get``/``put``/``bytes_cached`` protocol). ``owned`` is True where
    this call made a disk-backed cache, which the driver closes after the
    run."""
    if spec == "auto":
        return (default_file_cache() if epochs_remaining > 1 else None,
                False)
    if spec in ("disk", "tiered"):
        if epochs_remaining <= 1:
            return None, False
        if spec == "disk":
            return DiskTableCache(max_bytes=default_disk_cache_bytes()), True
        ram = default_file_cache()
        return TieredStore(
            ram.max_bytes if ram is not None else 1 << 30,
            disk=DiskTier(max_bytes=default_disk_cache_bytes()),
            source=rt_storage.get_source()), True
    if spec is None or hasattr(spec, "get") and hasattr(spec, "put"):
        return spec, False
    raise ValueError(f"file_cache must be 'auto', 'disk', 'tiered', None "
                     f"or a cache, got {spec!r}")


# ---------------------------------------------------------------------------
# Map outputs
# ---------------------------------------------------------------------------


class MapShard:
    """A read-then-plan map output: the file's table and its partition
    plan; reducer ``r``'s rows are ``flat[offsets[r]:offsets[r+1]]``, in
    original row order. ``columns`` holds the rows as numpy (one entry per
    column, :func:`column_to_rows`), or is None where the table has a
    binary column (the reduce then takes rows with Arrow). Indexing gives
    a reducer's :class:`LazyChunk`; the gather is left to the reduce."""

    __slots__ = ("table", "columns", "schema", "flat", "offsets")

    def __init__(self, table: pa.Table, flat: np.ndarray,
                 offsets: np.ndarray):
        self.table = table
        self.columns = _numpy_columns(table)
        self.schema = table.schema
        self.flat = flat
        self.offsets = offsets

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, reducer: int) -> "LazyChunk":
        return LazyChunk(self, reducer)

    def __iter__(self):
        return (self[r] for r in range(len(self)))

    def indices(self, reducer: int) -> np.ndarray:
        return self.flat[self.offsets[reducer]:self.offsets[reducer + 1]]


class LazyChunk:
    """One reducer's rows of a :class:`MapShard`, gathered on demand."""

    __slots__ = ("shard", "reducer_index")

    def __init__(self, shard: MapShard, reducer_index: int):
        self.shard = shard
        self.reducer_index = reducer_index

    @property
    def schema(self) -> pa.Schema:
        return self.shard.schema

    @property
    def indices(self) -> np.ndarray:
        return self.shard.indices(self.reducer_index)

    @property
    def num_rows(self) -> int:
        return len(self.indices)

    def materialize(self) -> pa.Table:
        """These rows as a table of the file's schema, in original row
        order (what crosses the wire to a reducer on another host)."""
        idx = self.indices
        shard = self.shard
        if shard.columns is None:
            return shard.table.take(idx)
        return pa.Table.from_arrays(
            [_rows_to_arrow(shard.columns[field.name][idx], field.type)
             for field in shard.schema], schema=shard.schema)


class FusedMapShard:
    """A streaming map output: the rows already grouped by reducer
    (``table``, backed by the numpy ``columns``); reducer ``r``'s rows
    are the slice ``[offsets[r], offsets[r+1])``, in original row order,
    so its :class:`FusedChunk` is zero-copy."""

    __slots__ = ("table", "columns", "schema", "offsets")

    def __init__(self, table: pa.Table, offsets: np.ndarray,
                 columns: Dict[str, np.ndarray]):
        self.table = table
        self.columns = columns
        self.schema = table.schema
        self.offsets = offsets

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, reducer: int) -> "FusedChunk":
        return FusedChunk(self, reducer)

    def __iter__(self):
        return (self[r] for r in range(len(self)))


class FusedChunk:
    """One reducer's zero-copy slice of a :class:`FusedMapShard`."""

    __slots__ = ("shard", "reducer_index")

    def __init__(self, shard: FusedMapShard, reducer_index: int):
        self.shard = shard
        self.reducer_index = reducer_index

    @property
    def bounds(self) -> Tuple[int, int]:
        offsets = self.shard.offsets
        return (int(offsets[self.reducer_index]),
                int(offsets[self.reducer_index + 1]))

    @property
    def schema(self) -> pa.Schema:
        return self.shard.schema

    @property
    def num_rows(self) -> int:
        lo, hi = self.bounds
        return hi - lo

    def materialize(self) -> pa.Table:
        lo, hi = self.bounds
        return self.shard.table.slice(lo, hi - lo)


#: A reducer's rows of one file: a chunk of a local map output, or those
#: rows already materialized, a table received from the host that mapped
#: the file. A whole map shard is also taken (the reduce indexes it).
Chunk = Union[LazyChunk, FusedChunk, pa.Table, MapShard, FusedMapShard]
MapOutput = Union[MapShard, FusedMapShard, rt_faults.QuarantinedFile]


# ---------------------------------------------------------------------------
# The map task
# ---------------------------------------------------------------------------


def _fused_pipeline_enabled() -> bool:
    return rt_policy.resolve("shuffle", "shuffle_fused_pipeline") is not False


def _fused_stream_columns(filename: str, num_reducers: int, seed: int,
                          epoch: int, file_index: int,
                          map_transform: Optional[MapTransform]):
    """Stream a Parquet file's record batches straight into per-reducer
    grouped column buffers: decode, partition and gather fused, with no
    decoded table in between. Returns ``(columns, offsets, names)``, or
    None where the file is outside the contract (a non-primitive or
    nullable column, a transform that is not per row, 2**31 rows or more,
    a schema that changes mid-file); the caller then takes the
    read-then-plan map, whose output is the same.

    The per-reducer counts come from the hash stream alone (no data), and
    each batch's rows go to the slots :func:`native.assign_dest` gives,
    which fill every region in original row order: the layout of the
    read-then-plan map's stable counting sort."""
    if map_transform is not None and not getattr(
            map_transform, "row_elementwise", False):
        return None
    pf = rt_storage.open_parquet(filename, epoch=epoch, task=file_index)
    try:
        num_rows = pf.metadata.num_rows
        if num_rows <= 0 or num_rows >= 2**31:
            return None
        key = partition.partition_key(seed, epoch, file_index)
        counts = native.partition_counts(num_rows, num_reducers, key,
                                         nthreads=_SCATTER_GATHER_THREADS)
        offsets = np.zeros(num_reducers + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        cursors = offsets[:-1].copy()
        out_cols: Optional[Dict[str, np.ndarray]] = None
        names: Optional[List[str]] = None
        row0 = 0
        for batch in pf.iter_batches(batch_size=_FUSED_STREAM_BATCH_ROWS):
            tbl = pa.Table.from_batches([batch])
            if map_transform is not None:
                tbl = map_transform(tbl)
                if tbl.num_rows != batch.num_rows:
                    return None
            try:
                cols = _numpy_columns(tbl)
            except ValueError:  # a nullable or unsupported column
                return None
            if cols is None or any(a.ndim != 1 for a in cols.values()):
                return None
            if out_cols is None:
                names = list(cols)
                out_cols = {name: np.empty(num_rows, dtype=cols[name].dtype)
                            for name in names}
            elif (list(cols) != names
                  or any(cols[n].dtype != out_cols[n].dtype for n in names)):
                return None
            dest = native.assign_dest(tbl.num_rows, num_reducers, key, row0,
                                      cursors)
            for name in names:
                src = np.ascontiguousarray(cols[name])
                if src.dtype.itemsize in (1, 2, 4, 8):
                    native.scatter_gather(src, None, dest, out_cols[name],
                                          nthreads=_SCATTER_GATHER_THREADS)
                else:
                    out_cols[name][dest] = src
            row0 += tbl.num_rows
        if out_cols is None or row0 != num_rows:
            return None  # torn metadata: the plain reader diagnoses it
        return out_cols, offsets, names
    finally:
        pf.close()


def _fused_stream_map(filename: str, num_reducers: int, seed: int,
                      epoch: int, file_index: int,
                      map_transform: Optional[MapTransform]
                      ) -> Optional[FusedMapShard]:
    """:func:`_fused_stream_columns` as a :class:`FusedMapShard` (None
    where the file is outside the streaming contract)."""
    streamed = _fused_stream_columns(filename, num_reducers, seed, epoch,
                                     file_index, map_transform)
    if streamed is None:
        return None
    out_cols, offsets, names = streamed
    table = pa.table({name: out_cols[name] for name in names})
    native.account_table(table)
    return FusedMapShard(table, offsets, out_cols)


def _read_map_table(filename: str, epoch: int, file_index: int,
                    read_retry: Optional[rt_retry.RetryPolicy],
                    inject: bool = True) -> pa.Table:
    """The map's read: the ``map_read`` fault site (unless the caller has
    fired it for this task already), then the storage read with its
    sites, the fetch retried in place under ``read_retry``. The sites
    fire outside the retry: an injected fault is a lost task for lineage
    recovery, not an IO blip."""
    if inject:
        rt_faults.inject("map_read", epoch=epoch, task=file_index)
    return rt_storage.read_table(filename, epoch=epoch, task=file_index,
                                 retry=read_retry)


def _quarantine(filename: str, epoch: int, file_index: int,
                error: BaseException) -> rt_faults.QuarantinedFile:
    report = rt_faults.QuarantinedFile(
        filename=filename, epoch=epoch, file_index=file_index,
        error=f"{type(error).__name__}: {error}")
    stats_mod.fault_stats().record_quarantine(report)
    logger.error("quarantined unreadable input file %s (epoch %d, file %d):"
                 " %s; shuffling the remaining files (on_bad_file='skip')",
                 filename, epoch, file_index, error)
    return report


def shuffle_map(filename: str, num_reducers: int, seed: int, epoch: int,
                file_index: int, stats_collector=None,
                map_transform: Optional[MapTransform] = None,
                file_cache: Optional[FileTableCache] = None,
                on_bad_file: str = "raise",
                read_retry: Optional[rt_retry.RetryPolicy] = None
                ) -> MapOutput:
    """Read one file and plan the scatter of its rows across reducers.

    Returns a :class:`MapShard` or :class:`FusedMapShard`, or, where the
    file is unreadable after ``read_retry`` and ``on_bad_file="skip"``, a
    ``QuarantinedFile`` report that the reduce drops. The ``map_read``
    fault site fires once per call that reads the file (a cache hit does
    not read it). With a cache, a hit is the cached table as the transform
    left it; a miss is read, transformed, made single-chunk and cached.
    """
    if on_bad_file not in ("raise", "skip"):
        raise ValueError(
            f"on_bad_file must be 'raise' or 'skip', got {on_bad_file!r}")
    if stats_collector is not None:
        stats_collector.map_start(epoch)
    start = timeit.default_timer()

    def done(shard, read_end: float):
        if stats_collector is not None:
            stats_collector.map_done(epoch, timeit.default_timer() - start,
                                     read_end - start)
        return shard

    inject = True
    if file_cache is None and _fused_pipeline_enabled():
        rt_faults.inject("map_read", epoch=epoch, task=file_index)
        inject = False  # fired once for this task
        fused = functools.partial(_fused_stream_map, filename, num_reducers,
                                  seed, epoch, file_index, map_transform)
        try:
            shard = (fused() if read_retry is None else
                     read_retry.call(fused, describe=f"stream {filename}"))
        except (OSError, pa.ArrowInvalid) as e:
            if on_bad_file != "skip":
                raise
            return done(_quarantine(filename, epoch, file_index, e),
                        timeit.default_timer())
        if shard is not None:
            end = timeit.default_timer()
            return done(shard, end)
    table = file_cache.get(filename) if file_cache is not None else None
    if table is None:
        # FileTableCache and TieredStore make a missing get's caller the
        # file's loader until it releases the file (DiskTableCache has no
        # such wait).
        release = getattr(file_cache, "release", None)
        try:
            try:
                table = _read_map_table(filename, epoch, file_index,
                                        read_retry, inject=inject)
            except (OSError, pa.ArrowInvalid) as e:
                if on_bad_file != "skip":
                    raise
                return done(_quarantine(filename, epoch, file_index, e),
                            timeit.default_timer())
            if map_transform is not None:
                table = map_transform(table)
            if file_cache is not None:
                # Once per cached file: single-chunk columns make every
                # later epoch's numpy views zero-copy.
                table = table.combine_chunks()
                file_cache.put(filename, table)
        finally:
            if release is not None:
                release(filename)
        # Charged for the table's lifetime, in the cache or in this
        # epoch's shard alone.
        native.account_table(table)
    read_end = timeit.default_timer()
    flat, offsets = native.plan_partition_flat(
        table.num_rows, num_reducers,
        partition.partition_key(seed, epoch, file_index),
        nthreads=_SCATTER_GATHER_THREADS)
    return done(MapShard(table, flat, offsets), read_end)


# ---------------------------------------------------------------------------
# The reduce task
# ---------------------------------------------------------------------------


def _source(chunk, reduce_index: int):
    """``(columns or None, row indices or None, num_rows, schema)`` of one
    chunk: numpy columns with the rows to take (None: all, in order), or
    None columns where the chunk has a binary column."""
    if isinstance(chunk, (MapShard, FusedMapShard)):
        chunk = chunk[reduce_index]
    if isinstance(chunk, LazyChunk):
        idx = chunk.indices
        return chunk.shard.columns, idx, len(idx), chunk.schema
    if isinstance(chunk, FusedChunk):
        lo, hi = chunk.bounds
        return ({name: arr[lo:hi] for name, arr in
                 chunk.shard.columns.items()}, None, hi - lo, chunk.schema)
    return _numpy_columns(chunk), None, chunk.num_rows, chunk.schema


def _materialize(chunk, reduce_index: int) -> pa.Table:
    if isinstance(chunk, (MapShard, FusedMapShard)):
        chunk = chunk[reduce_index]
    return chunk if isinstance(chunk, pa.Table) else chunk.materialize()


def _gather_column(name: str, sources, inv: np.ndarray, total: int,
                   threads: int) -> np.ndarray:
    """``out[inv[j]] = concat[j]`` for one column: row ``j`` of the
    chunks' concatenation lands at its permuted position. 1-D columns of
    1/2/4/8-byte items go through the native scatter-gather where the
    indices are int32; rows of a fixed-size list column through numpy."""
    first = sources[0][0][name]
    out = np.empty((total,) + first.shape[1:], dtype=first.dtype)
    native_ok = inv.dtype == np.int32
    offset = 0
    for cols, idx, n, _ in sources:
        dest = inv[offset:offset + n]
        src = cols[name]
        if (native_ok and src.ndim == 1 and src.flags.c_contiguous
                and src.dtype.itemsize in (1, 2, 4, 8)):
            native.scatter_gather(src, idx, dest, out, nthreads=threads)
        else:
            out[dest] = src if idx is None else src[idx]
        offset += n
    return out


def _fused_reduce(reduce_index: int, seed: int, epoch: int, sources,
                  schema: pa.Schema,
                  gather_threads: Optional[int] = None) -> pa.Table:
    """One pass per column: ``out = concat(chunks)[perm]`` without the
    concatenation, through the inverse permutation (int32 indices where
    every index fits, as the native kernel takes)."""
    total = sum(n for _, _, n, _ in sources)
    perm = partition.permutation(
        total, partition.reduce_rng(seed, epoch, reduce_index))
    max_source_rows = max((len(next(iter(cols.values())))
                           for cols, _, _, _ in sources if cols), default=0)
    index_dtype = (np.int32 if max(total, max_source_rows) < 2**31
                   else np.int64)
    inv = np.empty(total, dtype=index_dtype)
    inv[perm] = np.arange(total, dtype=index_dtype)
    sources = [(cols, None if idx is None
                else idx.astype(index_dtype, copy=False), n, s)
               for cols, idx, n, s in sources]
    threads = gather_threads or _SCATTER_GATHER_THREADS
    names = list(schema.names)
    # Columns are independent gathers: fan them out over the shared pool
    # with this task's thread budget split between them (small outputs
    # stay inline, where the handoff costs more than it saves).
    fan_out = min(len(names), threads) if total >= (1 << 16) else 1
    col_threads = max(1, threads // fan_out)
    if fan_out > 1:
        pool = _column_gather_pool()
        futures = [pool.submit(_gather_column, name, sources, inv, total,
                               col_threads) for name in names[1:]]
        rows = ([_gather_column(names[0], sources, inv, total, col_threads)]
                + [f.result() for f in futures])
    else:
        rows = [_gather_column(name, sources, inv, total, col_threads)
                for name in names]
    return pa.table({name: _rows_to_arrow(r, schema.field(name).type)
                     for name, r in zip(names, rows)})


def _take_reduce(reduce_index: int, seed: int, epoch: int,
                 chunks: Sequence[Chunk]) -> pa.Table:
    """``concat[perm]`` with Arrow's ``take`` (tables with a binary
    column); promotes to 64-bit offsets where the output passes 2 GiB of
    variable-width data."""
    table = pa.concat_tables([_materialize(c, reduce_index) for c in chunks])
    perm = partition.permutation(
        table.num_rows, partition.reduce_rng(seed, epoch, reduce_index))
    try:
        return table.take(perm)
    except pa.ArrowInvalid:
        return _promote_large_offsets(table).take(perm)


def shuffle_reduce(reduce_index: int, seed: int, epoch: int,
                   chunks: Sequence[Chunk],
                   reduce_transform: Optional[ReduceTransform] = None,
                   stats_collector=None,
                   gather_threads: Optional[int] = None) -> pa.Table:
    """Concatenate this reducer's rows from every file in file order, then
    permute them: ``out = concat[perm]`` (whole rows of a fixed-size list
    column move together); then ``reduce_transform``, if any. ``chunks``
    holds one entry per file, in global file order (quarantined files
    left out): a chunk of the file's local map output (or the whole
    output), or this reducer's rows of it received from another host."""
    if stats_collector is not None:
        stats_collector.reduce_start(epoch)
    start = timeit.default_timer()
    if not chunks:
        out = pa.table({})
    else:
        sources = [_source(c, reduce_index) for c in chunks]
        schema = sources[0][3]
        for _, _, _, s in sources[1:]:
            if list(s.names) != list(schema.names) or not s.equals(schema):
                raise ValueError("map outputs disagree on their schema")
        if any(cols is None for cols, _, _, _ in sources):
            out = _take_reduce(reduce_index, seed, epoch, chunks)
        else:
            out = _fused_reduce(reduce_index, seed, epoch, sources, schema,
                                gather_threads)
    if reduce_transform is not None and out.num_columns:
        out = reduce_transform(out)
    if stats_collector is not None:
        stats_collector.reduce_done(epoch, timeit.default_timer() - start)
    return out


def recompute_reducer_output(filenames: Sequence[str], num_reducers: int,
                             seed: int, epoch: int, reduce_index: int,
                             map_transform: Optional[MapTransform] = None,
                             reduce_transform: Optional[ReduceTransform]
                             = None,
                             on_bad_file: str = "raise") -> pa.Table:
    """Rebuild one reducer output from its lineage: re-read every input
    file, re-plan its scatter and re-run the reduce. A pure function of
    ``(seed, epoch, reduce_index)`` and the files, so the result equals
    the original bit for bit: the spill tier's recovery of a corrupt
    spill. Self-contained (no map shard captured), so an armed
    ``spill.SpilledTable`` pins only these small arguments."""
    chunks = []
    for file_index, filename in enumerate(filenames):
        shard = shuffle_map(filename, num_reducers, seed, epoch, file_index,
                            None, map_transform, None, on_bad_file, None)
        if not isinstance(shard, rt_faults.QuarantinedFile):
            chunks.append(shard[reduce_index])
    return shuffle_reduce(reduce_index, seed, epoch, chunks,
                          reduce_transform)


class EpochLineage:
    """Recompute lost map outputs from their ``(seed, epoch, file)``
    lineage.

    Every map task is a pure function of ``(seed, epoch, file_index)`` and
    the map configuration held here. A reduce that observes a failed map
    calls :meth:`recover`: the first one recomputes the map **inline on
    its own worker thread** (never on the pool, whose workers may all be
    reduces waiting on this very output), every other one waits for its
    result, so a lost map is recomputed once per epoch. Recovery runs
    under a retry policy; an exhausted one raises (cached, so later
    reduces fail fast), and only that reaches the consumer.
    """

    class _Cell:
        __slots__ = ("done", "result", "error")

        def __init__(self):
            self.done = threading.Event()
            self.result = None
            self.error: Optional[BaseException] = None

    def __init__(self, filenames: Sequence[str], num_reducers: int,
                 seed: int, epoch: int, stats_collector=None,
                 map_transform: Optional[MapTransform] = None,
                 file_cache: Optional[FileTableCache] = None,
                 retry_policy: Optional[rt_retry.RetryPolicy] = None,
                 on_bad_file: str = "raise",
                 read_retry: Optional[rt_retry.RetryPolicy] = None):
        self._filenames = list(filenames)
        self._num_reducers = num_reducers
        self._seed = seed
        self._epoch = epoch
        self._stats_collector = stats_collector
        self._map_transform = map_transform
        self._file_cache = file_cache
        self._retry = (retry_policy if retry_policy is not None
                       else rt_retry.RetryPolicy.for_component("lineage"))
        self._on_bad_file = on_bad_file
        self._read_retry = read_retry
        self._lock = threading.Lock()
        self._cells: Dict[int, EpochLineage._Cell] = {}
        self.recomputes = 0

    def recover(self, file_index: int, cause: BaseException):
        """The recomputed output of map ``file_index`` (a map shard or a
        ``QuarantinedFile``), recomputed at most once."""
        with self._lock:
            cell = self._cells.get(file_index)
            claimed = cell is None
            if claimed:
                cell = self._cells[file_index] = EpochLineage._Cell()
        if claimed:
            self._recompute(file_index, cell, cause)
        else:
            cell.done.wait()
        if cell.error is not None:
            # The recompute's own error (the task is deterministic, so of
            # the original's type), chained to the first one observed.
            raise cell.error from cause
        return cell.result

    def _recompute(self, file_index: int, cell: "EpochLineage._Cell",
                   cause: BaseException) -> None:
        start = timeit.default_timer()
        logger.warning(
            "map task %d (epoch %d) failed (%s); recomputing from lineage",
            file_index, self._epoch, cause)
        try:
            cell.result = self._retry.call(
                shuffle_map, self._filenames[file_index],
                self._num_reducers, self._seed, self._epoch, file_index,
                self._stats_collector, self._map_transform,
                self._file_cache, self._on_bad_file, self._read_retry,
                describe=f"map recompute e{self._epoch} f{file_index}")
        except BaseException as e:  # noqa: BLE001 - cached and re-raised
            stats_mod.fault_stats().record_exhausted("lineage")
            cell.error = e
        else:
            latency = timeit.default_timer() - start
            with self._lock:
                self.recomputes += 1
            stats_mod.fault_stats().record_recompute("lineage", latency)
            logger.info("recomputed map task %d (epoch %d) from lineage in "
                        "%.3fs", file_index, self._epoch, latency)
        finally:
            cell.done.set()


def account_and_maybe_spill(shuffled: pa.Table, spill_manager,
                            recompute=None, epoch: Optional[int] = None,
                            task: Optional[int] = None) -> pa.Table:
    """The post-reduce memory policy of the single-host and distributed
    reduces: charge the output to the buffer ledger, then spill it if a
    spill manager is active and the pipeline is over budget (the
    ``SpilledTable`` handle replaces the table, so its memory goes as
    soon as the reduce returns). ``recompute`` (the single-host reduce's
    :func:`recompute_reducer_output`) arms the handle's recovery of a
    corrupt spill; the distributed reduce passes None (its inputs crossed
    the wire, so a corrupt spill stays a loud failure)."""
    native.account_table(shuffled)
    if spill_manager is not None:
        shuffled = spill_manager.maybe_spill(shuffled, recompute=recompute,
                                             epoch=epoch, task=task)
    return shuffled


def _reduce_task(reduce_index: int, seed: int, epoch: int,
                 map_refs: Sequence[ex.TaskRef], stats_collector,
                 reduce_transform: Optional[ReduceTransform] = None,
                 spill_manager=None,
                 gather_threads: Optional[int] = None,
                 lineage: Optional[EpochLineage] = None,
                 retry_policy: Optional[rt_retry.RetryPolicy] = None,
                 spill_recompute=None):
    """One reduce: this reducer's chunk of every map output, then the
    permutation. A failed map is recomputed through ``lineage``; a
    ``QuarantinedFile`` drops its file; the gather and permute re-run
    under ``retry_policy`` (a pure function of the maps' outputs)."""

    def gather_and_shuffle() -> pa.Table:
        rt_faults.inject("reduce_gather", epoch=epoch, task=reduce_index)
        chunks = []
        for file_index, ref in enumerate(map_refs):
            try:
                shard = ref.result()
            except Exception as e:  # noqa: BLE001 - lineage recovers
                if lineage is None:
                    raise
                shard = lineage.recover(file_index, e)
            if isinstance(shard, rt_faults.QuarantinedFile):
                continue
            chunks.append(shard[reduce_index])
        return shuffle_reduce(reduce_index, seed, epoch, chunks,
                              reduce_transform, stats_collector,
                              gather_threads)

    if retry_policy is None:
        shuffled = gather_and_shuffle()
    else:
        def recovered(failed_attempts: int, elapsed_s: float) -> None:
            stats_mod.fault_stats().record_recompute("reduce", elapsed_s)

        shuffled = retry_policy.call(
            gather_and_shuffle, describe=f"reduce e{epoch} r{reduce_index}",
            on_recovery=recovered)
    return account_and_maybe_spill(shuffled, spill_manager,
                                   recompute=spill_recompute, epoch=epoch,
                                   task=reduce_index)


# ---------------------------------------------------------------------------
# One epoch
# ---------------------------------------------------------------------------


def consume(trainer_idx: int, batch_consumer: BatchConsumer,
            trial_start: float, stats_collector, epoch: int,
            batches: List[ex.TaskRef]) -> None:
    """Hand one trainer its epoch's reducer refs."""
    if stats_collector is not None:
        stats_collector.consume_start(epoch)
    start = timeit.default_timer()
    batch_consumer(trainer_idx, epoch, batches)
    if stats_collector is not None:
        stats_collector.consume_done(epoch, timeit.default_timer() - start,
                                     start - trial_start)


def _shuffle_epoch_thread(plan: plan_ir.EpochPlan, pool: ex.Executor,
                          stats_collector, map_transform, file_cache,
                          reduce_transform, spill_manager, gather_threads,
                          on_bad_file, fault_policies) -> List[ex.TaskRef]:
    """The plan's map and reduce nodes dispatched onto the thread pool in
    dependency order; returns the reduce refs. Speculative backup
    attempts run with no stats collector, so duplicated work never
    double-counts."""
    epoch, seed = plan.epoch, plan.seed
    num_reducers = plan.num_reducers
    filenames = list(plan.filenames)
    lineage = EpochLineage(filenames, num_reducers, seed, epoch,
                           stats_collector, map_transform, file_cache,
                           retry_policy=fault_policies.get("lineage"),
                           on_bad_file=on_bad_file,
                           read_retry=fault_policies.get("read"))

    def spill_recompute(reduce_index: int):
        if spill_manager is None:
            return None
        return functools.partial(
            recompute_reducer_output, filenames, num_reducers, seed, epoch,
            reduce_index, map_transform, reduce_transform, on_bad_file)

    holder: Dict[str, Any] = {}

    def run_map(node, attempt: int):
        return shuffle_map(node.meta["file"], num_reducers, seed, epoch,
                           node.key.task,
                           stats_collector if attempt == 0 else None,
                           map_transform, file_cache, on_bad_file,
                           fault_policies.get("read"))

    def run_reduce(node, attempt: int):
        reduce_index = node.key.task
        map_refs = [holder["scheduler"].ref_for(dep) for dep in node.deps]
        return _reduce_task(reduce_index, seed, epoch, map_refs,
                            stats_collector if attempt == 0 else None,
                            reduce_transform, spill_manager, gather_threads,
                            lineage, fault_policies.get("reduce"),
                            spill_recompute(reduce_index))

    # A tiered cache's files, warmed on idle lanes for the next epoch
    # (which reads the same list), below every real task in priority.
    prefetcher = None
    maker = getattr(file_cache, "make_prefetcher", None)
    if maker is not None and rt_policy.resolve("storage",
                                               "storage_prefetch"):
        prefetcher = maker(plan)
    scheduler = plan_sched.PlanScheduler(
        plan, pool, dispatchers={
            "map": lambda node, attempt: pool.submit(run_map, node,
                                                     attempt),
            "reduce": lambda node, attempt: pool.submit(run_reduce, node,
                                                        attempt)},
        prefetcher=prefetcher)
    holder["scheduler"] = scheduler
    scheduler.start()
    return scheduler.refs("reduce")


def _shuffle_epoch_process(plan: plan_ir.EpochPlan, pool, stats_collector,
                           map_transform, reduce_transform, spill_manager,
                           gather_threads, on_bad_file) -> List[ex.TaskRef]:
    """The epoch on the process pool (``procpool.process_epoch``), with
    the transforms pickled once. A spilled reducer output recovers from
    its lineage in the driver, as on the thread backend."""
    import pickle
    from ray_shuffling_data_loader_tpu_torch import procpool
    epoch, seed = plan.epoch, plan.seed
    num_reducers = plan.num_reducers
    filenames = list(plan.filenames)

    def spill_recompute(reduce_index: int):
        return functools.partial(
            recompute_reducer_output, filenames, num_reducers, seed, epoch,
            reduce_index, map_transform, reduce_transform, on_bad_file)

    return procpool.process_epoch(
        plan, pool, stats_collector,
        pickle.dumps(map_transform) if map_transform is not None else None,
        pickle.dumps(reduce_transform)
        if reduce_transform is not None else None,
        spill_manager, gather_threads, on_bad_file,
        spill_recompute if spill_manager is not None else None)


def shuffle_epoch(epoch: int, filenames: Sequence[str],
                  batch_consumer: BatchConsumer, num_reducers: int,
                  num_trainers: int, pool: ex.Executor, seed: int,
                  trial_start: float, stats_collector=None,
                  map_transform: Optional[MapTransform] = None,
                  file_cache: Optional[FileTableCache] = None,
                  reduce_transform: Optional[ReduceTransform] = None,
                  spill_manager=None,
                  gather_threads: Optional[int] = None,
                  on_bad_file: str = "raise",
                  fault_policies: Optional[Dict[str, Any]] = None
                  ) -> List[ex.TaskRef]:
    """Launch one epoch's plan and route its reducer refs: each route
    node names its rank and contiguous reducer span; the rank gets those
    refs, then ``None``. Returns the reducer refs. ``fault_policies``
    (keys ``read``/``reduce``/``lineage``) default to
    :func:`default_fault_policies`, so a directly driven epoch still
    recovers lost maps."""
    if stats_collector is not None:
        stats_collector.epoch_start(epoch)
    plan = plan_ir.build_epoch_plan(filenames, num_reducers, num_trainers,
                                    seed, epoch)
    if gather_threads is None:
        gather_threads = derive_gather_threads(num_reducers,
                                               pool.num_workers)
    if getattr(pool, "backend", "thread") == "process":
        reduce_refs = _shuffle_epoch_process(
            plan, pool, stats_collector, map_transform, reduce_transform,
            spill_manager, gather_threads, on_bad_file)
    else:
        reduce_refs = _shuffle_epoch_thread(
            plan, pool, stats_collector, map_transform, file_cache,
            reduce_transform, spill_manager, gather_threads, on_bad_file,
            fault_policies if fault_policies is not None
            else default_fault_policies())
    for route in sorted(plan.routes(), key=lambda n: n.key.task):
        rank = route.key.task
        consume(rank, batch_consumer, trial_start, stats_collector, epoch,
                [reduce_refs[i] for i in route.meta["reducers"]])
        batch_consumer(rank, epoch, None)
    return reduce_refs


# ---------------------------------------------------------------------------
# The multi-epoch driver
# ---------------------------------------------------------------------------


def wait_and_raise(refs: List[ex.TaskRef]) -> None:
    """Wait for an epoch's refs and raise the first failure."""
    ex.wait(refs, num_returns=len(refs))
    for ref in refs:
        ref.result()


def shuffle(filenames: Sequence[str], batch_consumer: BatchConsumer,
            num_epochs: int, num_reducers: int, num_trainers: int,
            max_concurrent_epochs: int = 2, seed: int = 0,
            num_workers: Optional[int] = None, collect_stats: bool = False,
            pool: Optional[ex.Executor] = None, start_epoch: int = 0,
            map_transform: Optional[MapTransform] = None,
            file_cache: Union[FileTableCache, None, str] = "auto",
            reduce_transform: Optional[ReduceTransform] = None,
            task_retries: int = 0,
            max_inflight_bytes: Optional[int] = None,
            spill_dir: Optional[str] = None,
            on_bad_file: Optional[str] = None,
            executor_backend: Optional[str] = None
            ) -> Union[stats_mod.TrialStats, float]:
    """Shuffle epochs ``start_epoch .. num_epochs - 1`` (a resumed run
    skips the epochs before its checkpoint) with at most
    ``max_concurrent_epochs`` in flight (the JAX package's signature;
    see the module docstring for the engine).

    - ``num_workers``: pool threads or processes (default one per core);
      ``pool``: a caller's executor instead (not shut down here).
    - ``file_cache``: ``"auto"``, ``"disk"``, ``"tiered"``, None or a
      cache (ignored on the process backend, whose segments cache).
    - ``task_retries``: extra attempts of a failed task in the executor.
    - ``max_inflight_bytes`` / ``spill_dir``: the memory budget and its
      spill tier.
    - ``on_bad_file``: ``"raise"`` or ``"skip"`` (policy key
      ``RSDL_SHUFFLE_ON_BAD_FILE``).
    - ``executor_backend``: ``"auto"``, ``"thread"`` or ``"process"``
      (:func:`executor.resolve_backend`).

    Returns the ``TrialStats`` with ``collect_stats`` (which needs
    ``start_epoch == 0``; off by default, as the port's shuffle returned
    its duration before the engine), else the wall-clock seconds. A map
    or reduce failure that recovery cannot absorb raises here."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    stats_collector = None
    if collect_stats:
        if start_epoch:
            raise ValueError("collect_stats with start_epoch > 0 is "
                             "unsupported (the collectors expect every "
                             "epoch to run)")
        stats_collector = stats_mod.TrialStatsCollector(
            num_epochs, num_maps=len(filenames), num_reduces=num_reducers,
            num_consumes=num_trainers)
        stats_collector.trial_start()
    duration = shuffle_epochs(
        plan_ir.static_epoch_specs(filenames, num_epochs, start_epoch),
        batch_consumer, num_reducers, num_trainers,
        max_concurrent_epochs=max_concurrent_epochs, seed=seed,
        num_workers=num_workers, pool=pool, stats_collector=stats_collector,
        map_transform=map_transform, file_cache=file_cache,
        reduce_transform=reduce_transform, task_retries=task_retries,
        max_inflight_bytes=max_inflight_bytes, spill_dir=spill_dir,
        on_bad_file=on_bad_file, executor_backend=executor_backend,
        epochs_hint=num_epochs - start_epoch)
    if stats_collector is not None:
        stats_collector.trial_done()
        return stats_collector.get_stats()
    return duration


def shuffle_epochs(epoch_specs, batch_consumer: BatchConsumer,
                   num_reducers: int, num_trainers: int,
                   max_concurrent_epochs: int = 2, seed: int = 0,
                   num_workers: Optional[int] = None,
                   pool: Optional[ex.Executor] = None,
                   stats_collector=None,
                   map_transform: Optional[MapTransform] = None,
                   file_cache: Union[FileTableCache, None, str] = "auto",
                   reduce_transform: Optional[ReduceTransform] = None,
                   task_retries: int = 0,
                   max_inflight_bytes: Optional[int] = None,
                   spill_dir: Optional[str] = None,
                   on_bad_file: Optional[str] = None,
                   executor_backend: Optional[str] = None,
                   epochs_hint: Optional[int] = None) -> float:
    """The pipelined driver over an iterator of :class:`plan.ir.EpochSpec`
    (:func:`shuffle` passes :func:`plan.ir.static_epoch_specs`).
    ``epochs_hint`` sizes the file cache and the gather threads' overlap
    (None: an unbounded schedule, no cache). Returns the wall-clock
    seconds."""
    start = timeit.default_timer()
    owns_pool = pool is None
    if pool is None:
        backend = ex.resolve_backend(
            executor_backend, num_workers=num_workers,
            transforms=(map_transform, reduce_transform))
        if backend == "process":
            from ray_shuffling_data_loader_tpu_torch import procpool
            pool = procpool.ProcessPoolExecutor(num_workers=num_workers,
                                                task_retries=task_retries)
        else:
            pool = ex.Executor(num_workers=num_workers,
                               task_retries=task_retries)
    if getattr(pool, "backend", "thread") == "process":
        # The pool's segments are the file cache on this plane (a table
        # cache in the driver would hold a second copy); the budget
        # discounts their growth through the pool's bytes_cached.
        file_cache, owns_file_cache = None, False
        budget_cache = pool
    else:
        # Caching pays only where a file is mapped more than once.
        file_cache, owns_file_cache = resolve_file_cache(
            file_cache, epochs_hint if epochs_hint is not None else 1)
        budget_cache = file_cache
        if hasattr(file_cache, "set_transform"):
            # The cache holds transformed tables: a warm applies the same
            # transform, or a prefetched hit would change the stream.
            file_cache.set_transform(map_transform)
    over_budget, spill_manager = spill.make_budget_state(
        budget_cache, max_inflight_bytes, spill_dir)
    # Up to max_concurrent_epochs epochs' reduces share this pool.
    overlap = (max(1, max_concurrent_epochs) if epochs_hint is None
               else max(1, min(max_concurrent_epochs, epochs_hint)))
    gather_threads = derive_gather_threads(num_reducers * overlap,
                                           pool.num_workers)
    on_bad_file = rt_policy.resolve("shuffle", "on_bad_file",
                                    override=on_bad_file)
    fault_policies = default_fault_policies()
    try:
        in_progress: Dict[int, List[ex.TaskRef]] = {}
        for spec in epoch_specs:
            epoch = spec.epoch
            throttle_start = timeit.default_timer()
            while in_progress and (len(in_progress) >= max_concurrent_epochs
                                   or over_budget()):
                wait_and_raise(in_progress.pop(min(in_progress)))
            if over_budget() and spill_manager is None:
                # Every earlier epoch has drained: wait for consumers to
                # release tables, woken by each release, bounded so that
                # a too-small budget never deadlocks the pipeline. With a
                # spill manager the launch goes ahead and over-budget
                # reducer outputs go to disk instead.
                timeout_s = rt_policy.resolve(
                    "shuffle", "budget_wait_timeout_s",
                    default=_BUDGET_POLL_TIMEOUT_S)
                if not rt_release.wait_while(
                        over_budget, timeout_s=timeout_s,
                        heartbeat_s=rt_policy.resolve(
                            "shuffle", "release_heartbeat_s")):
                    logger.warning(
                        "epoch %d launching over max_inflight_bytes=%d "
                        "(consumers did not release within %.0fs)",
                        epoch, max_inflight_bytes, timeout_s)
            throttled = timeit.default_timer() - throttle_start
            if throttled > 1e-4:
                if stats_collector is not None:
                    stats_collector.throttle_done(epoch, throttled)
                logger.info("epoch %d throttled for %.3fs", epoch, throttled)
            in_progress[epoch] = shuffle_epoch(
                epoch, spec.filenames, batch_consumer,
                spec.num_reducers or num_reducers, num_trainers, pool, seed,
                start if stats_collector is None
                else stats_collector.trial_start_time,
                stats_collector, map_transform, file_cache,
                reduce_transform, spill_manager, gather_threads,
                on_bad_file, fault_policies)
        for epoch in sorted(in_progress):
            wait_and_raise(in_progress.pop(epoch))
    finally:
        if owns_pool:
            pool.shutdown(wait_for_tasks=True, cancel_pending=True)
        if owns_file_cache:
            # Reducer outputs are gathered copies, never views of cached
            # tables, and every ref has drained: no reader is left.
            file_cache.close()
        if spill_manager is not None:
            # The scratch directory goes with the last handle (consumers
            # may still be draining spilled outputs).
            spill_manager.report()
        if owns_pool:
            native.trim_freelist()
    return timeit.default_timer() - start


def shuffle_with_stats(filenames: Sequence[str],
                       batch_consumer: BatchConsumer, num_epochs: int,
                       num_reducers: int, num_trainers: int,
                       max_concurrent_epochs: int = 2, seed: int = 0,
                       num_workers: Optional[int] = None,
                       utilization_sample_period: float = 5.0,
                       **kwargs) -> Tuple[stats_mod.TrialStats, List]:
    """:func:`shuffle` with ``collect_stats`` and a memory sampler
    (process RSS and ledger bytes every ``utilization_sample_period``
    seconds); returns ``(TrialStats, samples)``. ``kwargs`` go to
    :func:`shuffle`."""
    samples: List = []
    done = stats_mod.start_store_stats_sampler(
        samples, sample_period_s=utilization_sample_period)
    try:
        trial = shuffle(filenames, batch_consumer, num_epochs, num_reducers,
                        num_trainers, max_concurrent_epochs, seed=seed,
                        num_workers=num_workers, collect_stats=True,
                        **kwargs)
    finally:
        done.set()
    return trial, samples


def shuffle_no_stats(filenames: Sequence[str],
                     batch_consumer: BatchConsumer, num_epochs: int,
                     num_reducers: int, num_trainers: int,
                     max_concurrent_epochs: int = 2, seed: int = 0,
                     num_workers: Optional[int] = None,
                     **kwargs) -> Tuple[float, List]:
    """:func:`shuffle` for its duration alone: ``(seconds, [])``."""
    duration = shuffle(filenames, batch_consumer, num_epochs, num_reducers,
                       num_trainers, max_concurrent_epochs, seed=seed,
                       num_workers=num_workers, collect_stats=False,
                       **kwargs)
    return duration, []


def run_in_background(run: Callable[[], Any],
                   on_failure: Optional[Callable[[BaseException], None]]
                   ) -> ex.TaskRef:
    """``run()`` on a driver thread of its own; the returned ref resolves
    to its result or raises its error. ``on_failure`` runs before the
    error is stored, so blocked consumers can be woken."""
    driver = ex.Executor(num_workers=1, thread_name_prefix="rsdl-driver")

    def wrapped():
        try:
            return run()
        except BaseException as e:
            logger.error("shuffle failed: %r", e)
            if on_failure is not None:
                try:
                    on_failure(e)
                except Exception:  # noqa: BLE001
                    logger.exception("shuffle on_failure hook itself failed")
            raise
        finally:
            driver.shutdown(wait_for_tasks=False)

    return driver.submit(wrapped)


def run_shuffle_in_background(
        filenames: Sequence[str], batch_consumer: BatchConsumer,
        num_epochs: int, num_reducers: int, num_trainers: int,
        max_concurrent_epochs: int = 2, seed: int = 0,
        on_failure: Optional[Callable[[BaseException], None]] = None,
        **kwargs) -> ex.TaskRef:
    """:func:`shuffle` on a driver thread of its own (``kwargs`` go to it);
    the returned ref resolves to its result (the duration, or the
    ``TrialStats`` with ``collect_stats``) or raises its error."""
    return run_in_background(
        lambda: shuffle(filenames, batch_consumer, num_epochs, num_reducers,
                        num_trainers, max_concurrent_epochs, seed=seed,
                        **kwargs), on_failure)


def run_shuffle_epochs_in_background(
        epoch_specs, batch_consumer: BatchConsumer, num_reducers: int,
        num_trainers: int, max_concurrent_epochs: int = 2, seed: int = 0,
        on_failure: Optional[Callable[[BaseException], None]] = None,
        **kwargs) -> ex.TaskRef:
    """:func:`run_shuffle_in_background` for an epoch-spec schedule
    (``kwargs`` go to :func:`shuffle_epochs`)."""
    return run_in_background(
        lambda: shuffle_epochs(epoch_specs, batch_consumer, num_reducers,
                               num_trainers, max_concurrent_epochs, seed=seed,
                               **kwargs), on_failure)
