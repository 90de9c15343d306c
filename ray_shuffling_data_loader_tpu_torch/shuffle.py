"""Seeded per-epoch map/reduce shuffle with epoch pipelining.

Per epoch, one map task per Parquet file reads it, applies the optional
map-time transform (the narrow-dtype cast) and plans which reducer each row
goes to (:func:`partition.plan_partition_flat`). One reduce task per
reducer concatenates its rows from every file, in file order, and permutes
them with its ``(seed, epoch, reducer)`` stream, then applies the optional
reduce-time transform (the image decode). Primitive and fixed-size list
columns move as numpy rows; a table with a null-free binary column (encoded
images) is concatenated and permuted with Arrow's ``take`` instead, as the
JAX package's fallback reduce does. In the distributed shuffle
(``parallel/distributed.py``) a reducer also takes its rows of a remote
file as a table received from the host that mapped it; it concatenates
them with its local files' rows in global file order, so the output is
the same. Each trainer rank receives
a contiguous span of reducer outputs, in reducer order, then a ``None``
end-of-epoch sentinel. The output equals the JAX package's shuffle bit for
bit for the same files, seed and reducer count.

Tasks are threads on one pool (pyarrow and numpy release the GIL in the
heavy parts). Per epoch every map is submitted before any reduce, so on the
FIFO pool a reduce that waits on a map only ever waits on a task that a
worker has already taken: the pattern cannot deadlock at any pool size. At
most ``max_concurrent_epochs`` epochs are in flight; launching another
first waits for the oldest epoch's reducers.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import timeit
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ray_shuffling_data_loader_tpu_torch import partition
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: ``batch_consumer(rank, epoch, futures_or_None)``: futures resolve to the
#: reducer tables routed to ``rank``; ``None`` ends the epoch.
BatchConsumer = Callable[[int, int, Optional[Sequence[cf.Future]]], None]

#: Row-order-preserving ``pa.Table -> pa.Table`` hook run right after the
#: Parquet read.
MapTransform = Callable[[pa.Table], pa.Table]

#: Row-order-preserving ``pa.Table -> pa.Table`` hook run on every reducer
#: output that has columns, 0-row outputs included, so that every reducer
#: hands on the same schema (e.g. encoded images -> fixed-size pixel lists).
ReduceTransform = Callable[[pa.Table], pa.Table]


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


def _numpy_columns(table: pa.Table) -> Dict[str, np.ndarray]:
    """{column -> ndarray}, one row per table row (see
    :func:`column_to_rows`)."""
    return {name: column_to_rows(table.column(name), name)
            for name in table.column_names}


def _rows_to_arrow(rows: np.ndarray, arrow_type: pa.DataType) -> pa.Array:
    """Inverse of :func:`column_to_rows` for one reduced column."""
    if rows.ndim == 1:
        return pa.array(rows, type=arrow_type)
    values = pa.array(rows.reshape(-1), type=arrow_type.value_type)
    return pa.FixedSizeListArray.from_arrays(values, type=arrow_type)


class MapOutput:
    """One file's rows plus its partition plan: reducer ``r``'s rows are
    ``flat[offsets[r]:offsets[r+1]]``, in original row order. The rows are
    numpy ``columns``, or, where the file has a binary column, the Arrow
    ``table`` itself (``columns`` is then None)."""

    __slots__ = ("columns", "table", "names", "schema", "flat", "offsets")

    def __init__(self, columns: Optional[Dict[str, np.ndarray]],
                 schema: pa.Schema, flat: np.ndarray, offsets: np.ndarray,
                 table: Optional[pa.Table] = None):
        self.columns = columns
        self.table = table
        self.names = list(schema.names)
        self.schema = schema
        self.flat = flat
        self.offsets = offsets

    def indices(self, reducer: int) -> np.ndarray:
        return self.flat[self.offsets[reducer]:self.offsets[reducer + 1]]

    def materialize(self, reducer: int) -> pa.Table:
        """Reducer ``reducer``'s rows of this file as a table of this
        file's schema, in original row order (what crosses the wire to a
        reducer on another host)."""
        idx = self.indices(reducer)
        if self.columns is None:
            return self.table.take(idx)
        return pa.Table.from_arrays(
            [_rows_to_arrow(self.columns[name][idx], field.type)
             for name, field in zip(self.names, self.schema)],
            schema=self.schema)


#: A reducer's rows of one file: the file's :class:`MapOutput` (local,
#: gathered in the reduce) or those rows already materialized, a table
#: received from the host that mapped the file.
Chunk = Union[MapOutput, pa.Table]


def _chunk_has_binary(chunk: Chunk) -> bool:
    if isinstance(chunk, MapOutput):
        return chunk.columns is None
    return any(_is_binary_column(col) for col in chunk.columns)


def shuffle_map(filename: str, num_reducers: int, seed: int, epoch: int,
                file_index: int,
                map_transform: Optional[MapTransform] = None) -> MapOutput:
    """Read one file and plan the scatter of its rows across reducers."""
    table = pq.read_table(filename)
    if map_transform is not None:
        table = map_transform(table)
    flat, offsets = partition.plan_partition_flat(
        table.num_rows, num_reducers, seed, epoch, file_index)
    columns = [table.column(name) for name in table.column_names]
    if any(_is_binary_column(col) for col in columns):
        for name, col in zip(table.column_names, columns):
            if not _is_binary_column(col):
                column_to_rows(col, name)  # raises on an unsupported type
        return MapOutput(None, table.schema, flat, offsets, table=table)
    return MapOutput(_numpy_columns(table), table.schema, flat, offsets)


def _take_reduce(reduce_index: int, perm: np.ndarray,
                 chunks: Sequence[Chunk]) -> pa.Table:
    """``concat[perm]`` with Arrow's ``take``; promotes to 64-bit offsets
    where the output passes 2 GiB of variable-width data."""
    table = pa.concat_tables([
        c.table.take(c.indices(reduce_index)) if isinstance(c, MapOutput)
        else c for c in chunks])
    try:
        return table.take(perm)
    except pa.ArrowInvalid:
        return _promote_large_offsets(table).take(perm)


def _chunk_rows(chunk: Chunk, reduce_index: int, name: str) -> np.ndarray:
    if isinstance(chunk, MapOutput):
        return chunk.columns[name][chunk.indices(reduce_index)]
    return column_to_rows(chunk.column(name), name)


def shuffle_reduce(reduce_index: int, seed: int, epoch: int,
                   chunks: Sequence[Chunk],
                   reduce_transform: Optional[ReduceTransform] = None
                   ) -> pa.Table:
    """Concatenate this reducer's rows from every file in file order, then
    permute them: ``out = concat[perm]`` (whole rows of a fixed-size list
    column move together); then ``reduce_transform``, if any. ``chunks``
    holds one entry per file, in global file order: the file's
    :class:`MapOutput`, or this reducer's rows of it received from another
    host; local rows are gathered only here."""
    schema = chunks[0].schema
    names = list(schema.names)
    for c in chunks[1:]:
        if list(c.schema.names) != names or not c.schema.equals(schema):
            raise ValueError("map outputs disagree on their schema")
    total = sum(len(c.indices(reduce_index)) if isinstance(c, MapOutput)
                else c.num_rows for c in chunks)
    perm = partition.permutation(
        total, partition.reduce_rng(seed, epoch, reduce_index))
    if _chunk_has_binary(chunks[0]):
        out = _take_reduce(reduce_index, perm, chunks)
    else:
        columns = {}
        for name in names:
            concat = np.concatenate([_chunk_rows(c, reduce_index, name)
                                     for c in chunks])
            columns[name] = _rows_to_arrow(concat[perm],
                                           schema.field(name).type)
        out = pa.table(columns)
    if reduce_transform is not None and out.num_columns:
        out = reduce_transform(out)
    return out


def _reduce_task(reduce_index: int, seed: int, epoch: int,
                 map_futures: Sequence[cf.Future],
                 reduce_transform: Optional[ReduceTransform]) -> pa.Table:
    return shuffle_reduce(reduce_index, seed, epoch,
                          [f.result() for f in map_futures],
                          reduce_transform)


def shuffle_epoch(epoch: int, filenames: Sequence[str],
                  batch_consumer: BatchConsumer, num_reducers: int,
                  num_trainers: int, pool: cf.Executor, seed: int,
                  map_transform: Optional[MapTransform] = None,
                  reduce_transform: Optional[ReduceTransform] = None
                  ) -> List[cf.Future]:
    """Launch one epoch's maps and reduces and route the reducer futures:
    rank ``k`` gets the ``k``-th contiguous span of reducers, in order,
    then ``None``. Returns the reducer futures."""
    map_futures = [
        pool.submit(shuffle_map, f, num_reducers, seed, epoch, i,
                    map_transform)
        for i, f in enumerate(filenames)]
    reduce_futures = [
        pool.submit(_reduce_task, r, seed, epoch, map_futures,
                    reduce_transform)
        for r in range(num_reducers)]
    spans = partition.contiguous_splits(range(num_reducers), num_trainers)
    for rank, reducers in enumerate(spans):
        batch_consumer(rank, epoch, [reduce_futures[r] for r in reducers])
        batch_consumer(rank, epoch, None)
    return reduce_futures


def shuffle(filenames: Sequence[str], batch_consumer: BatchConsumer,
            num_epochs: int, num_reducers: int, num_trainers: int,
            max_concurrent_epochs: int = 2, seed: int = 0,
            map_transform: Optional[MapTransform] = None,
            reduce_transform: Optional[ReduceTransform] = None,
            start_epoch: int = 0) -> float:
    """Shuffle epochs ``start_epoch .. num_epochs - 1`` (a resumed run
    skips the epochs before its checkpoint) with at most
    ``max_concurrent_epochs`` in flight, on one thread per host core;
    returns the wall-clock seconds. A failed map or reduce raises here."""
    if not 0 <= start_epoch <= num_epochs:
        raise ValueError(
            f"start_epoch {start_epoch} out of range [0, {num_epochs}]")
    start = timeit.default_timer()
    in_progress: Dict[int, List[cf.Future]] = {}
    with cf.ThreadPoolExecutor(max_workers=os.cpu_count(),
                               thread_name_prefix="rsdl-shuffle") as pool:
        for epoch in range(start_epoch, num_epochs):
            while len(in_progress) >= max(1, max_concurrent_epochs):
                for fut in in_progress.pop(min(in_progress)):
                    fut.result()
            in_progress[epoch] = shuffle_epoch(
                epoch, filenames, batch_consumer, num_reducers,
                num_trainers, pool, seed, map_transform, reduce_transform)
        for epoch in sorted(in_progress):
            for fut in in_progress.pop(epoch):
                fut.result()
    return timeit.default_timer() - start


def run_shuffle_in_background(
        filenames: Sequence[str], batch_consumer: BatchConsumer,
        num_epochs: int, num_reducers: int, num_trainers: int,
        max_concurrent_epochs: int = 2, seed: int = 0,
        map_transform: Optional[MapTransform] = None,
        on_failure: Optional[Callable[[BaseException], None]] = None,
        reduce_transform: Optional[ReduceTransform] = None,
        start_epoch: int = 0) -> cf.Future:
    """Run :func:`shuffle` on a driver thread of its own; the returned
    future resolves to its duration or raises its error. ``on_failure``
    runs before the error is stored, so blocked consumers can be woken."""
    driver = cf.ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="rsdl-driver")

    def _run() -> float:
        try:
            return shuffle(filenames, batch_consumer, num_epochs,
                           num_reducers, num_trainers, max_concurrent_epochs,
                           seed=seed, map_transform=map_transform,
                           reduce_transform=reduce_transform,
                           start_epoch=start_epoch)
        except BaseException as e:
            logger.error("shuffle failed: %r", e)
            if on_failure is not None:
                on_failure(e)
            raise

    future = driver.submit(_run)
    driver.shutdown(wait=False)
    return future
