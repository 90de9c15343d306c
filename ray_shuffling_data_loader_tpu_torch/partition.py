"""Seeded row partitioning and permutation primitives.

Own copy of the JAX package's ``ops/partition.py`` (NumPy arm) and the
vectorised splitmix64 ``hash_assign`` of its ``native/__init__.py``. The
shuffle must reproduce the JAX package's stream bit for bit, so the
constants, stream tags and arithmetic here are copied, not reinvented:

- map: each row's reducer is ``mix64(key + (row+1) * golden) % R`` with
  ``key = partition_key(seed, epoch, file_index)``, followed by a stable
  counting sort (:func:`plan_partition_flat`);
- reduce: ``Philox(SeedSequence(seed, spawn_key=(1, epoch, r)))`` draws the
  permutation of the reducer's concatenated rows (:func:`reduce_rng`).

The shuffle runs the map's plan through the native kernels
(``native.plan_partition_flat``, ``native.partition_counts``,
``native.assign_dest``); the NumPy functions here are their plain
versions, equal bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# Stream-domain tags (must equal the JAX package's).
_REDUCE_STREAM = 1
_PLAN_STREAM = 2

_MASK64 = (1 << 64) - 1

_GOLDEN = np.uint64(0x9e3779b97f4a7c15)
_MIX_C1 = np.uint64(0xbf58476d1ce4e5b9)
_MIX_C2 = np.uint64(0x94d049bb133111eb)


def _mix64(x: int) -> int:
    """splitmix64 finalizer over one Python int."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xbf58476d1ce4e5b9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94d049bb133111eb) & _MASK64
    return x ^ (x >> 31)


def partition_key(seed: int, epoch: int, file_index: int) -> int:
    """64-bit key of one map task's partition stream: chained splitmix64
    over ``(seed, epoch, file_index)``."""
    key = _mix64((seed & _MASK64) ^ (_PLAN_STREAM << 56))
    key = _mix64(key ^ ((epoch & _MASK64) * 0x9e3779b97f4a7c15))
    return _mix64(key ^ ((file_index & _MASK64) * 0xc2b2ae3d27d4eb4f))


def hash_assign(num_rows: int, num_reducers: int, key: int,
                row0: int = 0) -> np.ndarray:
    """Per-row reducer ids: ``mix64(key + (i+1) * golden) % num_reducers``
    for global rows ``i`` in ``[row0, row0 + num_rows)``, as uint32."""
    if num_reducers < 1:
        raise ValueError(f"num_reducers must be >= 1, got {num_reducers}")
    i = np.arange(row0 + 1, row0 + num_rows + 1, dtype=np.uint64)
    x = np.uint64(key & _MASK64) + i * _GOLDEN
    x ^= x >> np.uint64(30)
    x *= _MIX_C1
    x ^= x >> np.uint64(27)
    x *= _MIX_C2
    x ^= x >> np.uint64(31)
    return (x % np.uint64(num_reducers)).astype(np.uint32)


def plan_partition_flat(num_rows: int, num_reducers: int, seed: int,
                        epoch: int, file_index: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The map task's plan as ``(flat_indices, offsets)``: reducer ``r``'s
    rows are ``flat[offsets[r]:offsets[r+1]]``, in original row order."""
    key = partition_key(seed, epoch, file_index)
    assignments = hash_assign(num_rows, num_reducers, key)
    counts = np.bincount(assignments, minlength=num_reducers)
    order = np.argsort(assignments, kind="stable").astype(np.int64,
                                                          copy=False)
    offsets = np.zeros(num_reducers + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return order, offsets


def partition_counts(num_rows: int, num_reducers: int, seed: int,
                     epoch: int, file_index: int, row0: int = 0
                     ) -> np.ndarray:
    """Per-reducer counts of rows ``[row0, row0 + num_rows)`` of the
    file's partition stream (plain version of
    ``native.partition_counts``)."""
    assignments = hash_assign(num_rows, num_reducers,
                              partition_key(seed, epoch, file_index), row0)
    return np.bincount(assignments,
                       minlength=num_reducers).astype(np.int64, copy=False)


def assign_dest_batch(num_rows: int, num_reducers: int, seed: int,
                      epoch: int, file_index: int, row0: int,
                      cursors: np.ndarray) -> np.ndarray:
    """Destination slots of one record batch of the streaming map: row
    ``row0 + i`` goes to slot ``cursors[r]`` of its reducer ``r``'s region
    and ``cursors`` (int64, one per reducer) advance in place (plain
    version of ``native.assign_dest``, as int64)."""
    assignments = hash_assign(num_rows, num_reducers,
                              partition_key(seed, epoch, file_index), row0)
    counts = np.bincount(assignments, minlength=num_reducers)
    order = np.argsort(assignments, kind="stable")
    starts = np.zeros(num_reducers, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    dest = np.empty(num_rows, dtype=np.int64)
    # In stable-sorted order reducer r's rows are one run; its k-th row
    # (original order) lands at cursors[r] + k.
    dest[order] = (np.repeat(cursors[:num_reducers], counts)
                   + np.arange(num_rows) - np.repeat(starts, counts))
    cursors += counts
    return dest


def reduce_rng(seed: int, epoch: int,
               reducer_index: int) -> np.random.Generator:
    """PRNG for the reduce task of ``reducer_index`` in ``epoch``."""
    seq = np.random.SeedSequence(
        entropy=seed, spawn_key=(_REDUCE_STREAM, epoch, reducer_index))
    return np.random.Generator(np.random.Philox(seq))


def permutation(num_rows: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform permutation of ``arange(num_rows)``."""
    return rng.permutation(num_rows)


def split_sizes(total: int, num_parts: int) -> List[int]:
    """Sizes of ``np.array_split(range(total), num_parts)``: contiguous,
    remainder first."""
    base, rem = divmod(total, num_parts)
    return [base + 1 if i < rem else base for i in range(num_parts)]


def contiguous_splits(items: Sequence, num_parts: int) -> List[list]:
    """Contiguous split of ``items`` into ``num_parts`` groups."""
    out: List[list] = []
    start = 0
    for size in split_sizes(len(items), num_parts):
        out.append(list(items[start:start + size]))
        start += size
    return out
