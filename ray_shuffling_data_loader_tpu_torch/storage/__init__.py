"""The storage plane (own copy of the JAX package's ``storage/``): every
dataset read of the shuffle goes through this package.

- :mod:`storage.source`: where bytes live (:class:`LocalSource`,
  :class:`HTTPRangeSource`, :class:`SimulatedObjectStore`).
- :mod:`storage.cache`: hot (RAM) over disk (CRC'd Arrow IPC) over the
  source (:class:`TieredStore`, :class:`DiskTier`), every tier on the one
  buffer ledger.
- :mod:`storage.prefetch`: warming on idle scheduler lanes
  (:class:`PrefetchManager`).

This module holds the process-wide source: :func:`get_source` resolves
it on first use from the ``storage_backend`` policy key
(``RSDL_STORAGE_BACKEND``: ``"local"`` or ``"sim"``), :func:`set_source`
installs one. An installed source lives in this process only: the
process pool's workers resolve their own from the environment they
inherit, so ``executor_backend="auto"`` keeps a shuffle on threads while
one is installed (:func:`source_installed`).

:func:`read_table` and :func:`open_parquet` are the reads of the map
(``shuffle``'s read-then-plan map and its streaming map). They fire the
``storage_read`` and ``storage_stall`` fault sites before the fetch and
outside its retry, so an injected fault reaches lineage recovery instead
of being absorbed as an IO blip.

Imports no torch: the pool's workers read through it.
"""

from __future__ import annotations

import threading
from typing import Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.storage.cache import (
    DiskTableCache, DiskTier, TieredStore, storage_totals)
from ray_shuffling_data_loader_tpu_torch.storage.prefetch import (
    PrefetchManager, PrefetchTask)
from ray_shuffling_data_loader_tpu_torch.storage.source import (
    HTTPRangeSource, LocalSource, SimulatedObjectStore, StorageSource)

__all__ = [
    "StorageSource", "LocalSource", "HTTPRangeSource",
    "SimulatedObjectStore", "DiskTier", "DiskTableCache", "TieredStore",
    "PrefetchManager", "PrefetchTask", "get_source", "set_source",
    "read_table", "open_parquet", "source_installed", "storage_totals",
]

_lock = threading.Lock()
_source: Optional[StorageSource] = None


def _resolve_default() -> StorageSource:
    backend = str(rt_policy.resolve("storage", "storage_backend")).lower()
    if backend == "sim":
        source: StorageSource = SimulatedObjectStore()
    elif backend == "local":
        source = LocalSource()
    else:
        raise ValueError(
            f"RSDL_STORAGE_BACKEND must be 'local' or 'sim' (install any "
            f"other source with storage.set_source), got {backend!r}")
    # A pool worker resolves the same from the same environment.
    source._from_policy = True
    return source


def get_source() -> StorageSource:
    """The process-wide source, resolved from policy on first use."""
    global _source
    with _lock:
        if _source is None:
            _source = _resolve_default()
        return _source


def set_source(source: Optional[StorageSource]) -> Optional[StorageSource]:
    """Install ``source`` process-wide (None: resolve from policy again
    on the next use); returns the previous one."""
    global _source
    with _lock:
        previous, _source = _source, source
    return previous


def source_installed() -> bool:
    """Whether the process-wide source came from :func:`set_source`
    rather than from policy (a pool worker cannot see it). Putting back
    a source the policy resolved is no installation."""
    with _lock:
        return (_source is not None
                and not getattr(_source, "_from_policy", False))


def _inject(epoch: Optional[int], task: Optional[int]) -> None:
    # storage_read is the lost GET, storage_stall the slow first byte (a
    # delay rule sleeps instead of raising).
    rt_faults.inject("storage_read", epoch=epoch, task=task)
    rt_faults.inject("storage_stall", epoch=epoch, task=task)


def read_table(path: str, epoch: Optional[int] = None,
               task: Optional[int] = None,
               retry: Optional[rt_retry.RetryPolicy] = None,
               source: Optional[StorageSource] = None) -> pa.Table:
    """Fetch and decode one dataset file through the source (``retry``
    retries the fetch, not the fault sites)."""
    src = source if source is not None else get_source()
    _inject(epoch, task)
    if retry is None:
        return src.read_table(path)
    return retry.call(src.read_table, path, describe=f"storage read {path}")


def open_parquet(path: str, epoch: Optional[int] = None,
                 task: Optional[int] = None,
                 source: Optional[StorageSource] = None) -> pq.ParquetFile:
    """A streaming reader over one dataset file through the source (the
    streaming map's entry), with the same fault sites."""
    src = source if source is not None else get_source()
    _inject(epoch, task)
    return src.open_parquet(path)
