"""The cache hierarchy: hot RAM over disk over the source (own copy of
the JAX package's ``storage/cache.py``).

``hot``     decoded tables in RAM, an LRU within a byte budget (charged to
            the buffer ledger by ``native.account_table`` at decode)
``disk``    decoded tables as uncompressed Arrow IPC files on local
            scratch (:class:`DiskTier`), each CRC'd at write and checked
            at every read, memory-mapped back on a hit and promoted
``remote``  the :class:`storage.source.StorageSource`: a miss here is a
            real fetch

A CRC mismatch or an IO or decode failure drops the disk entry and falls
through to the next tier: sources are deterministic, so the refetched
table equals the lost one. :class:`TieredStore` speaks the
``FileTableCache`` protocol (``get``/``put``/``bytes_cached``/``close``),
so it plugs into ``shuffle(file_cache=...)``, and offers ``warm`` and
``make_prefetcher`` for the plan scheduler's idle-lane prefetch.

The JAX package's per-tenant hot-tier quotas wait for the port's
``tenancy`` (ROADMAP queue A item 8): a ``tenant_quotas`` argument
raises. Its metric series are this module's counters instead
(:func:`storage_totals` and the ``hits``/``misses``/... attributes).
"""

from __future__ import annotations

import collections
import hashlib
import os
import tempfile
import threading
from typing import Dict, Optional, Tuple

import pyarrow as pa

from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch.utils.singleflight import SingleFlight
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

_CRC_CHUNK = 1 << 20

_totals_lock = threading.Lock()
_totals = {name: 0 for name in (
    "hot_hits", "hot_misses", "hot_evictions", "disk_hits", "disk_misses",
    "disk_evictions", "disk_corrupt", "disk_bytes_written",
    "remote_misses", "prefetch_issued",
    "prefetch_canceled", "prefetch_hits")}


def storage_totals() -> Dict[str, int]:
    """Process-wide tier counters since import (monotonic: snapshot
    before and after a run)."""
    with _totals_lock:
        return dict(_totals)


def count(name: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[name] += n


def _file_crc(path: str) -> int:
    """Streaming CRC32 of a file, 1 MiB at a time."""
    crc = 0
    with open(path, "rb", buffering=0) as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = native.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _no_tenancy(what: str):
    return NotImplementedError(
        f"{what} needs the port's tenancy, which is ROADMAP queue A item 8 "
        "(per-tenant cache and prefetch quotas)")


class DiskTier:
    """Decoded tables on local disk: uncompressed Arrow IPC files,
    memory-mapped back on a hit, every entry CRC'd.

    The first decode of a file writes it; later epochs map it (no
    decompression, no parse, pages faulted in lazily and reclaimable, so
    RSS stays bounded at any corpus size). ``get`` re-checks the CRC
    before trusting the mapping; a mismatch drops the entry and returns
    None, so the caller falls through to the next tier.

    ``max_bytes`` budgets the files. With ``evict=True`` (the tiered
    default) an insertion past it evicts the least recently hit entries;
    with ``evict=False`` (:class:`DiskTableCache`) later files re-decode.
    With ``charge_ledger=True`` every byte on disk is registered with the
    buffer ledger and reported by ``bytes_cached``.
    """

    tier = "disk"

    def __init__(self, max_bytes: int, cache_dir: Optional[str] = None,
                 evict: bool = True, charge_ledger: bool = True):
        self.max_bytes = max_bytes
        if cache_dir is None:
            cache_dir = tempfile.mkdtemp(prefix="rsdl_decoded_cache_")
            self._owns_dir = True
        else:
            os.makedirs(cache_dir, exist_ok=True)
            self._owns_dir = False
        self.cache_dir = cache_dir
        self._evict = evict
        self._charge_ledger = charge_ledger
        self._bytes = 0
        # key -> (path, bytes, crc, ledger id or None), least recently
        # used first.
        self._paths: "collections.OrderedDict[str, Tuple[str, int, int, Optional[int]]]" = \
            collections.OrderedDict()
        self._inflight: set = set()  # keys being written
        self._lock = threading.Lock()
        self._closed = False
        self.hits = self.misses = self.evictions = self.corrupt = 0

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        count(f"disk_{name}")

    def _path_for(self, key: str) -> str:
        digest = hashlib.sha1(key.encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"{digest}.arrow")

    def _uncharge(self, buf_id: Optional[int]) -> None:
        if buf_id is not None:
            native.buffer_ledger().decref(buf_id)

    def _forget(self, key: str, path: str, nbytes: int) -> None:
        """Drop a bad entry: its bytes and its file."""
        buf_id = None
        with self._lock:
            entry = self._paths.get(key)
            if entry is not None and entry[0] == path:
                buf_id = entry[3]
                del self._paths[key]
                self._bytes -= nbytes
        self._uncharge(buf_id)
        try:
            os.remove(path)
        except OSError:
            pass

    def _evict_lru(self, incoming: int) -> None:
        """Drop the least recently used entries until ``incoming`` fits."""
        dropped = []
        with self._lock:
            while self._bytes + incoming > self.max_bytes and self._paths:
                _key, (path, nbytes, _crc, buf_id) = \
                    self._paths.popitem(last=False)
                self._bytes -= nbytes
                dropped.append((path, buf_id))
        for path, buf_id in dropped:
            self._count("evictions")
            self._uncharge(buf_id)
            try:
                os.remove(path)
            except OSError:
                pass

    def get(self, key: str) -> Optional[pa.Table]:
        with self._lock:
            entry = self._paths.get(key)
            if entry is not None:
                self._paths.move_to_end(key)
        if entry is None:
            self._count("misses")
            return None
        path, nbytes, crc, _buf_id = entry
        try:
            actual = _file_crc(path)
            if actual != crc:
                self._count("corrupt")
                logger.warning(
                    "decoded-cache CRC mismatch for %s (%08x != %08x); "
                    "dropping the entry, falling through to a refetch",
                    key, actual, crc)
                self._forget(key, path, nbytes)
                self._count("misses")
                return None
            with pa.memory_map(path) as source:
                table = pa.ipc.open_file(source).read_all()
            self._count("hits")
            return table
        except (OSError, pa.ArrowInvalid) as e:
            logger.warning("decoded-cache read failed for %s (%s); "
                           "re-decoding", key, e)
            self._forget(key, path, nbytes)
            self._count("misses")
            return None

    def put(self, key: str, table: pa.Table) -> bool:
        """Write if the budget allows; True if the file is cached."""
        nbytes = table.nbytes
        if self._evict:
            self._evict_lru(nbytes)
        with self._lock:
            if self._closed:
                return False
            if key in self._paths:
                return True
            if key in self._inflight:
                # Another epoch's map is writing this key: it serves the
                # next epoch, this caller keeps its own table.
                return False
            if self._bytes + nbytes > self.max_bytes:
                return False
            # Reserve under the lock so concurrent writers cannot
            # overshoot the budget together.
            self._bytes += nbytes
            self._inflight.add(key)
        path = self._path_for(key)
        tmp_path = f"{path}.{id(table):x}.tmp"
        try:
            with pa.OSFile(tmp_path, "wb") as sink:
                with pa.ipc.new_file(sink, table.schema) as writer:
                    writer.write_table(table)
            os.replace(tmp_path, path)
            crc = _file_crc(path)
        except OSError as e:
            logger.warning("decoded-cache write failed for %s (%s); "
                           "cold reads continue from parquet", key, e)
            with self._lock:
                self._bytes -= nbytes
                self._inflight.discard(key)
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            return False
        # Charge the file's real size (IPC framing and padding make it
        # larger than the column bytes).
        try:
            disk_bytes = os.stat(path).st_size
        except OSError:
            disk_bytes = nbytes
        buf_id = (native.buffer_ledger().register(disk_bytes)
                  if self._charge_ledger and disk_bytes > 0 else None)
        with self._lock:
            self._inflight.discard(key)
            self._bytes += disk_bytes - nbytes
            if self._closed:  # closed while writing: drop the orphan
                self._bytes -= disk_bytes
                try:
                    os.remove(path)
                except OSError:
                    pass
                self._uncharge(buf_id)
                return False
            self._paths[key] = (path, disk_bytes, crc, buf_id)
        count("disk_bytes_written", disk_bytes)
        return True

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._paths

    @property
    def bytes_cached(self) -> int:
        """Ledger-charged bytes (0 where the tier charges none)."""
        if not self._charge_ledger:
            return 0
        with self._lock:
            return self._bytes

    @property
    def disk_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def close(self) -> None:
        """Delete the files (live mappings stay valid) and the directory
        where this tier made it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._paths.values())
            self._paths.clear()
            self._bytes = 0
        for path, _nbytes, _crc, buf_id in entries:
            self._uncharge(buf_id)
            try:
                os.remove(path)
            except OSError:
                pass
        if self._owns_dir:
            try:
                os.rmdir(self.cache_dir)
            except OSError:
                pass


class DiskTableCache(DiskTier):
    """The disk cache without eviction or a ledger charge (once full,
    later files re-decode each epoch; ``bytes_cached`` is 0, as page
    cache is reclaimable). Compose :class:`DiskTier` inside a
    :class:`TieredStore` for the managed hierarchy."""

    def __init__(self, max_bytes: int, cache_dir: Optional[str] = None):
        super().__init__(max_bytes, cache_dir=cache_dir, evict=False,
                         charge_ledger=False)


class TieredStore:
    """Hot (RAM LRU) over disk (:class:`DiskTier`) over the installed
    :class:`StorageSource`, behind the ``FileTableCache`` protocol.

    ``get`` promotes a disk hit into the hot tier; a hot insertion past
    the budget demotes by LRU (the entry still serves from disk, since
    ``put`` writes through). A miss on both tiers returns None and the
    map's read path fetches from the source; a CRC-corrupt disk entry
    degrades to that; the missing caller is the key's loader until its
    :meth:`release`, and other gets of the key wait for it. ``warm(path)``
    fetches, decodes, applies the map transform and inserts, so a later
    ``get`` hits; a ``get`` that misses while a warm of its key is in
    flight waits for that warm instead of fetching again, and a warm of a
    key being loaded waits for the load. ``make_prefetcher(plan)`` gives the plan scheduler a
    :class:`storage.prefetch.PrefetchManager` over the plan's files.
    """

    def __init__(self, hot_bytes: int,
                 disk: Optional[DiskTier] = None,
                 source: Optional[object] = None,
                 tenant_quotas: Optional[Dict[str, int]] = None):
        if tenant_quotas is not None:
            raise _no_tenancy("TieredStore(tenant_quotas=...)")
        self.hot_bytes = hot_bytes
        self.disk = disk
        self._source = source
        self._transform = None
        self._hot: "collections.OrderedDict[str, pa.Table]" = \
            collections.OrderedDict()
        self._hot_bytes_used = 0
        self._lock = threading.Lock()
        self._prefetched: set = set()
        # The loads and warms in flight.
        self._loads = SingleFlight()
        self.hot_hits = self.hot_misses = self.hot_evictions = 0
        self.remote_misses = self.prefetch_hits = 0

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)
        count(name, n)

    # -- FileTableCache protocol ---------------------------------------

    def get(self, key: str) -> Optional[pa.Table]:
        """The table from the hot tier or the disk tier (promoted), or
        None: the caller then loads ``key`` from the source, and other
        gets of it wait for that load until the caller's
        :meth:`release` (as ``shuffle.FileTableCache``'s; the JAX store
        joins prefetch warms only, so two epochs in flight read a file
        twice)."""
        # Each pass returns or waits for one load or warm of this key in
        # flight; after it, the key is resident or no load is left.
        # rsdl-lint: disable=unbounded-retry
        while True:
            with self._lock:
                table = self._hot.get(key)
                was_prefetched = False
                if table is not None:
                    self._hot.move_to_end(key)
                    was_prefetched = key in self._prefetched
                    self._prefetched.discard(key)
            if table is not None:
                self._count("hot_hits")
                if was_prefetched:
                    self._count("prefetch_hits")
                return table
            self._count("hot_misses")
            if self.disk is not None:
                table = self.disk.get(key)  # None if absent or corrupt
                if table is not None:
                    with self._lock:
                        was_prefetched = key in self._prefetched
                        self._prefetched.discard(key)
                    if was_prefetched:
                        self._count("prefetch_hits")
                    self._promote(key, table)
                    return table
            flight = self._loads.claim(key)
            if flight is None:  # this caller loads the key
                self._count("remote_misses")
                return None
            flight.wait()

    def release(self, key: str) -> None:
        """End the caller's load of ``key`` (after its :meth:`put`, or on
        failure): the gets waiting for it look again."""
        self._loads.release(key)

    def put(self, key: str, table: pa.Table) -> bool:
        """Insert into the hot tier (evicting by LRU to fit) and write
        through to disk; True if either tier holds it afterwards."""
        in_hot = self._promote(key, table)
        on_disk = (self.disk.put(key, table) if self.disk is not None
                   else False)
        return in_hot or on_disk

    @property
    def bytes_cached(self) -> int:
        """Every ledger-charged byte the store holds: the hot tables and
        the disk tier's charged bytes."""
        with self._lock:
            hot = self._hot_bytes_used
        return hot + (self.disk.bytes_cached if self.disk is not None
                      else 0)

    def close(self) -> None:
        with self._lock:
            self._hot.clear()
            self._hot_bytes_used = 0
            self._prefetched.clear()
        if self.disk is not None:
            self.disk.close()

    # -- internals -----------------------------------------------------

    def _promote(self, key: str, table: pa.Table) -> bool:
        nbytes = table.nbytes
        evicted = 0
        with self._lock:
            if key in self._hot:
                self._hot.move_to_end(key)
                return True
            while (self._hot_bytes_used + nbytes > self.hot_bytes
                   and self._hot):
                _old_key, old = self._hot.popitem(last=False)
                self._hot_bytes_used -= old.nbytes
                evicted += 1
            ok = self._hot_bytes_used + nbytes <= self.hot_bytes
            if ok:
                self._hot[key] = table
                self._hot_bytes_used += nbytes
        if evicted:
            # A demotion, not a loss: put wrote the entry through to disk.
            self._count("hot_evictions", evicted)
        return ok

    # -- prefetch seam -------------------------------------------------

    def set_transform(self, transform) -> None:
        """The map stage caches transformed tables, so ``warm`` applies
        the same transform (``shuffle`` sets it before the first epoch)."""
        self._transform = transform

    def resident(self, key: str) -> bool:
        with self._lock:
            if key in self._hot:
                return True
        return self.disk is not None and key in self.disk

    def warm(self, key: str) -> bool:
        """Fetch, decode, transform and insert ``key``, so a later map's
        ``get`` hits (or joins this warm while it runs). True when the
        entry is resident afterwards."""
        if self.resident(key):
            return True
        flight = self._loads.claim(key)
        if flight is not None:
            flight.wait()
            return self.resident(key)
        try:
            source = self._source
            if source is None:
                from ray_shuffling_data_loader_tpu_torch import storage
                source = storage.get_source()
            table = source.read_table(key)
            if self._transform is not None:
                table = self._transform(table)
            # Single-chunk, as the map makes a cached table.
            table = table.combine_chunks()
            native.account_table(table)
            ok = self.put(key, table)
            if ok:
                with self._lock:
                    self._prefetched.add(key)
            return ok
        finally:
            self._loads.release(key)

    def make_prefetcher(self, plan):
        """A PrefetchManager over ``plan``'s map files: epoch N's plan
        names the files epoch N+1 reads again."""
        from ray_shuffling_data_loader_tpu_torch.storage.prefetch import (
            PrefetchManager)
        if getattr(plan, "tenant_id", None) is not None:
            raise _no_tenancy("a plan with a tenant_id")
        files = [node.meta["file"] for node in plan.maps()
                 if node.meta.get("file")]
        return PrefetchManager(self, files)
