"""Plan-driven cache warming on idle scheduler lanes (own copy of the
JAX package's ``storage/prefetch.py``).

Epoch N's plan names the files its maps read, and epoch N+1 reads the
same list, so a lane the scheduler has no real work for can warm the
tiered cache with them. Priority (``plan/scheduler.py``): ready nodes,
then stealing, then speculation, then prefetch; real work arriving on a
lane cancels its prefetch (a fetch already running finishes and still
warms the cache).

Accounting: ``issued`` counts prefetches that started, ``canceled`` those
reclaimed before they started, ``hits`` (counted by the store) prefetched
entries a map later consumed. A failed prefetch is logged and dropped:
the map's own read owns retries, quarantine and fault sites.

The JAX package's per-tenant prefetch byte quota waits for the port's
``tenancy`` (ROADMAP queue A item 8): a ``tenant`` argument raises.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ray_shuffling_data_loader_tpu_torch.storage import cache as st_cache
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)


class PrefetchTask:
    """One cancelable warm of one file."""

    __slots__ = ("manager", "path", "_cancel", "_started")

    def __init__(self, manager: "PrefetchManager", path: str):
        self.manager = manager
        self.path = path
        self._cancel = threading.Event()
        self._started = threading.Event()

    def cancel(self) -> None:
        """Real work needs the lane: a task that has not started counts
        as canceled; one already fetching finishes."""
        self._cancel.set()
        if not self._started.is_set():
            self.manager._bump("canceled")

    def run(self) -> bool:
        """True when the entry became (or already was) resident."""
        if self._cancel.is_set():
            return False
        self._started.set()
        self.manager._bump("issued")
        try:
            return self.manager.store.warm(self.path)
        except Exception as e:  # noqa: BLE001 - an optimization only
            logger.debug("prefetch of %s failed (%s); the map's read will "
                         "fetch it", self.path, e)
            return False


class PrefetchManager:
    """Hands the scheduler one :class:`PrefetchTask` at a time, in plan
    order, skipping files already resident in the store."""

    def __init__(self, store, files, tenant=None):
        if tenant is not None:
            raise st_cache._no_tenancy("PrefetchManager(tenant=...)")
        self.store = store
        self._pending = deque(files)
        self._lock = threading.Lock()
        self.issued = 0
        self.canceled = 0

    def _bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        st_cache.count(f"prefetch_{name}")

    def next(self) -> Optional[PrefetchTask]:
        """The next file not yet resident, as a task; None when none is
        left. Each pass pops one pending file."""
        # rsdl-lint: disable=unbounded-retry
        while True:
            with self._lock:
                if not self._pending:
                    return None
                path = self._pending.popleft()
            try:
                if self.store.resident(path):
                    continue
            except Exception:  # noqa: BLE001 - a residency probe only
                continue
            return PrefetchTask(self, path)

    def stats(self) -> dict:
        """``{issued, canceled, hits, efficiency}``; hits are the store's
        (counted where the consuming get runs)."""
        with self._lock:
            issued, canceled = self.issued, self.canceled
        hits = getattr(self.store, "prefetch_hits", 0)
        return {"issued": issued, "canceled": canceled, "hits": hits,
                "efficiency": hits / issued if issued else 0.0}
