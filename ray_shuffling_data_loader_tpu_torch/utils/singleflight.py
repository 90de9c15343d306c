"""One load per key at a time, for the caches of the shuffle's map.

The first caller to :meth:`SingleFlight.claim` a key becomes its loader
until it calls :meth:`SingleFlight.release`; a claim of the key meanwhile
gets the :class:`Flight` in progress instead, waits on it, and then looks
its cache up again. ``shuffle.FileTableCache``, ``storage.TieredStore``
and the process pool's segment cache each keep one.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, Optional

_ANY = object()


class Flight:
    """A load of one key in progress; ``owner`` is what the loader named
    itself (the pool: the epoch whose map loads the file)."""

    __slots__ = ("owner", "_done")

    def __init__(self, owner: Any):
        self.owner = owner
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once the load has ended."""
        return self._done.wait(timeout)


class SingleFlight:
    """The loads in flight, by key. Thread-safe; :meth:`claim` may be
    called under the caller's own lock (it takes only its own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: Dict[Hashable, Flight] = {}

    def claim(self, key: Hashable, owner: Any = None) -> Optional[Flight]:
        """None: the caller now loads ``key`` and must :meth:`release`
        it. Else the load in flight, to wait on."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                self._flights[key] = Flight(owner)
            return flight

    def flight(self, key: Hashable) -> Optional[Flight]:
        """The load of ``key`` in flight, or None."""
        with self._lock:
            return self._flights.get(key)

    def release(self, key: Hashable, owner: Any = _ANY) -> None:
        """End the load of ``key`` (only ``owner``'s, where given) and wake
        the callers waiting on it."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None or owner is not _ANY and flight.owner != owner:
                return
            del self._flights[key]
        flight._done.set()

    def release_all(self) -> None:
        """End every load (on shutdown): every waiter wakes."""
        with self._lock:
            flights, self._flights = list(self._flights.values()), {}
        for flight in flights:
            flight._done.set()
