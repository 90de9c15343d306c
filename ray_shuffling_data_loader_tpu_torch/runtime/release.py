"""Event-driven release channel over the native buffer ledger (own copy
of the JAX package's ``runtime/release.py``).

The ledger's entries are released by ``weakref.finalize`` when a table's
Python handle is collected. The ledger wrappers (``native/__init__.py``)
call :func:`notify_release` on every last-reference decref and free-list
trim, and the shuffle's memory-budget wait blocks in :func:`wait_while`:
woken at once by a release, it re-checks its predicate, with a coarse
heartbeat only as a safety net against releases that bypass the ledger.

Stdlib only; importable from the native layer without cycles.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

# RLock on purpose: notify_release runs from weakref.finalize callbacks,
# which the cycle collector may run at ANY allocation, even one made
# inside notify_release by the thread already holding this lock.
_cond = threading.Condition(threading.RLock())
#: Monotonic count of release events since import. A waiter snapshots it
#: and blocks until it advances, so no release is missed, even one that
#: fires between the predicate check and the wait.
_seq = 0


def notify_release(count: int = 1) -> None:
    """Record that ledger bytes were released and wake every waiter."""
    global _seq
    with _cond:
        _seq += count
        _cond.notify_all()


def release_seq() -> int:
    """The release counter now (a waiter's snapshot)."""
    with _cond:
        return _seq


def wait_for_release(last_seen: int, timeout: float) -> int:
    """Block until the counter advances past ``last_seen`` or ``timeout``
    elapses; returns the counter's value."""
    deadline = time.monotonic() + timeout
    with _cond:
        while _seq == last_seen:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            _cond.wait(timeout=remaining)
        return _seq


def wait_while(predicate: Callable[[], bool], timeout_s: float,
               heartbeat_s: float = 0.25) -> bool:
    """Block while ``predicate()`` is True, re-evaluating it on every
    release (and at least every ``heartbeat_s``). True if it turned False
    within ``timeout_s``, False on timeout."""
    deadline = time.monotonic() + timeout_s
    seen = release_seq()
    while predicate():
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return not predicate()
        seen = wait_for_release(seen, timeout=min(heartbeat_s, remaining))
    return True
