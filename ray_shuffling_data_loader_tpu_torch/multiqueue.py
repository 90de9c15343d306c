"""In-process blocking queues, one per ``(epoch, rank)`` (own copy of the
JAX package's ``multiqueue.py``, without the async ops).

Queue ``epoch * num_trainers + rank`` carries rank ``rank``'s reducer
outputs for ``epoch`` followed by a ``None`` end-of-epoch sentinel (the
JAX package's ``plan.ir.queue_index`` contract). Each queue is a
:class:`BoundedFifo` (``maxsize=0``: unbounded) with blocking, timed and
non-blocking gets and puts (:class:`Empty`/:class:`Full`), all-or-nothing
batch ops, and :meth:`MultiQueue.shutdown`, which refuses further puts
and wakes every blocked caller with :class:`ShutdownError`. A queue
made with a ``name`` is registered in this process until its shutdown,
and :func:`connect_queue` finds it by that name (how the ranks of one
process read the queue that rank 0 filled). The queue
server (``multiqueue_service.QueueServer``) drains a queue through these
non-blocking and timed gets.

Every put and get is a ``queue_put``/``queue_get`` event keyed ``task=queue
index`` and refreshes the queue's ``rsdl_queue_depth`` gauge, as in the
JAX package's queue; with telemetry off (``telemetry.stamp()`` returns
0.0) neither is paid. Both are fault sites of the same names, fired before
the item moves.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)

#: The connect schedule of a remote queue client (``RemoteQueue``): retries
#: after the first attempt and the first backoff, doubling (the JAX
#: package's values).
CONNECT_RETRIES = 5
CONNECT_INITIAL_BACKOFF_S = 1.0

#: This process's named queues (``MultiQueue(name=...)``).
_REGISTRY: Dict[str, "MultiQueue"] = {}
_REGISTRY_LOCK = threading.Lock()


def queue_index(epoch: int, rank: int, num_trainers: int) -> int:
    """The queue carrying ``rank``'s tables for ``epoch`` (the plan's
    rule, ``plan.ir.queue_index``)."""
    return plan_ir.queue_index(epoch, rank, num_trainers)


class Empty(Exception):
    """Raised by a non-blocking (or timed-out) get on an empty queue."""


class Full(Exception):
    """Raised by a non-blocking (or timed-out) put on a full queue."""


class ShutdownError(RuntimeError):
    """Raised by ``put`` after :meth:`MultiQueue.shutdown`, and to callers
    blocked in ``get``/``put`` when the queue shuts down."""


class BoundedFifo:
    """A FIFO of at most ``maxsize`` items (0: unbounded) on a deque and
    two conditions over one lock, with all-or-nothing batch ops."""

    __slots__ = ("_maxsize", "_items", "_mutex", "_not_empty", "_not_full",
                 "_closed")

    def __init__(self, maxsize: int = 0):
        self._maxsize = maxsize
        self._items: collections.deque = collections.deque()
        self._mutex = threading.Lock()
        self._not_empty = threading.Condition(self._mutex)
        self._not_full = threading.Condition(self._mutex)
        self._closed = False

    def close(self) -> None:
        """Wake every blocked ``put``/``get`` with :class:`ShutdownError`;
        items already queued stay readable by gets that need not wait."""
        with self._mutex:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def qsize(self) -> int:
        with self._mutex:
            return len(self._items)

    def _has_room(self, n: int = 1) -> bool:
        return not self._maxsize or len(self._items) + n <= self._maxsize

    @staticmethod
    def _remaining(deadline: Optional[float]) -> Optional[float]:
        return None if deadline is None else deadline - time.monotonic()

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        with self._not_full:
            if not self._has_room():
                if not block:
                    raise Full("queue is full")
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while not self._has_room():
                    if self._closed:
                        raise ShutdownError(
                            "queue shut down while put blocked")
                    remaining = self._remaining(deadline)
                    if remaining is not None and remaining <= 0:
                        raise Full("queue is full")
                    self._not_full.wait(remaining)
            self._items.append(item)
            self._not_empty.notify()

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        with self._not_empty:
            if not self._items:
                if not block:
                    raise Empty("queue is empty")
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while not self._items:
                    if self._closed:
                        raise ShutdownError(
                            "queue shut down while get blocked")
                    remaining = self._remaining(deadline)
                    if remaining is not None and remaining <= 0:
                        raise Empty("queue is empty")
                    self._not_empty.wait(remaining)
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def put_batch_atomic(self, items: List[Any]) -> None:
        """Enqueue all of ``items`` or none (non-blocking)."""
        with self._mutex:
            if not self._has_room(len(items)):
                raise Full(f"cannot accept {len(items)} items "
                           f"(capacity {self._maxsize}, size "
                           f"{len(self._items)})")
            self._items.extend(items)
            self._not_empty.notify_all()

    def get_batch_atomic(self, num_items: int) -> List[Any]:
        """Dequeue exactly ``num_items`` or nothing (non-blocking)."""
        with self._mutex:
            if len(self._items) < num_items:
                raise Empty(f"queue has {len(self._items)} items, need "
                            f"{num_items}")
            out = [self._items.popleft() for _ in range(num_items)]
            self._not_full.notify_all()
            return out


class MultiQueue:
    """``num_queues`` FIFO queues of at most ``maxsize`` items each (0:
    unbounded); ``get`` blocks by default. With a ``name``, the queue is
    registered for :func:`connect_queue` until its shutdown."""

    def __init__(self, num_queues: int, maxsize: int = 0,
                 name: Optional[str] = None):
        if num_queues < 1:
            raise ValueError(f"num_queues must be >= 1, got {num_queues}")
        self._maxsize = maxsize
        self._queues: List[BoundedFifo] = [
            BoundedFifo(maxsize) for _ in range(num_queues)]
        self._closed = threading.Event()
        self._depth_gauges: Dict[int, rt_metrics.Gauge] = {}
        self._name = name
        if name is not None:
            with _REGISTRY_LOCK:
                if name in _REGISTRY:
                    raise ValueError(f"queue name already registered: {name}")
                _REGISTRY[name] = self

    @property
    def num_queues(self) -> int:
        return len(self._queues)

    def size(self, queue_idx: int) -> int:
        """Items in queue ``queue_idx`` now."""
        return self._queues[queue_idx].qsize()

    def sizes(self, indices: Optional[List[int]] = None) -> List[int]:
        """Items in each of ``indices`` (every queue by default)."""
        queues = (self._queues if indices is None
                  else [self._queues[i] for i in indices])
        return [q.qsize() for q in queues]

    def _note_depth(self, queue_idx: int) -> None:
        gauge = self._depth_gauges.get(queue_idx)
        if gauge is None:
            # The registry's get-or-create hands every racing thread the
            # same cell.
            gauge = self._depth_gauges[queue_idx] = rt_metrics.gauge(
                "rsdl_queue_depth", "items resident per queue",
                queue=str(queue_idx))
        gauge.set(self._queues[queue_idx].qsize())

    def _check_open(self) -> None:
        if self._closed.is_set():
            raise ShutdownError("queue is shut down")

    def put(self, queue_idx: int, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        rt_faults.inject("queue_put", task=queue_idx)
        self._check_open()
        start = rt_telemetry.stamp()
        try:
            self._queues[queue_idx].put(item, block=block, timeout=timeout)
        except Full:
            raise Full(f"queue {queue_idx} is full") from None
        rt_telemetry.record("queue_put", task=queue_idx,
                            dur_s=rt_telemetry.stamp() - start)
        if start:  # 0.0 exactly when telemetry is off
            self._note_depth(queue_idx)

    def put_nowait(self, queue_idx: int, item: Any) -> None:
        self.put(queue_idx, item, block=False)

    def put_batch(self, queue_idx: int, items: List[Any], block: bool = True,
                  timeout: Optional[float] = None) -> None:
        self._check_open()
        for item in items:
            self.put(queue_idx, item, block=block, timeout=timeout)

    def put_nowait_batch(self, queue_idx: int, items: List[Any]) -> None:
        """All of ``items`` or none, without blocking (raises
        :class:`Full`)."""
        self._check_open()
        try:
            self._queues[queue_idx].put_batch_atomic(items)
        except Full as e:
            raise Full(f"queue {queue_idx}: {e}") from None
        if rt_telemetry.stamp():
            self._note_depth(queue_idx)

    def get(self, queue_idx: int, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        """Pop one item; a non-blocking get of an empty queue, or one that
        waited ``timeout`` seconds, raises :class:`Empty`."""
        rt_faults.inject("queue_get", task=queue_idx)
        start = rt_telemetry.stamp()
        try:
            item = self._queues[queue_idx].get(block=block, timeout=timeout)
        except Empty:
            raise Empty(f"queue {queue_idx} is empty") from None
        rt_telemetry.record("queue_get", task=queue_idx,
                            dur_s=rt_telemetry.stamp() - start)
        if start:
            self._note_depth(queue_idx)
        return item

    def get_nowait(self, queue_idx: int) -> Any:
        return self.get(queue_idx, block=False)

    def get_nowait_batch(self, queue_idx: int, num_items: int) -> List[Any]:
        """Exactly ``num_items`` items or none, without blocking (raises
        :class:`Empty`)."""
        try:
            items = self._queues[queue_idx].get_batch_atomic(num_items)
        except Empty as e:
            raise Empty(f"queue {queue_idx}: {e}") from None
        if rt_telemetry.stamp():
            self._note_depth(queue_idx)
        return items

    def shutdown(self, force: bool = False,
                 grace_period_s: float = 5.0) -> None:
        """Refuse further puts and wake every blocked ``get``/``put`` with
        :class:`ShutdownError`; items already queued stay readable by gets
        that need not wait. ``force`` and ``grace_period_s`` are the JAX
        package's signature: they bound its in-flight async ops, which
        this queue does not have."""
        del force, grace_period_s
        self._closed.set()
        for q in self._queues:
            q.close()
        if self._name is not None:
            with _REGISTRY_LOCK:
                if _REGISTRY.get(self._name) is self:
                    del _REGISTRY[self._name]


def connect_queue(name: str, retries: int = CONNECT_RETRIES,
                  initial_backoff_s: float = CONNECT_INITIAL_BACKOFF_S
                  ) -> MultiQueue:
    """The queue registered under ``name`` in this process, looked up
    again after each of ``retries`` doubling backoffs (the JAX package's
    schedule); ``TimeoutError`` if it never appears."""
    backoff = initial_backoff_s
    for attempt in range(retries + 1):
        with _REGISTRY_LOCK:
            queue = _REGISTRY.get(name)
        if queue is not None:
            return queue
        if attempt < retries:
            time.sleep(backoff)
            backoff *= 2
    raise TimeoutError(
        f"could not connect to queue {name!r} after {retries} retries")
