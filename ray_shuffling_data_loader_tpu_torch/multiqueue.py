"""In-process blocking queues, one per ``(epoch, rank)``.

Queue ``epoch * num_trainers + rank`` carries rank ``rank``'s reducer
outputs for ``epoch`` followed by a ``None`` end-of-epoch sentinel (the
JAX package's ``plan.ir.queue_index`` contract).
"""

from __future__ import annotations

import queue
from typing import Any, List


def queue_index(epoch: int, rank: int, num_trainers: int) -> int:
    """The queue carrying ``rank``'s tables for ``epoch``."""
    return epoch * num_trainers + rank


class ShutdownError(RuntimeError):
    """Raised by ``put`` after :meth:`MultiQueue.shutdown`."""


class MultiQueue:
    """``num_queues`` unbounded FIFO queues; ``get`` blocks."""

    def __init__(self, num_queues: int):
        if num_queues < 1:
            raise ValueError(f"num_queues must be >= 1, got {num_queues}")
        self._queues: List[queue.SimpleQueue] = [
            queue.SimpleQueue() for _ in range(num_queues)]
        self._closed = False

    @property
    def num_queues(self) -> int:
        return len(self._queues)

    def put(self, queue_idx: int, item: Any) -> None:
        if self._closed:
            raise ShutdownError("queue is shut down")
        self._queues[queue_idx].put(item)

    def put_batch(self, queue_idx: int, items: List[Any]) -> None:
        for item in items:
            self.put(queue_idx, item)

    def get(self, queue_idx: int) -> Any:
        return self._queues[queue_idx].get()

    def shutdown(self) -> None:
        """Refuse further puts; items already queued stay readable."""
        self._closed = True
