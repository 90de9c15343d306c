"""In-process blocking queues, one per ``(epoch, rank)``.

Queue ``epoch * num_trainers + rank`` carries rank ``rank``'s reducer
outputs for ``epoch`` followed by a ``None`` end-of-epoch sentinel (the
JAX package's ``plan.ir.queue_index`` contract). Every put and get is a
``queue_put``/``queue_get`` event keyed ``task=queue index`` and refreshes
the queue's ``rsdl_queue_depth`` gauge, as in the JAX package's queue;
with telemetry off (``telemetry.stamp()`` returns 0.0) neither is paid.
"""

from __future__ import annotations

import queue
from typing import Any, Dict, List

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)


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
        self._depth_gauges: Dict[int, rt_metrics.Gauge] = {}

    @property
    def num_queues(self) -> int:
        return len(self._queues)

    def _note_depth(self, queue_idx: int) -> None:
        gauge = self._depth_gauges.get(queue_idx)
        if gauge is None:
            # The registry's get-or-create hands every racing thread the
            # same cell.
            gauge = self._depth_gauges[queue_idx] = rt_metrics.gauge(
                "rsdl_queue_depth", "items resident per queue",
                queue=str(queue_idx))
        gauge.set(self._queues[queue_idx].qsize())

    def put(self, queue_idx: int, item: Any) -> None:
        if self._closed:
            raise ShutdownError("queue is shut down")
        start = rt_telemetry.stamp()
        self._queues[queue_idx].put(item)
        rt_telemetry.record("queue_put", task=queue_idx,
                            dur_s=rt_telemetry.stamp() - start)
        if start:  # 0.0 exactly when telemetry is off
            self._note_depth(queue_idx)

    def put_batch(self, queue_idx: int, items: List[Any]) -> None:
        for item in items:
            self.put(queue_idx, item)

    def get(self, queue_idx: int) -> Any:
        start = rt_telemetry.stamp()
        item = self._queues[queue_idx].get()
        rt_telemetry.record("queue_get", task=queue_idx,
                            dur_s=rt_telemetry.stamp() - start)
        if start:
            self._note_depth(queue_idx)
        return item

    def shutdown(self) -> None:
        """Refuse further puts; items already queued stay readable."""
        self._closed = True
