"""Consumer-side stall statistics: time the trainer spent blocked waiting
for its next batch (the stall metric of the train path)."""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class BatchWaitStats:
    wait_times: List[float] = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def record(self, wait_s: float) -> None:
        with self._lock:
            self.wait_times.append(wait_s)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            arr = np.asarray(self.wait_times, dtype=np.float64)
        if arr.size == 0:
            return {"mean": 0.0, "std": 0.0, "max": 0.0, "min": 0.0,
                    "total": 0.0, "count": 0}
        return {
            "mean": float(arr.mean()), "std": float(arr.std()),
            "max": float(arr.max()), "min": float(arr.min()),
            "total": float(arr.sum()), "count": int(arr.size),
        }
