"""Bounded retry with decorrelated jitter (own copy of the JAX package's
``runtime/retry.py``).

:class:`RetryPolicy` owns the attempt bound, the backoff (AWS-style
decorrelated jitter: ``sleep = min(cap, uniform(base, prev * 3))``, drawn
from ``random.Random(seed)`` as in the JAX package, so one seed gives the
same delays in both), an optional wall-clock deadline and a
retryable-exception predicate. Every retry is recorded in
``stats.fault_stats()``. Knobs resolve through :mod:`.policy`
(``RSDL_RETRY_*``, ``RSDL_<COMPONENT>_RETRY_*``); build one with
:meth:`RetryPolicy.for_component`.

Stdlib only.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional

from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: Never retried whatever the predicate says: a cancellation or teardown
#: signal must stop promptly, and a failed assertion is a bug.
NON_RETRYABLE = (KeyboardInterrupt, SystemExit, GeneratorExit,
                 AssertionError)


def default_retryable(error: BaseException) -> bool:
    """Retry ordinary ``Exception``s; never the signals above."""
    return isinstance(error, Exception) and not isinstance(
        error, NON_RETRYABLE)


def transient_retryable(error: BaseException) -> bool:
    """Predicate for IO-shaped call sites (the device copy): retry
    OS-level failures and injected faults, not logic errors."""
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    return isinstance(error, (OSError, ConnectionError, TimeoutError,
                              faults.InjectedFault))


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and decorrelated jitter.

    ``max_attempts`` is the TOTAL number of calls (1: no retries).
    ``deadline_s`` bounds the call and its retries (``None``: no
    deadline). ``seed`` makes the jitter reproducible; ``sleep`` is
    injectable for tests.
    """

    max_attempts: int = 3
    initial_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    deadline_s: Optional[float] = None
    retryable: Callable[[BaseException], bool] = default_retryable
    seed: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep
    #: Component tag used in logs and fault-stats attribution.
    component: str = "retry"

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.initial_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds must be >= 0")

    @classmethod
    def for_component(cls, component: str, **overrides: Any) -> "RetryPolicy":
        """A policy from the registry: explicit ``overrides`` >
        ``RSDL_<COMPONENT>_RETRY_*`` > ``RSDL_RETRY_*`` > library
        defaults. ``deadline_s`` <= 0 resolves to no deadline."""
        from ray_shuffling_data_loader_tpu_torch.runtime import (
            policy as rt_policy)

        def res(key):
            return rt_policy.resolve(component, key,
                                     override=overrides.pop(key, None))

        deadline = res("retry_deadline_s")
        return cls(max_attempts=int(res("retry_max_attempts")),
                   initial_backoff_s=res("retry_initial_backoff_s"),
                   max_backoff_s=res("retry_max_backoff_s"),
                   deadline_s=None if deadline <= 0 else deadline,
                   component=component, **overrides)

    def backoffs(self):
        """Sleeps between attempts (decorrelated jitter, capped);
        deterministic when ``seed`` is set."""
        rng = random.Random(self.seed)
        prev = self.initial_backoff_s
        while True:
            if self.initial_backoff_s <= 0:
                yield 0.0
                continue
            prev = min(self.max_backoff_s,
                       rng.uniform(self.initial_backoff_s, prev * 3))
            yield prev

    def call(self, fn: Callable[..., Any], *args: Any,
             describe: Optional[str] = None,
             on_retry: Optional[Callable[[BaseException], None]] = None,
             on_recovery: Optional[Callable[[int, float], None]] = None,
             **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` under this policy.

        ``on_retry(error)`` runs before each backoff sleep;
        ``on_recovery(failed_attempts, elapsed_s)`` runs when an attempt
        succeeds after at least one failure.
        """
        from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
        what = describe or getattr(fn, "__name__", repr(fn))
        start = time.monotonic()
        deadline = (None if self.deadline_s is None
                    else start + self.deadline_s)
        backoffs = self.backoffs()
        for attempt in range(1, self.max_attempts + 1):
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - filtered below
                out_of_time = (deadline is not None
                               and time.monotonic() >= deadline)
                if (attempt == self.max_attempts or out_of_time
                        or isinstance(e, NON_RETRYABLE)
                        or not self.retryable(e)):
                    if attempt > 1 or out_of_time:
                        logger.error(
                            "%s: %s failed permanently (attempt %d/%d%s): "
                            "%s", self.component, what, attempt,
                            self.max_attempts,
                            ", deadline exceeded" if out_of_time else "", e)
                    raise
                stats_mod.fault_stats().record_retry(self.component)
                pause = next(backoffs)
                if deadline is not None:
                    pause = min(pause, max(0.0,
                                           deadline - time.monotonic()))
                logger.warning(
                    "%s: %s failed (attempt %d/%d): %s; retrying in %.3fs",
                    self.component, what, attempt, self.max_attempts, e,
                    pause)
                if on_retry is not None:
                    on_retry(e)
                if pause > 0:
                    self.sleep(pause)
                continue
            if attempt > 1:
                elapsed = time.monotonic() - start
                if on_recovery is not None:
                    on_recovery(attempt - 1, elapsed)
                logger.info("%s: %s recovered on attempt %d/%d (%.3fs)",
                            self.component, what, attempt,
                            self.max_attempts, elapsed)
            return result
