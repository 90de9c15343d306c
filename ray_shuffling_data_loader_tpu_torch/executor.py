"""Futures-based task executor with ``wait(num_returns)`` semantics (own
copy of the JAX package's ``executor.py``): the thread backend here, the
process backend in ``procpool.py``.

Map and reduce tasks are host threads: pyarrow's Parquet decode and
``take``, NumPy and the native kernels release the GIL in the heavy
parts, and threads share the Arrow buffers zero-copy. :class:`TaskRef` is
the handle a task's result travels as (to the plan scheduler, the
reducers, the batch queues); :func:`wait` returns once ``num_returns`` of
the given refs have completed, in input order.

``executor_backend`` (kwarg > ``RSDL_EXECUTOR_BACKEND`` > ``"auto"``):
:func:`resolve_backend` decides as the JAX package does
(``procpool.resolve_backend``), except that an explicit ``"process"``
that cannot run raises instead of running on threads.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

BACKENDS = ("auto", "thread", "process")


def resolve_backend(override: Optional[str] = None,
                    num_workers: Optional[int] = None,
                    transforms: Sequence[Any] = ()) -> str:
    """``"thread"`` or ``"process"``: the backend a shuffle that owns its
    pool runs on (``procpool.resolve_backend``)."""
    from ray_shuffling_data_loader_tpu_torch import procpool
    return procpool.resolve_backend(override, num_workers, transforms)


class TaskRef:
    """Handle to an in-flight task's result; holds a strong reference to
    the result until dropped, so dropping refs frees their tables."""

    __slots__ = ("_future",)

    def __init__(self, future: cf.Future):
        self._future = future

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def cancel(self) -> bool:
        return self._future.cancel()

    def add_done_callback(self, fn) -> None:
        """Run ``fn(future)`` when the task completes (at once if it
        has): the plan scheduler's dispatch rides on this."""
        self._future.add_done_callback(fn)


def get(refs, timeout: Optional[float] = None):
    """Resolve a TaskRef or a list of them to their values."""
    if isinstance(refs, TaskRef):
        return refs.result(timeout)
    return [r.result(timeout) for r in refs]


def wait(refs: Sequence[TaskRef], num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[TaskRef], List[TaskRef]]:
    """Block until ``num_returns`` of ``refs`` are done; returns ``(done,
    not_done)``, each in input order. On a timeout ``done`` may hold
    fewer than ``num_returns``."""
    if num_returns > len(refs):
        raise ValueError(
            f"num_returns={num_returns} exceeds number of refs={len(refs)}")
    if len({id(r) for r in refs}) != len(refs):
        raise ValueError("wait() does not accept duplicate refs")
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = {r._future: r for r in refs}
    satisfied: set = set()
    while num_returns > 0 and len(satisfied) < num_returns:
        budget = (None if deadline is None
                  else max(0.0, deadline - time.monotonic()))
        finished, _ = cf.wait(
            pending.keys(), timeout=budget,
            return_when=cf.ALL_COMPLETED
            if num_returns - len(satisfied) == len(pending)
            else cf.FIRST_COMPLETED)
        satisfied.update(finished)
        for future in finished:
            pending.pop(future, None)
        if deadline is not None and time.monotonic() >= deadline:
            break
    done_refs: List[TaskRef] = []
    for ref in refs:
        if ref._future in satisfied and len(done_refs) < max(num_returns, 0):
            done_refs.append(ref)
    done_set = {id(r) for r in done_refs}
    return done_refs, [r for r in refs if id(r) not in done_set]


# The last shuffle worker pool created in this process (any pool but a
# one-thread driver): what a run reports as the backend and width it
# resolved.
_pool_info_lock = threading.Lock()
_last_pool_info = {"backend": None, "workers": None, "pids": []}


def note_worker_pool(backend: str, workers: int, pids: Sequence[int]) -> None:
    with _pool_info_lock:
        _last_pool_info.update(backend=backend, workers=workers,
                               pids=list(pids))


def last_worker_pool() -> dict:
    """``{backend, workers, pids}`` of the most recent worker pool
    (``backend`` None if there was none yet)."""
    with _pool_info_lock:
        return dict(_last_pool_info)


class Executor:
    """Per-host thread-pool task executor.

    ``task_retries``: re-run a task that raises up to N more times, under
    ``RetryPolicy.for_component("executor")`` (jittered backoff;
    ``RSDL_EXECUTOR_RETRY_*`` sets the backoff, ``task_retries`` the
    attempts). Safe for the shuffle's tasks, each a pure function of
    ``(seed, epoch, task)``, and for distributed maps (the receiver drops
    resent frames); NOT for a task that consumes one-shot inputs (a
    distributed reduce takes its transport messages once), which goes
    through :meth:`submit_once`.
    """

    #: Data-plane discriminator (``procpool.ProcessPoolExecutor`` says
    #: "process").
    backend = "thread"

    def __init__(self, num_workers: Optional[int] = None,
                 thread_name_prefix: str = "rsdl-worker",
                 task_retries: int = 0, retry_policy=None):
        if num_workers is None:
            num_workers = os.cpu_count() or 4
        if task_retries < 0:
            raise ValueError(f"task_retries must be >= 0, got {task_retries}")
        self._num_workers = num_workers
        self._task_retries = task_retries
        # The pool's width and submissions by pool name (the thread-name
        # prefix that SIGUSR1 stack dumps show, so the two join), and this
        # process as the thread backend's live "worker".
        from ray_shuffling_data_loader_tpu_torch.runtime import (
            metrics as rt_metrics)
        rt_metrics.gauge("rsdl_executor_workers",
                         "thread-pool width by pool name",
                         pool=thread_name_prefix).set(num_workers)
        self._tasks_submitted = rt_metrics.counter(
            "rsdl_executor_tasks_total", "tasks submitted by pool name",
            pool=thread_name_prefix)
        rt_metrics.gauge("rsdl_executor_worker_up",
                         "1 while the pid is a live pool worker",
                         pool=thread_name_prefix,
                         pid=str(os.getpid())).set(1)
        if retry_policy is None and task_retries:
            from ray_shuffling_data_loader_tpu_torch.runtime import retry
            retry_policy = retry.RetryPolicy.for_component(
                "executor", retry_max_attempts=task_retries + 1)
        self._retry_policy = retry_policy
        self._pool = cf.ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix=thread_name_prefix)
        self._shutdown = False
        if thread_name_prefix != "rsdl-driver":
            note_worker_pool("thread", num_workers, [os.getpid()])

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def submit(self, fn: Callable, *args, **kwargs) -> TaskRef:
        if self._shutdown:
            raise RuntimeError("executor is shut down")
        self._tasks_submitted.inc()
        if self._retry_policy is not None:
            return TaskRef(self._pool.submit(self._run_with_retries, fn,
                                             args, kwargs))
        return TaskRef(self._pool.submit(fn, *args, **kwargs))

    def submit_once(self, fn: Callable, *args, **kwargs) -> TaskRef:
        """Submit WITHOUT the retry policy: for a task whose inputs are
        consumed on first use, where a retry could only block and then
        fail with a misleading timeout."""
        if self._shutdown:
            raise RuntimeError("executor is shut down")
        self._tasks_submitted.inc()
        return TaskRef(self._pool.submit(fn, *args, **kwargs))

    def _run_with_retries(self, fn: Callable, args, kwargs) -> Any:
        return self._retry_policy.call(
            fn, *args, describe=getattr(fn, "__name__", repr(fn)), **kwargs)

    def map(self, fn: Callable, items: Sequence) -> List[TaskRef]:
        return [self.submit(fn, item) for item in items]

    def shutdown(self, wait_for_tasks: bool = True,
                 cancel_pending: bool = False) -> None:
        self._shutdown = True
        self._pool.shutdown(wait=wait_for_tasks,
                            cancel_futures=cancel_pending)

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
