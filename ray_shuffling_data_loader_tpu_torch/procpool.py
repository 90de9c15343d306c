"""Process-pool data plane: worker processes and shared-memory Arrow
handoff (own copy of the JAX package's ``procpool.py``).

The thread executor keeps the map/reduce work in one Python process, so
whatever holds the GIL there (per-task bookkeeping, Parquet metadata,
NumPy arms) serializes. This pool is the multicore plane behind the same
``Executor`` contract (``submit`` / ``submit_once`` / ``wait`` /
``TaskRef``):

- N worker **processes** run map and reduce tasks end to end, one at a
  time each, and a dead one is respawned under the ``procpool`` retry
  policy (``RSDL_PROCPOOL_RETRY_*``).
- The handoff is **Arrow IPC over shared memory**: a worker writes its
  output table as an IPC file in a segment directory (``/dev/shm`` by
  default) and replies with the path only; the driver, the other workers
  and the spill tier memory-map the very pages the worker wrote.
- A file's decoded table, published as a segment, is the **cross-epoch
  file cache** (the process-plane counterpart of
  ``shuffle.FileTableCache``), budgeted by ``executor_shm_bytes`` and
  charged to the buffer ledger. A segment is named by a digest of the
  file's name, never by its index: an index names another file in
  another epoch's list.
- A dead worker's task is **resubmitted from lineage** (map and reduce
  tasks are pure functions of ``(seed, epoch, task)`` and file paths) and
  recorded as a lineage recompute in ``stats.fault_stats()``.
  :meth:`ProcessPoolExecutor.submit_once` tasks are not resubmitted: they
  fail with :class:`WorkerDied`.

Workers are forks of a worker template, ``python -m
ray_shuffling_data_loader_tpu_torch.procpool_worker``, which the driver
process starts once and which has loaded NumPy, pyarrow and pandas
(:class:`_Template`); not ``multiprocessing``'s spawn, which would import
the driver's ``__main__`` (and the torch it imports) again in every
worker, nor a fork of the driver, which may hold CUDA. A worker imports
the port's host modules only (``shuffle``, ``partition``, ``native``,
``spill``, ``plan``, ``runtime``, ``stats``, ``storage``) and never
touches CUDA (``CUDA_VISIBLE_DEVICES`` is empty in its environment). It
takes the driver's environment and ``sys.path`` as they are when it
starts, so an ``RSDL_CHAOS_SPEC`` chaos spec fires in the workers as in
the driver, and a transform defined in any module the driver can import
unpickles there (not one defined in ``__main__``: see
:func:`shippable`).

Telemetry, as in the JAX pool: the driver keeps the
``rsdl_executor_workers``/``_tasks_total``/``_worker_up`` and
``rsdl_pool_worker_restarts_total`` metrics, records a
``pool_worker_crash`` event per dead worker and feeds the workers'
``map_read``/``reduce_gather`` durations to its bottleneck attribution
(``telemetry.observe_stage``: no ring event, so merged dumps count each
span once). Each worker records those events in its own flight recorder,
counts its tasks (``rsdl_worker_tasks_total``), writes its metrics shard
under ``RSDL_TELEMETRY_DIR`` (named by its own pid), dumps its recorder on
``SIGUSR1`` and, with ``RSDL_TRACE_DIR`` set, when it ends; a reducer
output is stamped (``rsdl.trace``, ``rsdl.birth``) in the worker before
its segment is written. The pool reports its width and pids through
``executor.note_worker_pool`` and its recomputes through
``stats.fault_stats()``.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures as cf
import hashlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import timeit
import types
import weakref
from multiprocessing import reduction
from multiprocessing.connection import Connection
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_shuffling_data_loader_tpu_torch import executor as ex
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.singleflight import SingleFlight
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

# Worker respawns: a supervisor's budget, not a call's (a preempted host
# may lose several workers in one run).
rt_policy.register_defaults("procpool", retry_max_attempts=4,
                            retry_initial_backoff_s=0.1,
                            retry_max_backoff_s=2.0)

#: Resubmissions of one task after worker deaths (a second run of a pure
#: lineage task is a recompute, not a replay hazard).
_TASK_RESUBMITS = 2

#: Longest a map's dispatch waits for another epoch's load of its file
#: into the segment cache before it decodes the file itself.
_SEGMENT_WAIT_S = 300.0

#: Longest the worker template takes to answer a request (a fork).
_TEMPLATE_REPLY_S = 60.0

#: The module the worker template runs (the workers are its forks).
WORKER_MODULE = "ray_shuffling_data_loader_tpu_torch.procpool_worker"

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_totals_lock = threading.Lock()
_totals = {"pools": 0, "segment_cache_hits": 0,
           "segment_cache_bytes": 0, "templates": 0,
           "template_import_s": 0.0, "ready_s": 0.0, "worker_starts": 0,
           "worker_import_s": 0.0}
#: Names of the process pools made in this process: their children of
#: ``rsdl_executor_tasks_total`` are the pool's tasks (the thread
#: executor counts under its own names).
_pool_names: set = set()


def pool_totals() -> Dict[str, float]:
    """``{pools, tasks, segment_cache_hits, segment_cache_bytes,
    respawns, templates, template_import_s, ready_s, worker_starts,
    worker_import_s}`` over every pool of the process since import
    (monotonic: snapshot before and after a run). ``templates`` and
    ``template_import_s``: worker templates started and the seconds
    each took to load its modules; ``ready_s``: each pool's seconds from
    its constructor's start until every worker said ready;
    ``worker_starts`` and ``worker_import_s``: workers started
    (respawns included) and the seconds each took, once forked, to load
    the port's modules. ``tasks`` and ``respawns`` are the registry's
    ``rsdl_executor_tasks_total`` (over the process pools) and
    ``rsdl_pool_worker_restarts_total``."""
    with _totals_lock:
        out = dict(_totals)
        names = set(_pool_names)
    tasks = rt_metrics.get("rsdl_executor_tasks_total")
    restarts = rt_metrics.get("rsdl_pool_worker_restarts_total")
    out["tasks"] = int(sum(
        m.value for labels, m in
        (tasks.children().items() if tasks is not None else ())
        if dict(labels).get("pool") in names))
    out["respawns"] = int(sum(
        m.value for m in
        (restarts.children().values() if restarts is not None else ())))
    return out


def _count(**deltas) -> None:
    with _totals_lock:
        for key, value in deltas.items():
            _totals[key] += value


class WorkerDied(RuntimeError):
    """A pool worker died running the task and its resubmission budget is
    spent (or the task was submitted once only)."""


class RemoteTaskError(RuntimeError):
    """A task raised in a worker and its exception could not be pickled
    back; carries the remote type name and traceback text."""


def shm_base_dir(override: Optional[str] = None) -> str:
    """The segment root: the ``executor_shm_dir`` policy, else
    ``/dev/shm`` where writable, else the system temp dir (page-cache
    backed mmap: still zero-copy between processes, still no pickling)."""
    configured = rt_policy.resolve("executor", "executor_shm_dir",
                                   override=override)
    if configured:
        return configured
    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        return "/dev/shm"
    return tempfile.gettempdir()


def shm_available(override: Optional[str] = None) -> bool:
    base = shm_base_dir(override)
    return os.path.isdir(base) and os.access(base, os.W_OK)


def default_shm_bytes(base_dir: str) -> int:
    """The segment cache's budget where none is set: half the free bytes
    of the segment filesystem."""
    import shutil
    try:
        return shutil.disk_usage(base_dir).free // 2
    except OSError:
        return 1 << 30


class _MainRefFinder(pickle.Pickler):
    """Pickles to nowhere, noting whether anything pickled by reference
    (a class, a function) lives in ``__main__``."""

    def __init__(self):
        super().__init__(_NullSink(), protocol=pickle.HIGHEST_PROTOCOL)
        self.refers_to_main = False

    def persistent_id(self, obj):
        if (isinstance(obj, (type, types.FunctionType))
                and getattr(obj, "__module__", None) == "__main__"):
            self.refers_to_main = True
        return None


class _NullSink:
    def write(self, data) -> int:
        return len(data)


def shippable(obj: Any) -> bool:
    """Whether ``obj`` unpickles in a pool worker: it pickles, and
    nothing in its pickle refers to ``__main__`` (a worker runs
    :data:`WORKER_MODULE` as its main module, never the driver's)."""
    if obj is None:
        return True
    finder = _MainRefFinder()
    try:
        finder.dump(obj)
    except Exception:  # noqa: BLE001 - any failure means "cannot ship it"
        return False
    return not finder.refers_to_main


def resolve_backend(override: Optional[str] = None,
                    num_workers: Optional[int] = None,
                    transforms: Sequence[Any] = ()) -> str:
    """``"thread"`` or ``"process"`` for a shuffle that owns its pool
    (kwarg > ``RSDL_EXECUTOR_BACKEND`` > ``"auto"``).

    ``"auto"`` is the JAX package's rule: the process pool where the host
    has more than one core, the pool would have more than one worker, the
    shared-memory dir is writable, every transform pickles (they cross to
    the workers) and no chaos spec was installed programmatically (one
    from the environment fires in the workers too; an ``install()``-ed
    one lives in the driver only); else threads. Two more conditions,
    which the JAX package's spawned workers do not need: no transform
    refers to ``__main__`` (a worker's main module is the worker's, so
    such a transform would not unpickle there), and no storage source was
    installed with ``storage.set_source`` (it lives in the driver only;
    the workers would read through the one the environment names).

    An explicit ``"process"`` that cannot run (no writable segment dir, a
    transform that does not ship, an installed storage source) raises
    ``ValueError``. (The JAX package warns and runs on threads; the port
    never gives way to another plane quietly.)
    """
    backend = rt_policy.resolve("executor", "executor_backend",
                                override=override)
    if backend not in ex.BACKENDS:
        raise ValueError(f"executor_backend must be one of {ex.BACKENDS}, "
                         f"got {backend!r}")
    from ray_shuffling_data_loader_tpu_torch import storage
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    ships = all(shippable(t) for t in transforms)
    source_installed = storage.source_installed()
    if backend == "auto":
        cores = os.cpu_count() or 1
        workers = num_workers if num_workers else cores
        programmatic_chaos = faults.active() and not faults.spec_from_env()
        return ("process" if (cores > 1 and workers > 1 and shm_available()
                              and ships and not programmatic_chaos
                              and not source_installed)
                else "thread")
    if backend == "process":
        if not shm_available():
            raise ValueError(
                f"executor_backend='process' needs a writable segment dir; "
                f"{shm_base_dir()!r} is not (set RSDL_EXECUTOR_SHM_DIR, or "
                "choose the thread backend)")
        if not ships:
            raise ValueError(
                "executor_backend='process' needs map/reduce transforms "
                "that unpickle in the workers; a closure does not, nor "
                "anything defined in __main__ (use a callable defined in "
                "an importable module, or the thread backend)")
        if source_installed:
            raise ValueError(
                "executor_backend='process' with a storage source "
                "installed by storage.set_source: it lives in this "
                "process only and the workers would read elsewhere "
                "(name it with RSDL_STORAGE_BACKEND, or choose the thread "
                "backend)")
        if faults.active() and not faults.spec_from_env():
            logger.warning("executor_backend='process' with a chaos spec "
                           "installed in this process only: it will not "
                           "fire in the pool's workers")
    return backend


# ---------------------------------------------------------------------------
# Segment I/O (driver and workers)
# ---------------------------------------------------------------------------


def write_table_segment(table, path: str) -> int:
    """Write ``table`` as an Arrow IPC file at ``path`` (a temporary name,
    then an atomic rename, so a dying writer never leaves a torn segment
    under the final name). Returns the file's bytes."""
    import pyarrow as pa
    tmp = f"{path}.{os.getpid()}.tmp"
    with pa.OSFile(tmp, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    os.replace(tmp, path)
    return os.stat(path).st_size


def open_table_segment(path: str):
    """Memory-map an IPC segment back as a table: its buffers are the
    pages the writer produced."""
    import pyarrow as pa
    with pa.memory_map(path) as source:
        return pa.ipc.open_file(source).read_all()


def write_buffer_segment(buf, path: str) -> int:
    """Write an already-serialized buffer at ``path``, with the same
    temporary name and rename as :func:`write_table_segment`. Returns
    its bytes."""
    import pyarrow as pa
    tmp = f"{path}.{os.getpid()}.tmp"
    with pa.OSFile(tmp, "wb") as sink:
        sink.write(buf)
    os.replace(tmp, path)
    return os.stat(path).st_size


def read_segment_buffer(path: str):
    """Memory-map a segment back as one ``pa.Buffer`` of its raw bytes."""
    import pyarrow as pa
    with pa.memory_map(path) as source:
        return source.read_buffer()


def pin_segment(nbytes: int) -> int:
    """Charge a segment's bytes to the buffer ledger for a consumer
    outside the pool; returns the ledger id for :func:`release_segment`."""
    from ray_shuffling_data_loader_tpu_torch import native
    return native.buffer_ledger().register(nbytes)


def release_segment(ledger_id: Optional[int], path: Optional[str] = None,
                    unlink: bool = False) -> None:
    """Release a :func:`pin_segment` charge (idempotent) and optionally
    unlink the segment (a reader that mapped it keeps its mapping)."""
    from ray_shuffling_data_loader_tpu_torch import native
    if ledger_id is not None:
        try:
            native.buffer_ledger().decref(ledger_id)
        except KeyError:
            pass
    if unlink and path:
        _unlink_quiet(path)


def write_index_segment(path: str, offsets: np.ndarray,
                        flat: np.ndarray) -> int:
    """A partition-plan segment: the int64 header ``[num_reducers,
    num_rows]``, then the offsets, then the flat row indices."""
    header = np.array([len(offsets) - 1, len(flat)], dtype=np.int64)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(offsets, dtype=np.int64).tobytes())
        f.write(np.ascontiguousarray(flat, dtype=np.int64).tobytes())
    os.replace(tmp, path)
    return os.stat(path).st_size


def read_index_segment(path: str) -> "tuple[np.ndarray, np.ndarray]":
    """``(offsets, flat)`` views of an index segment (memory-mapped)."""
    raw = np.memmap(path, dtype=np.int64, mode="r")
    num_reducers, num_rows = int(raw[0]), int(raw[1])
    offsets = raw[2:3 + num_reducers]
    flat = raw[3 + num_reducers:3 + num_reducers + num_rows]
    return offsets, flat


def table_segment_name(filename: str) -> str:
    """The cross-epoch segment of ``filename``'s decoded table, named by
    a digest of the name (an index names other files in other lists)."""
    digest = hashlib.sha1(filename.encode()).hexdigest()[:16]
    return f"table_{digest}.arrow"


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Fault drill
# ---------------------------------------------------------------------------


class HoldOnFirstCall:
    """A ``map_transform`` for worker-death drills: ``inner`` (identity
    where None), held once.

    The first call anywhere (the one that creates ``marker`` exclusively)
    writes its process id there and holds until ``marker + ".go"``
    exists or ``hold_s`` passes; every other call goes straight on. A
    caller waits for the marker and then kills that process: a death
    inside a map task, with no sleep deciding when. Picklable (with a
    picklable ``inner``), so it crosses to the pool's workers.
    """

    def __init__(self, marker: str, hold_s: float = 120.0, inner=None):
        self.marker = marker
        self.hold_s = hold_s
        self.inner = inner

    def __call__(self, table):
        if self.inner is not None:
            table = self.inner(table)
        try:
            fd = os.open(self.marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return table
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        deadline = time.monotonic() + self.hold_s
        while (not os.path.exists(self.marker + ".go")
               and time.monotonic() < deadline):
            time.sleep(0.01)
        return table


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------

#: Worker-local cache of mapped cross-epoch segments: every reducer of
#: every epoch gathers from the same file segments, and reopening would
#: parse the IPC footer once per reducer.
_seg_table_cache: Dict[str, Any] = {}


def _cached_segment_table(path: str):
    table = _seg_table_cache.get(path)
    if table is None:
        table = _seg_table_cache[path] = open_table_segment(path)
    return table


def _load_blob(blob: Optional[bytes]):
    return None if blob is None else pickle.loads(blob)


def _shuffle_module():
    from ray_shuffling_data_loader_tpu_torch import shuffle
    return shuffle


def _worker_task_map(payload: dict) -> dict:
    """A map task: decode the file (or map its cached segment), publish
    the decoded table as a segment where it was read, plan its partition
    and write the plan as an index segment. Faults, retries and
    quarantine as ``shuffle.shuffle_map``."""
    import functools
    import pyarrow as pa
    from ray_shuffling_data_loader_tpu_torch import native, partition
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    sh = _shuffle_module()

    filename = payload["filename"]
    epoch, file_index = payload["epoch"], payload["file_index"]
    seed = payload["seed"]
    rt_telemetry.set_trace_seed(seed)
    start = timeit.default_timer()
    table = None
    table_seg = payload.get("table_seg")
    wrote_table_bytes = 0
    cached = False
    if table_seg is not None:
        try:
            table = _cached_segment_table(table_seg)
            cached = True
        except (OSError, pa.ArrowInvalid) as e:
            logger.warning("table segment %s unreadable (%s); re-decoding",
                           table_seg, e)
            _seg_table_cache.pop(table_seg, None)
            table, table_seg = None, None
    grouped = False
    grouped_offsets = None
    if table is None:
        read_retry = rt_retry.RetryPolicy.for_component(
            "map_read", retryable=sh._transient_read_retryable)
        map_transform = _load_blob(payload.get("map_transform"))
        streamed = None
        tried_fused = False
        # The streaming map only for an epoch-scoped segment: a cache
        # grant publishes the decoded table, whose grouped layout would
        # depend on (seed, epoch).
        if not payload.get("cache_grant") and sh._fused_pipeline_enabled():
            tried_fused = True
            faults.inject("map_read", epoch=epoch, task=file_index)
            fused = functools.partial(
                sh._fused_stream_columns, filename, payload["num_reducers"],
                seed, epoch, file_index, map_transform)
            try:
                streamed = read_retry.call(fused,
                                           describe=f"stream {filename}")
            except (OSError, pa.ArrowInvalid) as e:
                if payload.get("on_bad_file") != "skip":
                    raise
                return {"quarantined": faults.QuarantinedFile(
                    filename=filename, epoch=epoch, file_index=file_index,
                    error=f"{type(e).__name__}: {e}")}
        if streamed is not None:
            out_cols, grouped_offsets, names = streamed
            # The segment is the grouped layout: reducer r's rows are
            # the slice [offsets[r], offsets[r+1]) in original row order,
            # so the reduce slices instead of gathering.
            table = pa.table({name: out_cols[name] for name in names})
            grouped = True
        else:
            try:
                table = sh._read_map_table(filename, epoch, file_index,
                                           read_retry,
                                           inject=not tried_fused)
            except (OSError, pa.ArrowInvalid) as e:
                if payload.get("on_bad_file") != "skip":
                    raise
                return {"quarantined": faults.QuarantinedFile(
                    filename=filename, epoch=epoch, file_index=file_index,
                    error=f"{type(e).__name__}: {e}")}
            if map_transform is not None:
                table = map_transform(table)
            # Single-chunk columns: zero-copy numpy views for every
            # reducer that maps this segment.
            table = table.combine_chunks()
        # The reducers gather from the segment, so it is always written:
        # into the cache slot the driver granted, or an epoch-scoped one
        # the driver unlinks when the epoch's reduces are done.
        write_seg = (payload.get("write_table_seg")
                     or f"{payload['idx_seg']}.table.arrow")
        wrote_table_bytes = write_table_segment(table, write_seg)
        cached = (bool(payload.get("cache_grant"))
                  and write_seg == payload.get("write_table_seg"))
        if cached:
            _seg_table_cache[write_seg] = table
        table_seg = write_seg
    end_read = timeit.default_timer()
    rt_telemetry.record("map_read", epoch=epoch, task=file_index,
                        dur_s=end_read - start)
    if grouped:
        # The stream placed every row; the index carries the offsets only.
        idx_bytes = write_index_segment(payload["idx_seg"], grouped_offsets,
                                        np.empty(0, dtype=np.int64))
    else:
        flat, offsets = native.plan_partition_flat(
            table.num_rows, payload["num_reducers"],
            partition.partition_key(seed, epoch, file_index),
            nthreads=payload.get("plan_threads") or 1)
        idx_bytes = write_index_segment(payload["idx_seg"], offsets, flat)
    return {
        "num_rows": table.num_rows,
        "table_seg": table_seg,
        "cached": cached,
        "grouped": grouped,
        "wrote_table_bytes": wrote_table_bytes,
        "idx_seg": payload["idx_seg"],
        "idx_bytes": idx_bytes,
        "read_s": end_read - start,
        "dur_s": timeit.default_timer() - start,
    }


def _worker_task_reduce(payload: dict) -> dict:
    """A reduce task: this reducer's rows of every map segment through
    ``shuffle.shuffle_reduce`` (the thread backend's gather, so the
    output is the same bit for bit), published as a new segment."""
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    sh = _shuffle_module()

    reduce_index = payload["reduce_index"]
    epoch, seed = payload["epoch"], payload["seed"]
    rt_telemetry.set_trace_seed(seed)
    start = timeit.default_timer()
    reduce_transform = _load_blob(payload.get("reduce_transform"))

    def gather_and_shuffle():
        with rt_telemetry.span("reduce_gather", epoch=epoch,
                               task=reduce_index):
            faults.inject("reduce_gather", epoch=epoch, task=reduce_index)
            chunks = []
            for source in payload["sources"]:
                table_seg, idx_seg, cacheable = source[:3]
                grouped = len(source) > 3 and bool(source[3])
                # Epoch-scoped segments are unlinked when the epoch
                # drains: keeping them mapped here would pin their pages.
                table = (_cached_segment_table(table_seg) if cacheable
                         else open_table_segment(table_seg))
                offsets, flat = read_index_segment(idx_seg)
                if grouped:
                    lo = int(offsets[reduce_index])
                    hi = int(offsets[reduce_index + 1])
                    chunks.append(table.slice(lo, hi - lo))
                else:
                    chunks.append(
                        sh.MapShard(table, flat, offsets)[reduce_index])
            return sh.shuffle_reduce(
                reduce_index, seed, epoch, chunks,
                reduce_transform=reduce_transform,
                gather_threads=payload.get("gather_threads"))

    retry = rt_retry.RetryPolicy.for_component("reduce")
    shuffled = retry.call(gather_and_shuffle,
                          describe=f"reduce e{epoch} r{reduce_index}")
    # Born here: the stamp rides the segment's schema to the driver.
    shuffled = sh.stamp_lineage(shuffled, seed, epoch, reduce_index)
    out_seg = payload["out_seg"]
    nbytes = write_table_segment(shuffled, out_seg)
    return {
        "out_seg": out_seg,
        "num_rows": shuffled.num_rows,
        "nbytes": nbytes,
        "dur_s": timeit.default_timer() - start,
    }


def _worker_task_call(payload: dict) -> Any:
    fn, args, kwargs = pickle.loads(payload["blob"])
    return fn(*args, **kwargs)


def _worker_task_ping(payload: dict) -> dict:
    return {"pid": os.getpid(), "worker_index": payload.get("worker_index")}


_TASK_HANDLERS: Dict[str, Callable[[dict], Any]] = {
    "map": _worker_task_map,
    "reduce": _worker_task_reduce,
    "call": _worker_task_call,
    "ping": _worker_task_ping,
}


def worker_main(conn: Connection, worker_index: int) -> None:
    """A worker's loop: one task at a time off its connection, until the
    connection ends or the shutdown sentinel (None) arrives. SIGTERM
    raises ``SystemExit``, so exit handlers run on a terminate."""
    def on_sigterm(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, on_sigterm)
    threading.current_thread().name = f"rsdl-proc-worker-{worker_index}"
    # Federation and dumps, started in the forked worker itself (a thread
    # or a handler of the template would not survive the fork): the
    # per-pid shard under RSDL_TELEMETRY_DIR, a recorder dump on SIGUSR1.
    rt_telemetry.install_signal_dump()
    rt_metrics.maybe_start_shard_writer()
    tasks_done = rt_metrics.counter(
        "rsdl_worker_tasks_total",
        "tasks completed inside pool worker processes",
        worker=str(worker_index))
    try:
        _serve_tasks(conn, tasks_done)
    finally:
        # A worker ends in os._exit, which runs no exit handler: flush
        # its shard and, with a trace dir, its recorder here.
        _flush_worker_telemetry()


def _flush_worker_telemetry() -> None:
    try:
        rt_metrics.write_shard()
        if rt_policy.resolve("telemetry", "trace_dir"):
            rt_telemetry.dump(reason="worker exit")
    except OSError:
        logger.exception("worker telemetry flush failed")


def _serve_tasks(conn: Connection, tasks_done) -> None:
    # A service loop, not a retry: it ends with the connection.
    # rsdl-lint: disable=unbounded-retry
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        task_id, kind, payload = msg
        try:
            reply = (task_id, True, _TASK_HANDLERS[kind](payload))
            tasks_done.inc()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - shipped to the driver
            import traceback
            try:
                pickle.dumps(e)
                err: Any = e
            except Exception:  # noqa: BLE001 - an unpicklable exception
                err = RemoteTaskError(
                    f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
            reply = (task_id, False, err)
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            break


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------


class _WorkerProcess:
    """A worker as the pool sees it (``pid``, ``is_alive``, ``exitcode``,
    ``join``, ``terminate``, ``kill``). The worker is the template's
    child, not the driver's: only the template sees its end and exit
    code, and signals it while its pid cannot name another process."""

    def __init__(self, pid: int, template: "_Template"):
        self.pid = pid
        self._template = template
        self._ended = False
        self._exitcode: Optional[int] = None

    def is_alive(self) -> bool:
        if not self._ended:
            alive, self._exitcode = self._template.poll(self.pid)
            self._ended = not alive
        return not self._ended

    @property
    def exitcode(self) -> Optional[int]:
        self.is_alive()
        return self._exitcode

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        # Each pass asks the template once; the deadline bounds them.
        # rsdl-lint: disable=unbounded-retry
        while self.is_alive():
            if deadline is not None and time.monotonic() >= deadline:
                return
            time.sleep(0.01)

    def terminate(self) -> None:
        self._template.signal(self.pid, signal.SIGTERM)

    def kill(self) -> None:
        self._template.signal(self.pid, signal.SIGKILL)


def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([_PACKAGE_PARENT] + paths)
    # Host work only: a worker never sees (nor initializes) a GPU.
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


class _Template:
    """The worker template (:data:`WORKER_MODULE`): a process started
    once per driver process that has loaded NumPy, pyarrow and pandas,
    and forks every worker of every pool. A worker so starts in
    milliseconds with those modules loaded, where a fresh interpreter
    would load them again in each (seconds per worker when a pool's
    workers start at once)."""

    def __init__(self):
        parent_sock, child_sock = socket.socketpair()
        try:
            self._popen = subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE,
                 str(child_sock.fileno())],
                pass_fds=(child_sock.fileno(),), stdin=subprocess.DEVNULL,
                env=_worker_env(), close_fds=True)
        finally:
            child_sock.close()
        self._conn = Connection(parent_sock.detach())
        self._lock = threading.Lock()
        self.owner = os.getpid()
        _, self.import_s = self._conn.recv()

    def alive(self) -> bool:
        return self._popen.poll() is None

    def fork(self, index: int) -> "tuple[_WorkerProcess, Connection]":
        """A new worker, with the driver's ``sys.path`` and environment
        of now; returns it and the driver's connection to it."""
        parent_sock, child_sock = socket.socketpair()
        try:
            with self._lock:
                self._conn.send(("fork", index, list(sys.path),
                                 _worker_env()))
                reduction.send_handle(self._conn, child_sock.fileno(),
                                      self._popen.pid)
                _, pid = self._reply()
        finally:
            child_sock.close()
        return _WorkerProcess(pid, self), Connection(parent_sock.detach())

    def _reply(self):
        """The template's answer to the request just sent (the caller
        holds the lock, which pairs requests with replies)."""
        if not self._conn.poll(_TEMPLATE_REPLY_S):
            raise OSError(f"the worker template (pid {self._popen.pid}) "
                          f"did not answer in {_TEMPLATE_REPLY_S} s")
        # Bounded by the poll above.
        # rsdl-lint: disable=lock-blocking-call
        return self._conn.recv()

    def poll(self, pid: int) -> "tuple[bool, Optional[int]]":
        """``(alive, exit code)`` of the template's worker ``pid``."""
        with self._lock:
            try:
                self._conn.send(("status", pid))
                _, alive, code = self._reply()
                return alive, code
            except (EOFError, OSError):
                pass
        # The template ended: init reaps its orphans, and their exit
        # codes are lost.
        try:
            os.kill(pid, 0)
            return True, None
        except ProcessLookupError:
            return False, None

    def signal(self, pid: int, sig: int) -> None:
        """Send ``sig`` to the worker ``pid`` if it still runs."""
        with self._lock:
            try:
                self._conn.send(("signal", pid, sig))
                self._reply()
                return
            except (EOFError, OSError):
                pass
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass

    def close(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            try:
                self._conn.send(None)
            except OSError:
                pass
        try:
            self._popen.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self._popen.kill()
            self._popen.wait(timeout_s)
        self._conn.close()


_template_lock = threading.Lock()
_template: Optional[_Template] = None


def _worker_template() -> _Template:
    """This process's template, started on first use (and again if it
    ended, or if this process is a fork of the one that started it)."""
    global _template
    with _template_lock:
        template = _template
        if (template is None or template.owner != os.getpid()
                or not template.alive()):
            template = _template = _Template()
            _count(templates=1, template_import_s=template.import_s)
        return template


@atexit.register
def _close_template() -> None:
    with _template_lock:
        template = _template
    if template is not None and template.owner == os.getpid():
        template.close()


def start_worker_process(index: int) -> "tuple[_WorkerProcess, Connection]":
    """Fork one worker off the template; returns the process and the
    driver's connection. The worker says ``("ready", import_s)`` once it
    has loaded the port's host modules, then serves tasks."""
    return _worker_template().fork(index)


def load_worker_modules() -> None:
    """Load the host modules a worker's tasks use (before it says
    ready, so its first task does not)."""
    from ray_shuffling_data_loader_tpu_torch import (  # noqa: F401
        native, partition, shuffle, storage)
    from ray_shuffling_data_loader_tpu_torch.runtime import (  # noqa: F401
        faults)


class ProcTaskRef(ex.TaskRef):
    """A TaskRef whose ``result()`` may apply a driver-side transform to
    the worker's reply (e.g. map a reducer's output segment as a table):
    once, cached, thread-safe."""

    __slots__ = ("_transform", "_final", "_final_error", "_final_lock",
                 "_finalized")

    def __init__(self, future: cf.Future, transform=None):
        super().__init__(future)
        self._transform = transform
        self._final = None
        self._final_error: Optional[BaseException] = None
        # The finalizer runs under this lock once (an opaque call the
        # static pass cannot follow): mapping the worker's segment
        # registers its bytes in the buffer ledger (its peak lock) and
        # reports the stage to telemetry (the attribution's and the
        # module's locks). Those sections take only the ledger's,
        # metrics', policy's and the recorder's locks, never a task
        # ref's, so the order cannot invert.
        # rsdl-lint: disable=inconsistent-lock-order
        self._final_lock = threading.Lock()
        self._finalized = False

    def result(self, timeout: Optional[float] = None) -> Any:
        raw = self._future.result(timeout)
        if self._transform is None:
            return raw
        with self._final_lock:
            if not self._finalized:
                try:
                    self._final = self._transform(raw)
                except BaseException as e:  # noqa: BLE001 - replayed below
                    self._final_error = e
                self._finalized = True
            if self._final_error is not None:
                raise self._final_error
            return self._final


class _Task:
    __slots__ = ("id", "kind", "payload", "future", "retryable", "attempts",
                 "affinity")

    def __init__(self, task_id: int, kind: str, payload: dict,
                 retryable: bool, affinity: Optional[int]):
        self.id = task_id
        self.kind = kind
        self.payload = payload
        self.future: cf.Future = cf.Future()
        self.retryable = retryable
        self.attempts = 0
        self.affinity = affinity


class _Worker:
    __slots__ = ("proc", "conn", "index", "restarts", "ready")

    def __init__(self, proc, conn, index: int):
        self.proc = proc
        self.conn = conn
        self.index = index
        self.restarts = 0
        self.ready = False


class ProcessPoolExecutor:
    """Per-host process-pool executor (the multicore data plane).

    The ``executor.Executor`` contract: ``submit`` / ``submit_once`` give
    refs that ``executor.wait`` / ``executor.get`` take; plus
    :meth:`submit_kind`, which :func:`process_epoch` uses. ``submit``
    pickles ``(fn, args, kwargs)``, so only module-level callables travel;
    the shuffle ships segment paths and lineage integers, never closures.
    """

    backend = "process"

    def __init__(self, num_workers: Optional[int] = None,
                 shm_dir: Optional[str] = None,
                 shm_bytes: Optional[int] = None,
                 name: str = "rsdl-procpool",
                 task_retries: int = 0):
        from ray_shuffling_data_loader_tpu_torch import native
        self._t_start = timeit.default_timer()
        if num_workers is None:
            num_workers = rt_policy.resolve("executor", "executor_workers")
        if not num_workers:
            num_workers = os.cpu_count() or 1
        self._num_workers = max(1, int(num_workers))
        self._name = name
        base = shm_base_dir(shm_dir)
        os.makedirs(base, exist_ok=True)
        self.segment_dir = tempfile.mkdtemp(prefix="rsdl-pool-", dir=base)
        budget = rt_policy.resolve("executor", "executor_shm_bytes",
                                   override=shm_bytes)
        self.shm_bytes = budget if budget else default_shm_bytes(base)
        # Pure tasks may run again after a worker death (the per-task
        # budget); task_retries raises it as the thread executor's does.
        self._task_resubmits = max(_TASK_RESUBMITS, task_retries)
        self._lock = threading.Condition()
        self._next_task_id = 1
        self._global_q: "collections.deque[_Task]" = collections.deque()
        self._affinity_q: List["collections.deque[_Task]"] = [
            collections.deque() for _ in range(self._num_workers)]
        self._shutdown = False
        self._wait_for_tasks = True
        self._alive_dispatchers = self._num_workers
        restart_policy = rt_retry.RetryPolicy.for_component("procpool")
        self._max_restarts = restart_policy.max_attempts
        self._backoffs = restart_policy.backoffs()
        self.respawns = 0
        #: Seconds from the constructor's start until every worker said
        #: ready (None before).
        self.ready_s: Optional[float] = None
        self._ready_workers = 0
        # The segment cache's registry (the driver's is authoritative):
        # filename -> (segment path, bytes), charged to the ledger.
        self._table_segs: Dict[str, "tuple[str, int]"] = {}
        # Segment loads in flight, owned by the epoch whose map writes.
        self._seg_loads = SingleFlight()
        self._table_seg_bytes = 0
        self._cache_full = False
        self._ledger_ids: List[int] = []
        self.cache_hits = 0
        _count(pools=1)
        with _totals_lock:
            _pool_names.add(name)
        rt_metrics.gauge("rsdl_executor_workers",
                         "pool width by pool name",
                         pool=name).set(self._num_workers)
        self._tasks_submitted = rt_metrics.counter(
            "rsdl_executor_tasks_total", "tasks submitted by pool name",
            pool=name)
        self._worker_restarts = rt_metrics.counter(
            "rsdl_pool_worker_restarts_total",
            "pool worker processes respawned after death", pool=name)
        # Built here once, before the workers load it.
        native.library()
        self._workers: List[_Worker] = [
            self._spawn_worker(i) for i in range(self._num_workers)]
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop, args=(i,),
                             name=f"{name}-dispatch-{i}", daemon=True)
            for i in range(self._num_workers)]
        for t in self._dispatchers:
            t.start()
        ex.note_worker_pool("process", self._num_workers, self.worker_pids())
        self._publish_worker_pids()

    # -- Executor contract ---------------------------------------------

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def worker_pids(self) -> List[int]:
        return [w.proc.pid for w in self._workers
                if w.proc is not None and w.proc.pid is not None]

    def _publish_worker_pids(self) -> None:
        """Per-pid pool membership: 1 for each live worker's pid."""
        for pid in self.worker_pids():
            rt_metrics.gauge("rsdl_executor_worker_up",
                             "1 while the pid is a live pool worker",
                             pool=self._name, pid=str(pid)).set(1)

    def submit(self, fn: Callable, *args, **kwargs) -> ProcTaskRef:
        blob = pickle.dumps((fn, args, kwargs))
        return self.submit_kind("call", {"blob": blob}, retryable=True)

    def submit_once(self, fn: Callable, *args, **kwargs) -> ProcTaskRef:
        """Submit without resubmission: a worker death fails the task
        with :class:`WorkerDied`."""
        blob = pickle.dumps((fn, args, kwargs))
        return self.submit_kind("call", {"blob": blob}, retryable=False)

    def map(self, fn: Callable, items: Sequence) -> List[ProcTaskRef]:
        return [self.submit(fn, item) for item in items]

    def submit_kind(self, kind: str, payload: dict,
                    affinity: Optional[int] = None,
                    transform=None, retryable: bool = True) -> ProcTaskRef:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            task = _Task(self._next_task_id, kind, payload, retryable,
                         affinity)
            self._next_task_id += 1
            if affinity is not None:
                self._affinity_q[affinity % self._num_workers].append(task)
            else:
                self._global_q.append(task)
            self._lock.notify_all()
        self._tasks_submitted.inc()
        return ProcTaskRef(task.future, transform)

    def shutdown(self, wait_for_tasks: bool = True,
                 cancel_pending: bool = False) -> None:
        """Stop the workers and delete the segment directory (tables
        already mapped stay valid). ``wait_for_tasks`` lets the tasks in
        flight finish (else their workers are terminated);
        ``cancel_pending`` cancels the queued ones (else they run
        first)."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._wait_for_tasks = wait_for_tasks
            if cancel_pending:
                queued = list(self._global_q)
                for q in self._affinity_q:
                    queued.extend(q)
                    q.clear()
                self._global_q.clear()
            else:
                queued = []
            self._lock.notify_all()
        self._seg_loads.release_all()  # the maps waiting for a load
        for task in queued:
            task.future.cancel()
        if not self._wait_for_tasks:
            for worker in self._workers:
                if worker.proc is not None and worker.proc.is_alive():
                    worker.proc.terminate()
        for t in self._dispatchers:
            t.join(timeout=60.0)
        for worker in self._workers:
            self._stop_worker(worker)
        self._release_segments()

    def __enter__(self) -> "ProcessPoolExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- Segment cache (decoded tables, across epochs) -----------------

    @property
    def bytes_cached(self) -> int:
        """Resident bytes of the segment cache: the budget
        (``spill.make_budget_state``) discounts its growth, as a
        ``FileTableCache``'s."""
        with self._lock:
            return self._table_seg_bytes

    def segment_path(self, stem: str) -> str:
        return os.path.join(self.segment_dir, stem)

    def cached_table_seg(self, filename: str,
                         epoch: Optional[int] = None) -> Optional[str]:
        """The file's cache segment, or None. With ``epoch``, a load of
        the file by another epoch's map in flight is waited for (up to
        :data:`_SEGMENT_WAIT_S`), so two epochs in flight decode a file
        once; the JAX pool has no such wait. A map of the loading epoch
        itself (a lineage re-run, a backup) never waits."""
        deadline = time.monotonic() + _SEGMENT_WAIT_S
        # Each pass waits out one load by another epoch (shutdown ends
        # them all); the deadline bounds the passes.
        # rsdl-lint: disable=unbounded-retry
        while epoch is not None and not self._shutdown:
            flight = self._seg_loads.flight(filename)
            remaining = deadline - time.monotonic()
            if flight is None or flight.owner == epoch or remaining <= 0:
                break
            flight.wait(remaining)
        with self._lock:
            entry = self._table_segs.get(filename)
            if entry is not None:
                self.cache_hits += 1
        if entry is not None:
            _count(segment_cache_hits=1)
        return entry[0] if entry else None

    def plan_table_seg_write(self, filename: str, file_index: int,
                             epoch: Optional[int] = None) -> Optional[str]:
        """Whether this map task publishes the decoded table as the
        file's cache segment (decided here, so concurrent epochs cannot
        race): the target path, or None. ``file_index`` is the JAX
        signature's; the path depends on the file's name only."""
        with self._lock:
            if (self._cache_full or filename in self._table_segs
                    or self._seg_loads.claim(filename, epoch) is not None):
                return None
        return self.segment_path(table_segment_name(filename))

    def note_table_seg(self, filename: str, path: Optional[str],
                       nbytes: int, epoch: Optional[int] = None) -> None:
        """Record a map's cache-segment outcome and charge the ledger;
        past the byte budget the cache stops growing (later files decode
        again each epoch)."""
        from ray_shuffling_data_loader_tpu_torch import native
        try:
            with self._lock:
                if not path or not nbytes or filename in self._table_segs:
                    return
                self._table_segs[filename] = (path, nbytes)
                self._table_seg_bytes += nbytes
                if self._table_seg_bytes >= self.shm_bytes:
                    self._cache_full = True
        finally:
            # Settles the grant of ``epoch`` (any grant where None): the
            # maps waiting for the load look again.
            if epoch is None:
                self._seg_loads.release(filename)
            else:
                self._seg_loads.release(filename, epoch)
        _count(segment_cache_bytes=nbytes)
        buf_id = native.buffer_ledger().register(nbytes)
        with self._lock:
            self._ledger_ids.append(buf_id)

    def _release_segments(self) -> None:
        import shutil
        from ray_shuffling_data_loader_tpu_torch import native
        ledger = native.buffer_ledger()
        with self._lock:
            ledger_ids, self._ledger_ids = self._ledger_ids, []
        for buf_id in ledger_ids:
            try:
                ledger.decref(buf_id)
            except KeyError:
                pass
        shutil.rmtree(self.segment_dir, ignore_errors=True)

    # -- Worker lifecycle ----------------------------------------------

    def _spawn_worker(self, index: int) -> _Worker:
        proc, conn = start_worker_process(index)
        return _Worker(proc, conn, index)

    def _await_ready(self, worker: _Worker) -> None:
        """Take a new worker's ``("ready", import_s)``."""
        _, import_s = worker.conn.recv()
        worker.ready = True
        _count(worker_starts=1, worker_import_s=import_s)
        with self._lock:
            self._ready_workers += 1
            if self._ready_workers != self._num_workers:
                return
            self.ready_s = timeit.default_timer() - self._t_start
        _count(ready_s=self.ready_s)

    def _stop_worker(self, worker: _Worker, timeout_s: float = 5.0) -> None:
        if worker.proc is None:
            return
        try:
            if worker.proc.is_alive():
                try:
                    worker.conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
                worker.proc.join(timeout=timeout_s)
            if worker.proc.is_alive():
                worker.proc.terminate()
                worker.proc.join(timeout=timeout_s)
            if worker.proc.is_alive():
                worker.proc.kill()
                worker.proc.join(timeout=timeout_s)
        finally:
            try:
                worker.conn.close()
            except OSError:
                pass

    def _next_task(self, index: int) -> Optional[_Task]:
        """Own affinity queue first (segment warmth), then the global
        queue, then the longest sibling queue (affinity is a hint)."""
        with self._lock:
            # A condition wait: every pass pops work or blocks.
            # rsdl-lint: disable=unbounded-retry
            while True:
                queue = self._affinity_q[index]
                if not queue and self._global_q:
                    queue = self._global_q
                if not queue:
                    siblings = [q for q in self._affinity_q if q]
                    if siblings:
                        queue = max(siblings, key=len)
                if queue:
                    return queue.popleft()
                if self._shutdown:
                    return None
                self._lock.wait(timeout=0.2)

    def _complete(self, task: _Task, ok: bool, result: Any) -> None:
        try:
            if ok:
                task.future.set_result(result)
            else:
                task.future.set_exception(result)
        except cf.InvalidStateError:
            pass  # a cancelled ref

    def _handle_worker_death(self, index: int, task: Optional[_Task]
                             ) -> bool:
        """Resubmit the dead worker's task from lineage and respawn the
        worker after a bounded backoff. False when the respawn budget is
        spent (the dispatcher slot retires)."""
        from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
        worker = self._workers[index]
        if worker.proc is not None:
            worker.proc.join(timeout=5.0)
        exitcode = worker.proc.exitcode if worker.proc else None
        rt_telemetry.record("pool_worker_crash", rc=exitcode, worker=index)
        if task is not None:
            task.attempts += 1
            if task.retryable and task.attempts <= self._task_resubmits:
                logger.warning(
                    "%s: worker %d died (rc=%s) running %s task %d; "
                    "resubmitting from lineage (attempt %d)", self._name,
                    index, exitcode, task.kind, task.id, task.attempts)
                stats_mod.fault_stats().record_recompute("lineage", 0.0)
                with self._lock:
                    self._global_q.appendleft(task)
                    self._lock.notify_all()
            else:
                self._complete(task, False, WorkerDied(
                    f"pool worker {index} died (exitcode {exitcode}) "
                    f"running {task.kind} task {task.id}"))
        worker.restarts += 1
        if worker.restarts >= self._max_restarts:
            logger.error("%s: worker %d restart budget (%d) spent; retiring "
                         "the slot", self._name, index, self._max_restarts)
            return False
        with self._lock:
            if self._shutdown:
                return False
            # One backoff generator for every slot: draw under the lock.
            pause = next(self._backoffs)
        logger.error("%s: worker %d died (rc=%s); respawning in %.2fs "
                     "(%d/%d)", self._name, index, exitcode, pause,
                     worker.restarts, self._max_restarts - 1)
        time.sleep(pause)
        try:
            worker.conn.close()
        except OSError:
            pass
        dead_pid = worker.proc.pid if worker.proc is not None else None
        replacement = self._spawn_worker(index)
        replacement.restarts = worker.restarts
        self._workers[index] = replacement
        with self._lock:
            self.respawns += 1
        self._worker_restarts.inc()
        ex.note_worker_pool("process", self._num_workers, self.worker_pids())
        if dead_pid is not None:
            rt_metrics.gauge("rsdl_executor_worker_up",
                             "1 while the pid is a live pool worker",
                             pool=self._name, pid=str(dead_pid)).set(0)
        self._publish_worker_pids()
        return True

    def _dispatch_loop(self, index: int) -> None:
        try:
            # A service loop: it ends on the shutdown sentinel or a spent
            # respawn budget, each death path bounded.
            # rsdl-lint: disable=unbounded-retry
            while True:
                worker = self._workers[index]
                if not worker.ready:
                    try:
                        self._await_ready(worker)
                    except (EOFError, OSError):
                        if not self._handle_worker_death(index, None):
                            return
                        continue
                task = self._next_task(index)
                if task is None:
                    return
                if task.future.cancelled():
                    continue
                try:
                    worker.conn.send((task.id, task.kind, task.payload))
                    reply = worker.conn.recv()
                except (EOFError, OSError):
                    with self._lock:
                        dying = self._shutdown and not self._wait_for_tasks
                    if dying:
                        self._complete(task, False, WorkerDied(
                            "pool shut down while the task was in flight"))
                        return
                    if not self._handle_worker_death(index, task):
                        return
                    continue
                task_id, ok, result = reply
                assert task_id == task.id, (task_id, task.id)
                self._complete(task, ok, result)
        finally:
            self._retire_dispatcher(index)

    def _retire_dispatcher(self, index: int) -> None:
        with self._lock:
            self._alive_dispatchers -= 1
            # Orphaned affinity work goes to the surviving slots.
            while self._affinity_q[index]:
                self._global_q.append(self._affinity_q[index].popleft())
            last = self._alive_dispatchers == 0
            self._lock.notify_all()
        if last:
            # Every slot retired: fail what is queued, so callers see
            # WorkerDied rather than wait forever. Each pass pops one
            # task and submit refuses after shutdown.
            # rsdl-lint: disable=unbounded-retry
            while True:
                with self._lock:
                    if not self._global_q:
                        break
                    task = self._global_q.popleft()
                self._complete(task, False, WorkerDied(
                    "pool retired before the task ran (worker restart "
                    "budget spent, or a no-wait shutdown)"))


# ---------------------------------------------------------------------------
# Process-mode shuffle epoch (driver side)
# ---------------------------------------------------------------------------


def process_epoch(plan,
                  pool: ProcessPoolExecutor,
                  stats_collector=None,
                  map_transform_blob: Optional[bytes] = None,
                  reduce_transform_blob: Optional[bytes] = None,
                  spill_manager=None,
                  gather_threads: Optional[int] = None,
                  on_bad_file: str = "raise",
                  spill_recompute_factory=None) -> List[ProcTaskRef]:
    """Run one epoch's :class:`plan.ir.EpochPlan` on the pool; returns the
    reducer refs, whose ``result()`` is the reducer's output segment
    mapped in the driver (then charged to the ledger, or spilled): the
    thread epoch's contract.

    The plan scheduler dispatches the maps with file affinity (segment
    warmth); the reduces go out only after the ``map`` stage barrier has
    collected every map's reply on the scheduler's driver thread (never
    on a pool dispatcher thread, which a blocking collect could
    deadlock). A map that fails even after the pool's resubmissions runs
    once more from lineage inside that barrier; only a failed recovery
    propagates. Speculative backups (``RSDL_PLAN_SPECULATION``) write to
    segment paths of their own attempt (``....a1.idx``): a granted primary
    writes a flat index while an ungranted backup streams the grouped
    layout, and a shared path would let the loser's rename break the
    winner's. The winner's reply carries its own paths; the loser's are
    reaped when the epoch drains, or by the pool's teardown.
    """
    from ray_shuffling_data_loader_tpu_torch import native
    from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
    from ray_shuffling_data_loader_tpu_torch.plan import (
        scheduler as plan_scheduler)
    sh = _shuffle_module()

    epoch, seed = plan.epoch, plan.seed
    num_reducers = plan.num_reducers
    filenames = plan.filenames
    plan_threads = sh.derive_gather_threads(len(filenames), pool.num_workers)

    def map_payload(file_index: int, filename: str, allow_cache_write: bool,
                    attempt: int = 0) -> dict:
        suffix = f".a{attempt}" if attempt else ""
        payload = {
            "filename": filename,
            "num_reducers": num_reducers,
            "seed": seed,
            "epoch": epoch,
            "file_index": file_index,
            "on_bad_file": on_bad_file,
            "map_transform": map_transform_blob,
            "plan_threads": plan_threads,
            "idx_seg": pool.segment_path(
                f"e{epoch}_f{file_index}{suffix}.idx"),
            # A first attempt waits for another epoch's load of the file.
            "table_seg": pool.cached_table_seg(
                filename, epoch if allow_cache_write else None),
        }
        if payload["table_seg"] is None:
            grant = (pool.plan_table_seg_write(filename, file_index, epoch)
                     if allow_cache_write else None)
            payload["cache_grant"] = grant is not None
            payload["write_table_seg"] = grant or pool.segment_path(
                f"e{epoch}_f{file_index}_table{suffix}.arrow")
        return payload

    holder: Dict[str, Any] = {}
    sources: List["tuple[str, str, bool, bool]"] = []
    epoch_segs: List[str] = []  # unlinked when the epoch drains
    transient = {"bytes": 0, "buf_id": None}

    def dispatch_map(node, attempt: int) -> ProcTaskRef:
        file_index = node.key.task
        payload = map_payload(file_index, node.meta["file"],
                              allow_cache_write=attempt == 0,
                              attempt=attempt)
        if attempt:
            payload["attempt"] = attempt
            # Registered now so a losing backup's files are reaped at the
            # drain; a winner's are appended again (unlink is quiet).
            epoch_segs.append(payload["idx_seg"])
            if payload.get("write_table_seg"):
                epoch_segs.append(payload["write_table_seg"])
        elif stats_collector is not None:
            stats_collector.map_start(epoch)
        return pool.submit_kind("map", payload, affinity=file_index)

    def collect_maps() -> None:
        """The map stage barrier: every map's reply folded into the
        reduces' inputs, in file order. On a failure, the cache grants
        not yet settled are cleared, so no later epoch waits for them."""
        unsettled = [node.meta["file"] for node in plan.maps()]
        try:
            fold_maps(unsettled)
        except BaseException:
            for filename in unsettled:
                pool.note_table_seg(filename, None, 0, epoch)
            raise

    def fold_maps(unsettled: List[str]) -> None:
        scheduler = holder["scheduler"]
        for node in sorted(plan.maps(), key=lambda n: n.key.task):
            file_index = node.key.task
            filename = node.meta["file"]
            try:
                res = scheduler.ref_for(node.id).result()
            except Exception as e:  # noqa: BLE001 - lineage re-run below
                logger.warning(
                    "map task %d (epoch %d) failed on the pool (%s); "
                    "recomputing from lineage", file_index, epoch, e)
                start = timeit.default_timer()
                res = pool.submit_kind(
                    "map", map_payload(file_index, filename, False),
                    affinity=file_index).result()  # a failure propagates
                stats_mod.fault_stats().record_recompute(
                    "lineage", timeit.default_timer() - start)
            unsettled.remove(filename)
            quarantined = res.get("quarantined")
            if quarantined is not None:
                pool.note_table_seg(filename, None, 0, epoch)
                stats_mod.fault_stats().record_quarantine(quarantined)
                logger.error(
                    "quarantined unreadable input file %s (epoch %d, "
                    "file %d): %s (on_bad_file='skip')", filename, epoch,
                    file_index, quarantined.error)
                if stats_collector is not None:
                    stats_collector.map_done(epoch, 0.0, 0.0)
                continue
            cached = bool(res.get("cached"))
            if cached:
                pool.note_table_seg(filename, res.get("table_seg"),
                                    res.get("wrote_table_bytes", 0), epoch)
            else:
                # Clears an unused grant (the granted attempt died and the
                # lineage re-run wrote an epoch-scoped segment).
                pool.note_table_seg(filename, None, 0, epoch)
                epoch_segs.append(res["table_seg"])
                transient["bytes"] += res.get("wrote_table_bytes", 0)
            epoch_segs.append(res["idx_seg"])
            transient["bytes"] += res.get("idx_bytes", 0)
            sources.append((res["table_seg"], res["idx_seg"], cached,
                            bool(res.get("grouped"))))
            if stats_collector is not None:
                stats_collector.map_done(epoch, res["dur_s"], res["read_s"])
            # The worker recorded the event in its own ring; the driver's
            # attribution gets the duration only.
            rt_telemetry.observe_stage("map_read", epoch=epoch,
                                       task=file_index, dur_s=res["read_s"])
        if transient["bytes"]:
            transient["buf_id"] = native.buffer_ledger().register(
                transient["bytes"])

    def dispatch_reduce(node, attempt: int) -> ProcTaskRef:
        reduce_index = node.key.task
        suffix = f".a{attempt}" if attempt else ""
        payload = {
            "reduce_index": reduce_index,
            "seed": seed,
            "epoch": epoch,
            "sources": sources,
            "gather_threads": gather_threads,
            "reduce_transform": reduce_transform_blob,
            "out_seg": pool.segment_path(
                f"e{epoch}_r{reduce_index}{suffix}.arrow"),
        }
        if attempt:
            payload["attempt"] = attempt
            # A loser's output is reaped at the drain; a winner's is
            # unlinked while mapped (safe).
            epoch_segs.append(payload["out_seg"])
        elif stats_collector is not None:
            stats_collector.reduce_start(epoch)
        return pool.submit_kind("reduce", payload)

    pending = {"reduces": num_reducers}
    cleanup_lock = threading.Lock()

    def epoch_cleanup() -> None:
        # The last reducer reply is consumed: the epoch's plan segments
        # (and uncached table segments) have no readers left.
        for path in epoch_segs:
            _unlink_quiet(path)
        if transient["buf_id"] is not None:
            try:
                native.buffer_ledger().decref(transient["buf_id"])
            except KeyError:
                pass

    def finalize_factory(reduce_index: int):
        recompute = (spill_recompute_factory(reduce_index)
                     if spill_recompute_factory is not None else None)

        def finalize(res: dict):
            table = open_table_segment(res["out_seg"])
            weakref.finalize(table, _unlink_quiet, res["out_seg"])
            if stats_collector is not None:
                stats_collector.reduce_done(epoch, res["dur_s"])
            rt_telemetry.observe_stage("reduce_gather", epoch=epoch,
                                       task=reduce_index,
                                       dur_s=res["dur_s"])
            with cleanup_lock:
                pending["reduces"] -= 1
                if pending["reduces"] == 0:
                    epoch_cleanup()
            return sh.account_and_maybe_spill(
                table, spill_manager, recompute=recompute, epoch=epoch,
                task=reduce_index, seed=seed)

        return finalize

    scheduler = plan_scheduler.PlanScheduler(
        plan, pool,
        dispatchers={"map": dispatch_map, "reduce": dispatch_reduce},
        barriers={"map": collect_maps})
    holder["scheduler"] = scheduler
    scheduler.start()
    return [ProcTaskRef(future, finalize_factory(reduce_index))
            for reduce_index, future in enumerate(
                scheduler.futures("reduce"))]
