"""PyTorch device binding: shuffled batches as device-resident tensors.

Counterpart of the JAX package's ``JaxShufflingDataset``. A column spec
(names, shapes, dtypes of the features plus a label column) is normalised
with the same rules; spec'd columns are cast to their final (narrow)
dtypes at the map stage, before the shuffle; each exact-size batch
becomes ``(list of feature tensors, label)``, each ``(B, *shape)``
(default ``(B, 1)``; a fixed-size list column of width W gives ``(B, W)``,
or ``(B, H, W, C)`` for a feature shape ``(H, W, C)``, as decoded images
are). With ``stack_features`` the features are one ``(B, F)`` tensor,
concatenated on the device.

Two bindings deliver the same batch stream:

- **per-batch**: each exact-size batch is converted to numpy and copied
  on its own. On CUDA the copy goes through a ring of pinned host buffers
  and ``to(device, non_blocking=True)`` on a dedicated copy stream; the
  consumer's stream waits on the batch's CUDA event, so the copy of batch
  N+1 overlaps the training on batch N (this is the JAX package's
  double-buffered staging; ``device_double_buffer=False`` makes the
  producer wait for each copy to land before it converts the next batch).
- **bulk** (``device_rebatch``): whole reducer tables are converted at
  once and copied in chunks of up to ``_MAX_CHUNK_BATCHES`` batches and
  ``max_device_table_bytes`` bytes, one pinned buffer per column per chunk
  and one CUDA event per chunk; the consumer carves batches out of a chunk
  with ``narrow`` views on the device. Rows that straddle reducer tables
  are stitched on the host into ordinary per-batch copies, so the batch
  grid is the per-batch binding's.

On the device int8/int16 columns are widened to int32 (the narrow bytes
are what cross the bus); uint8 columns (image pixels) stay uint8, as the
JAX package keeps them. On the CPU the same streams come out as CPU
tensors.

``device_rebatch="auto"`` (the default) resolves as in the JAX package:
bulk on a CUDA device when ``persistent_prefetch`` is on, per-batch on the
CPU; a policy ``False`` (``RSDL_DEVICE_REBATCH=0``) wins. The JAX
package's mesh arguments have no counterpart: the port's mesh is one
process per card, each with its own rank's loader.

With ``persistent_prefetch`` (the default) one producer thread serves all
epochs and rolls into epoch N+1 while the consumer trains on epoch N;
epochs are then iterated in order. ``num_epochs=None`` reads a stream
(``plan.ir.epoch_range``: the producer enters epochs as windows are
sealed, over a ``batch_queue`` the stream fills). After a bounded
stream's last window the producer prefetches into an epoch that has no
queue; its error is never handed to the consumer, which does not iterate
that epoch, and ``close`` ends the producer. The bulk copy and the first
carve of each chunk run under the process watchdog
(``runtime/watchdog.py``): on CUDA the watched copy ends when its event has
completed, so a wedged DMA shows. A stall halves the chunk cap and, under the default
``stall_action="degrade"``, drops the loader to per-batch copies for
good, with its reason in ``stats.watchdog_stats()``. Every copy is
retried on transient errors (``runtime/retry.py``) and is the
``device_transfer`` fault site (``runtime/faults.py``).
``batch_wait_stats`` records how long the consumer was blocked on each
batch.

Telemetry, at the JAX binding's record sites (``runtime/telemetry.py``):
every conversion is a ``convert`` span and every copy a
``device_transfer`` span keyed by epoch (``batch_*`` per batch,
``table_*`` per reducer table or bulk chunk), plus one ``device_transfer``
attempt marker per copy attempt keyed by the fault site's sequence; the
consumer records ``batch_wait`` for each item it takes (0 for a bulk
chunk's later batches) and ``train_step`` for the gap between handing out
a batch and asking for the next, and ends each epoch with its verdict
(``telemetry.epoch_complete``). (The JAX binding takes that gap's start
when the consumer resumes it, after the step, so its ``train_step``
samples hold only its own bookkeeping; the port takes it when the batch
is handed out, as the JAX comment defines the stage. The event counts are
the same.) The ``train_step`` gap is the host's:
the step enqueues its kernels and returns, so device time lands in
whichever call synchronises next (on the card, mostly the step's own
loss read-back). A :class:`runtime.latency.LatencyProbe` on the converter
observes the ``delivered_to_device`` and ``birth_to_device`` hops when a
copy has been issued.
"""

from __future__ import annotations

import inspect
import itertools
import queue as _queue
import threading
import timeit
import weakref
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
from ray_shuffling_data_loader_tpu_torch.dataset import (ShufflingDataset,
                                                         slice_batches)
from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import latency as rt_latency
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.runtime import (
    watchdog as rt_watchdog)
from ray_shuffling_data_loader_tpu_torch.stats import BatchWaitStats
# The cast lives in a module without torch, so the process pool's workers
# can unpickle it; re-exported under its old names.
from ray_shuffling_data_loader_tpu_torch.transforms import (  # noqa: F401
    CastTransform, make_cast_transform)
from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)
from ray_shuffling_data_loader_tpu_torch.utils.tracing import trace_span

logger = setup_custom_logger(__name__)


def _normalize_data_spec(feature_columns=None, feature_shapes=None,
                         feature_types=None, label_column=None,
                         label_shape=None, label_type=None):
    """Scalars become lists, shapes and types must match the feature
    count, dtypes default to float32 (the JAX package's rules)."""
    if not isinstance(feature_columns, list):
        feature_columns = [feature_columns]
    if feature_shapes:
        if not isinstance(feature_shapes, list):
            feature_shapes = [feature_shapes]
        if len(feature_columns) != len(feature_shapes):
            raise ValueError(
                "The feature_shapes size must match the feature_columns")
        feature_shapes = [
            tuple(s) if isinstance(s, (list, tuple))
            else (None if s is None else (s,))
            for s in feature_shapes
        ]
    else:
        feature_shapes = [None] * len(feature_columns)
    if feature_types:
        if not isinstance(feature_types, list):
            feature_types = [feature_types]
        if len(feature_columns) != len(feature_types):
            raise ValueError(
                "The feature_types size must match the feature_columns")
        feature_types = [np.dtype(t) for t in feature_types]
    else:
        feature_types = [np.dtype(np.float32)] * len(feature_columns)
    label_type = np.dtype(np.float32 if label_type is None else label_type)
    return (feature_columns, feature_shapes, feature_types, label_column,
            label_shape, label_type)


def _column_to_numpy(column: pa.ChunkedArray, name: Any,
                     dtype: np.dtype) -> np.ndarray:
    """Arrow column -> contiguous ndarray of ``dtype``, zero-copy where the
    types align (the JAX package's arms, in its order): a single chunk is
    taken as it is; a null-free ``FixedSizeList<primitive>[W]`` column
    becomes ``(B, W)`` through its child values; a ``list``/``large_list``
    column is stacked; a column of ndarray, list or tuple cells is
    stacked; any other object cell raises ``TypeError``."""
    if column.num_chunks == 1:
        combined = column.chunk(0)
    else:
        # Blessed: reducer outputs arrive as one chunk, so only a batch
        # that the carry stitched from two tables gets here.
        # rsdl-lint: disable=copy-in-hot-path
        combined = column.combine_chunks()
    if (pa.types.is_fixed_size_list(combined.type)
            and pa.types.is_primitive(combined.type.value_type)
            and combined.null_count == 0):
        # Blessed: flatten() is a view of the child values (the slice
        # offset respected), so the reshape is zero-copy.
        # rsdl-lint: disable=copy-in-hot-path
        flat = combined.flatten().to_numpy(zero_copy_only=False)
        arr = flat.reshape(-1, combined.type.list_size)
    elif (pa.types.is_list(combined.type)
          or pa.types.is_large_list(combined.type)
          or pa.types.is_fixed_size_list(combined.type)):
        # Blessed: a ragged list has no zero-copy ndarray form; the stack
        # is the conversion. rsdl-lint: disable=copy-in-hot-path
        arr = np.stack(combined.to_numpy(zero_copy_only=False))
    else:
        # Blessed: zero-copy for a null-free primitive column; the object
        # cells below are the copying case. rsdl-lint: disable=copy-in-hot-path
        arr = combined.to_numpy(zero_copy_only=False)
        if arr.dtype == object:
            first = arr[0] if len(arr) else None
            if isinstance(first, np.ndarray):
                arr = np.stack(arr)
            elif isinstance(first, (list, tuple)):
                arr = np.asarray([list(x) for x in arr])
            else:
                raise TypeError(
                    f"column {name!r}: cell type {type(first)} is not "
                    "supported. It must be a numeric type or an object of "
                    "(ndarray, list, tuple)")
    return np.ascontiguousarray(arr.astype(dtype, copy=False))


def convert_to_arrays(table: pa.Table, feature_columns: List[Any],
                      feature_shapes: List[Optional[Tuple[int, ...]]],
                      feature_types: List[np.dtype], label_column: Any,
                      label_shape: Optional[int], label_type: np.dtype
                      ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Arrow batch -> (per-feature arrays, label array), each shaped
    ``(batch, *shape)``, default ``(batch, 1)``."""
    features = []
    for col, shape, dtype in zip(feature_columns, feature_shapes,
                                 feature_types):
        arr = _column_to_numpy(table.column(col), col, dtype)
        if shape is not None:
            arr = arr.reshape(-1, *shape)
        elif arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        features.append(arr)
    label = _column_to_numpy(table.column(label_column), label_column,
                             label_type)
    if label_shape:
        label = label.reshape(-1, label_shape)
    elif label.ndim == 1:
        label = label.reshape(-1, 1)
    return features, label


_NARROW_INTS = (torch.int8, torch.int16)

# Upper bound on batches per bulk chunk (the JAX package's bound on its
# carve program's shape set, kept so that chunks are the same).
_MAX_CHUNK_BATCHES = 8


def _widen(t: torch.Tensor) -> torch.Tensor:
    """int8/int16 -> int32 (the DLRM indices); anything else, uint8
    pixels included, unchanged."""
    return t.to(torch.int32) if t.dtype in _NARROW_INTS else t


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _CudaStager:
    """Pinned host ring + dedicated copy stream for host-to-device copies.

    Slot ``k`` holds one pinned buffer per column, grown to the largest
    item (a batch or a bulk chunk) it has carried and reused at any
    smaller size; before a slot is refilled, the producer waits on the
    event of the copy that last read it, so a pinned buffer is never
    overwritten while a DMA reads it. With ``prefetch_size + 1`` slots,
    pinned memory stays at about ``(prefetch_size + 1)`` times the largest
    item; ``peak_pinned_bytes`` reports it.
    """

    def __init__(self, device: torch.device, num_slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots: List[Tuple[List[torch.Tensor], Optional[Any]]] = [
            ([], None) for _ in range(num_slots)]
        self.next = 0
        self.pinned_bytes = 0
        self.peak_pinned_bytes = 0

    def _pinned(self, buffers: List[torch.Tensor], i: int,
                arr: np.ndarray) -> torch.Tensor:
        if i == len(buffers):
            buffers.append(torch.empty(0, dtype=torch.uint8))
        buf = buffers[i]
        if buf.numel() < arr.nbytes:
            self.pinned_bytes += arr.nbytes - buf.numel()
            self.peak_pinned_bytes = max(self.peak_pinned_bytes,
                                         self.pinned_bytes)
            buf = buffers[i] = torch.empty(arr.nbytes, dtype=torch.uint8,
                                           pin_memory=True)
        view = buf[:arr.nbytes].view(_torch_dtype(arr.dtype)).view(
            arr.shape)
        np.copyto(view.numpy(), arr)
        return view

    def stage(self, arrays: List[np.ndarray], post=None):
        """Copy ``arrays`` to the device (``post`` maps the device tensors
        on the copy stream); returns ``(tensors, event)``."""
        buffers, event = self.slots[self.next]
        if event is not None:
            event.synchronize()
        pinned = [self._pinned(buffers, i, a) for i, a in enumerate(arrays)]
        with torch.cuda.stream(self.stream):
            out = [_widen(p.to(self.device, non_blocking=True))
                   for p in pinned]
            if post is not None:
                out = post(out)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.slots[self.next] = (buffers, event)
        self.next = (self.next + 1) % len(self.slots)
        return out, event


class _Staged:
    """One copied item: a batch (``n_batches == 0``) or a bulk chunk of
    ``n_batches`` batches, its CUDA event (None on the CPU) and the device
    bytes it holds."""

    __slots__ = ("features", "label", "event", "nbytes", "n_batches")

    def __init__(self, features, label, event, n_batches: int):
        self.features = features
        self.label = label
        self.event = event
        self.n_batches = n_batches
        tensors = features if isinstance(features, list) else [features]
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in tensors + [label])

    def tensors(self) -> List[torch.Tensor]:
        features = self.features
        return (features if isinstance(features, list)
                else [features]) + [self.label]


class _BatchConverter:
    """Arrow table -> device item: the column spec, the copy path and the
    bulk path's supervision state.

    Holds no reference to the dataset wrapper, so the persistent producer
    thread (which runs this) never pins it and a dropped
    ``DeviceShufflingDataset`` can be collected (its finalizer then stops
    the producer).
    """

    def __init__(self, spec, device: torch.device, stack_features: bool,
                 num_slots: int, device_rebatch: bool,
                 device_rebatch_auto: bool, max_table_bytes: int,
                 watchdog: Optional[rt_watchdog.Watchdog],
                 bulk_transfer_deadline_s: float, stall_action: str,
                 double_buffer: bool, transfer_retry: rt_retry.RetryPolicy):
        (self._feature_columns, self._feature_shapes, self._feature_types,
         self._label_column, self._label_shape, self._label_type) = spec
        self.device = device
        self._stack_features = stack_features
        self._stager = (_CudaStager(device, num_slots)
                        if device.type == "cuda" else None)
        # Bulk mode; cleared for good by a "degrade" stall or an "auto"
        # construction whose spec repacks the sample dimension.
        self.device_rebatch = device_rebatch
        self.device_rebatch_auto = device_rebatch_auto
        # Per-chunk byte cap, re-read for every chunk; a stall halves it.
        self.max_table_bytes = max_table_bytes
        self.watchdog = watchdog
        self.bulk_transfer_deadline_s = bulk_transfer_deadline_s
        self.stall_action = stall_action
        self.double_buffer = double_buffer
        self.fallback_engaged = False  # a stall degraded the bulk path
        # Transient copy failures (an injected `device_transfer` fault, an
        # OS-level error) are retried in place: the source is host numpy,
        # so a second copy is pure. A shape or dtype error is a bug and
        # surfaces.
        self._transfer_retry = transfer_retry
        self._transfer_seq = 0  # producer thread only; keys chaos draws
        self.epoch: Optional[int] = None  # the producer's current epoch
        self._lock = threading.Lock()
        # epoch -> {"per_batch": copies, "bulk": copies,
        #           "chunk_batches": {batches per chunk: copies}}
        self.copies: Dict[int, Dict[str, Any]] = {}
        self.device_bytes = 0  # staged, queued or being consumed
        self.peak_device_bytes = 0
        self.peak_chunk_bytes = 0
        # Delivery latency at the device boundary, installed by the owning
        # DeviceShufflingDataset (None: no probe).
        self.latency_probe: Optional[rt_latency.LatencyProbe] = None

    def _note_device_done(self) -> None:
        """A copy has been issued (asynchronous on CUDA: the boundary the
        ``device_transfer`` spans measure too)."""
        if self.latency_probe is not None:
            self.latency_probe.device_done()

    def convert(self, table: pa.Table):
        if self.latency_probe is not None:
            self.latency_probe.table_arrived(table)
        return convert_to_arrays(
            table, self._feature_columns, self._feature_shapes,
            self._feature_types, self._label_column, self._label_shape,
            self._label_type)

    def _device_put_retried(self, thunk):
        """One copy (per batch or per chunk): the ``device_transfer``
        fault site before each attempt and a bounded retry; a recovery
        after a failure is recorded in ``fault_stats``. The converter's
        copy sequence keys the fault site, so a rate rule
        (``device_transfer@0.02``) draws once per attempt."""

        def _put():
            self._transfer_seq += 1
            # An attempt marker (no duration: not a stage sample) with the
            # fault site's key, so an injected copy fault joins the
            # telemetry on (kind, epoch, task); the stage's samples are
            # the epoch-tagged transfer spans.
            rt_telemetry.record("device_transfer", task=self._transfer_seq,
                                attempt=True)
            rt_faults.inject("device_transfer", task=self._transfer_seq)
            return thunk()

        def _recovered(failed_attempts: int, elapsed_s: float) -> None:
            stats_mod.fault_stats().record_recompute("device_transfer",
                                                     elapsed_s)

        return self._transfer_retry.call(_put, describe="device copy",
                                         on_recovery=_recovered)

    def _copy(self, arrays: List[np.ndarray], post=None):
        if self._stager is None:
            out = [_widen(torch.from_numpy(np.array(a)).to(self.device))
                   for a in arrays]
            return (out if post is None else post(out)), None
        return self._stager.stage(arrays, post)

    def _stack(self, features):
        return features[0] if len(features) == 1 else torch.cat(features,
                                                                 dim=1)

    def _account(self, staged: _Staged) -> _Staged:
        with self._lock:
            counts = self.copies.setdefault(
                self.epoch, {"per_batch": 0, "bulk": 0, "chunk_batches": {}})
            if staged.n_batches:
                counts["bulk"] += 1
                sizes = counts["chunk_batches"]
                sizes[staged.n_batches] = sizes.get(staged.n_batches, 0) + 1
                self.peak_chunk_bytes = max(self.peak_chunk_bytes,
                                            staged.nbytes)
            else:
                counts["per_batch"] += 1
            self.device_bytes += staged.nbytes
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self.device_bytes)
        return staged

    def release(self, staged: Optional[_Staged]) -> None:
        """The consumer is done with ``staged``: its bytes leave the
        input pipeline's count."""
        if staged is not None:
            with self._lock:
                self.device_bytes -= staged.nbytes

    def transfer(self, arrays_label) -> _Staged:
        """One batch's copy; with ``stack_features`` its features are
        concatenated on the device (on the copy stream)."""
        features, label = arrays_label
        post = None
        if self._stack_features:
            def post(out):
                return [self._stack(out[:-1]), out[-1]]
        out, event = self._device_put_retried(
            lambda: self._copy(list(features) + [label], post))
        if self._stack_features:
            staged = _Staged(out[0], out[1], event, 0)
        else:
            staged = _Staged(out[:-1], out[-1], event, 0)
        if event is not None and not self.double_buffer:
            event.synchronize()
        self._note_device_done()
        return self._account(staged)

    def transfer_table(self, arrays_label, n_batches: int,
                       batch_size: int) -> _Staged:
        """One bulk chunk: every column's span of ``n_batches *
        batch_size`` rows in one copy each (one pinned buffer per column),
        covered by one event. The carve is :meth:`slice_batch`."""
        features, label = arrays_label
        out, event = self._device_put_retried(
            lambda: self._copy(list(features) + [label]))
        self._note_device_done()
        return self._account(_Staged(out[:-1], out[-1], event, n_batches))

    def slice_batch(self, staged: _Staged, batch_index: int,
                    batch_size: int):
        """Batch ``batch_index`` of a bulk chunk as ``narrow`` views (one
        ``torch.cat`` on the device with ``stack_features``): the same
        ``(features, label)`` the per-batch binding yields."""
        start = batch_index * batch_size
        features = [f.narrow(0, start, batch_size) for f in staged.features]
        label = staged.label.narrow(0, start, batch_size)
        if self._stack_features:
            features = self._stack(features)
        return features, label

    def _on_bulk_stall(self, report) -> None:
        """Watchdog escalation hook, run on the MONITOR thread (the
        producer is stuck in the supervised call). Halves the chunk cap
        and, under "degrade", drops this converter to per-batch copies;
        the producer reroutes when the stuck call returns."""
        if report.escalation == 1:
            self.max_table_bytes = max(1, self.max_table_bytes // 2)
        if self.stall_action == "degrade" and self.device_rebatch:
            self.device_rebatch = False
            self.fallback_engaged = True
            reason = (f"{report.name} stalled {report.waited_s:.4f}s "
                      f"(deadline {report.deadline_s:.4f}s"
                      f"{', ' + report.detail if report.detail else ''}); "
                      "degrading to per-batch transfers")
            stats_mod.watchdog_stats().record_fallback(
                "device_dataset.device_rebatch", reason)
            logger.warning("%s", reason)


def _produce_epoch_batches(dataset: ShufflingDataset,
                           converter: _BatchConverter, epoch: int,
                           put) -> bool:
    """Per-batch producer for one epoch; False when the consumer is
    gone."""
    for table in dataset:
        if not put(("batch", epoch, _convert_transfer(converter, table,
                                                      epoch))):
            return False
    return True


def _convert_transfer(converter: _BatchConverter, table: pa.Table,
                      epoch: Optional[int]) -> _Staged:
    """One exact-size batch: its ``convert`` span, then its copy's
    ``device_transfer`` span."""
    with trace_span("batch_convert", kind="convert", epoch=epoch):
        arrays = converter.convert(table)
    return _transfer(converter, arrays, epoch)


def _transfer(converter: _BatchConverter, arrays_label,
              epoch: Optional[int]) -> _Staged:
    with trace_span("batch_transfer", kind="device_transfer", epoch=epoch):
        return converter.transfer(arrays_label)


def _persistent_producer(dataset: ShufflingDataset,
                         converter: _BatchConverter,
                         out: "_queue.Queue",
                         stop: threading.Event,
                         lock: threading.Lock,
                         pending_skips: dict,
                         started_epochs: set) -> None:
    """Producer loop for ALL epochs (``persistent_prefetch``).

    Module-level on purpose: it references the ShufflingDataset and small
    shared state but NOT the DeviceShufflingDataset wrapper, so a dropped
    wrapper is collectable and its finalizer (which sets ``stop`` and
    drains ``out``) releases this thread.
    """

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    try:
        # A stream (num_epochs None) goes on for as long as windows come.
        for epoch in plan_ir.epoch_range(dataset.start_epoch,
                                         dataset.num_epochs):
            with lock:
                started_epochs.add(epoch)
                skip = pending_skips.pop(epoch, 0)
            dataset.set_epoch(epoch, skip_batches=skip)
            converter.epoch = epoch
            if converter.device_rebatch:
                if not _produce_epoch_tables(dataset, converter, epoch, put,
                                             queue_depth=out.qsize):
                    return
            elif not _produce_epoch_batches(dataset, converter, epoch, put):
                return
            if not put(("end", epoch, None)):
                return
    except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
        put(e)


def _supervised_transfer_table(converter: _BatchConverter, arrays_label,
                               nb: int, bs: int, queue_depth) -> _Staged:
    """One bulk chunk copy under the watchdog.

    On CUDA the watched span ends when the chunk's event has completed,
    not at dispatch: a wedged DMA blocks this (producer) thread, and the
    monitor files the stall while it is stuck (with the prefetch queue's
    depth: 0 means the consumer waits on this very chunk). When the call
    returns, a "raise" stall action surfaces here; "degrade" reroutes in
    the caller's loop through ``converter.device_rebatch``.
    """
    wd = converter.watchdog
    if wd is None:
        return converter.transfer_table(arrays_label, nb, bs)
    detail_fn = None
    if queue_depth is not None:
        detail_fn = lambda: (  # noqa: E731
            f"chunk={nb} batches, prefetch_queue_depth={queue_depth()} "
            "(0 = consumer blocked)")
    with wd.watch("device_dataset.bulk_transfer",
                  deadline_s=converter.bulk_transfer_deadline_s,
                  on_stall=converter._on_bulk_stall,
                  detail_fn=detail_fn) as handle:
        staged = converter.transfer_table(arrays_label, nb, bs)
        if staged.event is not None:
            staged.event.synchronize()
    if handle.stalled and converter.stall_action == "raise":
        raise RuntimeError(
            f"bulk device transfer stalled: ran {handle.report.waited_s:.2f}s"
            f" against a {handle.report.deadline_s:.2f}s deadline "
            "(stall_action='raise')")
    return staged


def _produce_epoch_tables(dataset: ShufflingDataset,
                          converter: _BatchConverter,
                          epoch: int,
                          put,
                          queue_depth=None) -> bool:
    """Bulk producer for one epoch (the JAX package's rules).

    Reads RAW reducer tables (``ShufflingDataset.iter_tables``). Each
    table's batch-aligned middle goes to the device in chunks of at most
    ``_MAX_CHUNK_BATCHES`` batches and ``converter.max_table_bytes`` bytes,
    carved into batches by the consumer. Rows off the batch grid (the
    tail of one table and the head of the next) are stitched on the host
    into per-batch copies, so the batch sequence is the host re-batching's
    (``dataset.slice_batches``). A table whose single batch exceeds the
    cap (fat rows) goes per batch.
    """
    bs = dataset.batch_size
    carry: List[Tuple[List[np.ndarray], np.ndarray]] = []
    carry_rows = 0

    def flush_carry():
        pieces_f = [np.concatenate([p[0][i] for p in carry], axis=0)
                    for i in range(len(carry[0][0]))]
        pieces_l = np.concatenate([p[1] for p in carry], axis=0)
        return _transfer(converter, (pieces_f, pieces_l), epoch)

    tables = dataset.iter_tables()
    emitted = False  # anything put() or carried yet this epoch
    for table in tables:
        with trace_span("table_convert", kind="convert", epoch=epoch):
            features, label = converter.convert(table)
        n = table.num_rows
        if any(f.shape[0] != n for f in features) or label.shape[0] != n:
            # The spec's reshape repacks the sample dimension (a flat
            # column with feature_shape=(4,)), so a whole table converts
            # into other groups of rows than a batch does. An "auto"
            # construction falls back to per-batch copies (the same grid,
            # via slice_batches) for good; an explicit device_rebatch=True
            # fails loudly.
            if converter.device_rebatch_auto and not emitted:
                logger.warning(
                    "device_rebatch (auto) disabled: the column spec "
                    "repacks the sample dimension; using per-batch "
                    "transfers")
                converter.device_rebatch = False
                for batch_table in slice_batches(
                        itertools.chain([table], tables), bs,
                        dataset.drop_last):
                    if not put(("batch", epoch, _convert_transfer(
                            converter, batch_table, epoch))):
                        return False
                return True
            raise ValueError(
                "device_rebatch requires specs whose converted arrays keep "
                "one sample per table row; a feature_shape/label_shape "
                "repacks the sample dimension here. Construct with "
                "device_rebatch=False for this spec.")
        if n:
            emitted = True
        offset = 0
        if carry_rows:
            take = min(bs - carry_rows, n)
            carry.append(([f[:take] for f in features], label[:take]))
            carry_rows += take
            offset = take
            if carry_rows == bs:
                if not put(("batch", epoch, flush_carry())):
                    return False
                carry, carry_rows = [], 0
        full_batches = (n - offset) // bs
        if full_batches:
            row_bytes = (sum(a.nbytes for a in features) + label.nbytes) // n
            batch_bytes = max(1, row_bytes * bs)
            # At most (prefetch_size + 2) chunks are on the device at once
            # (queued, being copied, being consumed). The cap is re-read
            # every chunk: a stall halves it and, under "degrade", clears
            # device_rebatch, so the rest of this table and every later
            # one moves per batch.
            done = 0  # full batches already emitted from this table
            while done < full_batches and converter.device_rebatch:
                k = min(_MAX_CHUNK_BATCHES,
                        converter.max_table_bytes // batch_bytes)
                if k < 1:
                    break  # fat rows: per-batch copies bound the residency
                nb = min(k, full_batches - done)
                lo = offset + done * bs
                hi = lo + nb * bs
                with trace_span("table_transfer", kind="device_transfer",
                                epoch=epoch):
                    staged = _supervised_transfer_table(
                        converter,
                        ([f[lo:hi] for f in features], label[lo:hi]),
                        nb, bs, queue_depth)
                if not put(("table", epoch, staged)):
                    return False
                done += nb
            for b in range(done, full_batches):
                lo = offset + b * bs
                if not put(("batch", epoch, _transfer(
                        converter, ([f[lo:lo + bs] for f in features],
                                    label[lo:lo + bs]), epoch))):
                    return False
            offset += full_batches * bs
        if offset < n:
            carry.append(([f[offset:] for f in features], label[offset:]))
            carry_rows += n - offset
    if carry_rows and not dataset.drop_last:
        if not put(("batch", epoch, flush_carry())):
            return False
    return True


def _release_producer(stop: threading.Event, out: "_queue.Queue") -> None:
    """Finalizer of a dropped DeviceShufflingDataset: stop the producer and
    drop its buffered device items."""
    stop.set()
    try:
        while True:
            out.get_nowait()
    except _queue.Empty:
        pass


class DeviceShufflingDataset:
    """Shuffled ``(features, label)`` batches on a torch device.

    ``device=None`` means ``torch.device("cuda")`` and raises without
    CUDA; ``device="cpu"`` yields CPU tensors. ``drop_last`` defaults to
    True (fixed shapes). Spec'd columns are cast at the map stage when
    this dataset launches the shuffle; with an external ``batch_queue``
    the caller passes :func:`make_cast_transform` as the
    ``map_transform`` of :func:`dataset.create_batch_queue_and_shuffle`
    (and its own ``reduce_transform``, e.g. the image decode).
    ``start_epoch`` starts the shuffle at that epoch (a resumed run).

    The JAX package's constructor arguments that this binding gives
    meaning to (defaults are the JAX package's, untuned for the card):

    - ``prefetch_size``: items (batches or bulk chunks) kept ready ahead
      of the consumer (2: double buffering).
    - ``stack_features``: yield the features as ONE ``(B, F)`` tensor,
      concatenated on the device; needs one feature dtype and scalar (or
      ``(1,)``-shaped) features.
    - ``persistent_prefetch``: one producer thread for all epochs, which
      rolls into epoch N+1 while the consumer trains on epoch N, so the
      epoch boundary costs the consumer no pipeline refill. Epochs must be
      iterated in order from ``start_epoch`` (``set_epoch`` raises
      otherwise); an epoch left mid-way counts as consumed. False: a
      fresh producer per epoch, any epoch order.
    - ``device_rebatch``: the bulk binding (module docstring); ``"auto"``
      is bulk on CUDA with ``persistent_prefetch``, per-batch on the CPU.
      An explicit True needs ``persistent_prefetch`` and is allowed on
      the CPU.
    - ``max_device_input_bytes``: device bytes of the bulk pipeline, which
      holds at most about ``prefetch_size + 2`` chunks, so the per-chunk
      cap is ``max_device_input_bytes // (prefetch_size + 2)``.
    - ``max_device_table_bytes``: an explicit per-chunk cap instead.
    - ``shuffle_kwargs``: the shuffle engine's arguments, for the shuffle
      this dataset launches (``file_cache``, ``max_inflight_bytes``,
      ``spill_dir``, ``task_retries``, ``on_bad_file``, ``num_workers``,
      ``executor_backend``, ``collect_stats``; see
      ``dataset.ShufflingDataset``). A reducer output that the budget
      spilled is mapped back from its file as it is popped; being no
      pinned memory, it takes the staging copy as any table does.
    - ``runtime_policy``: explicit values for ``runtime/policy.py`` keys
      (``device_rebatch``, ``watchdog``, ``bulk_transfer_deadline_s``,
      ``stall_action``, ``device_double_buffer``, ``retry_*``); the rest
      resolve through ``RSDL_DEVICE_DATASET_<KEY>`` and ``RSDL_<KEY>``.
    """

    def __init__(self, filenames: Sequence[str], num_epochs: Optional[int],
                 num_trainers: int, batch_size: int, rank: int,
                 feature_columns: List[Any] = None,
                 feature_shapes: Optional[List[Any]] = None,
                 feature_types: Optional[List[Any]] = None,
                 label_column: Any = None,
                 label_shape: Optional[int] = None,
                 label_type: Optional[Any] = None,
                 drop_last: bool = True,
                 num_reducers: Optional[int] = None,
                 max_concurrent_epochs: int = 2,
                 batch_queue=None, shuffle_result=None,
                 seed: int = 0, device=None, reduce_transform=None,
                 start_epoch: int = 0,
                 prefetch_size: int = 2,
                 stack_features: bool = False,
                 persistent_prefetch: bool = True,
                 device_rebatch="auto",
                 max_device_input_bytes: int = 1 << 30,
                 max_device_table_bytes: Optional[int] = None,
                 runtime_policy: Optional[dict] = None,
                 **shuffle_kwargs):
        self.device = resolve_device(device)
        spec = _normalize_data_spec(feature_columns, feature_shapes,
                                    feature_types, label_column, label_shape,
                                    label_type)
        (self._feature_columns, self._feature_shapes, self._feature_types,
         self._label_column, self._label_shape, self._label_type) = spec
        if stack_features:
            if len(set(self._feature_types)) != 1:
                raise ValueError(
                    "stack_features requires identical feature dtypes, got "
                    f"{self._feature_types}")
            for shape in self._feature_shapes:
                if shape is not None and tuple(shape) != (1,):
                    raise ValueError(
                        "stack_features requires scalar (or (1,)-shaped) "
                        f"feature columns, got shape {shape}")
        # Resolved and checked BEFORE the ShufflingDataset exists: it
        # launches the background shuffle, which must not leak when the
        # configuration is invalid.
        policy = rt_policy.resolve_all("device_dataset",
                                       **(runtime_policy or {}))
        if device_rebatch == "auto" and policy["device_rebatch"] is False:
            device_rebatch = False
        device_rebatch_auto = device_rebatch == "auto"
        if device_rebatch_auto:
            device_rebatch = (persistent_prefetch
                              and self.device.type == "cuda")
        elif device_rebatch and not persistent_prefetch:
            raise ValueError(
                "device_rebatch requires persistent_prefetch=True")
        device_rebatch = bool(device_rebatch)
        map_transform = None
        if label_column is not None:
            map_transform = make_cast_transform(
                self._feature_columns, self._feature_types,
                self._label_column, self._label_type)
        self._dataset = ShufflingDataset(
            filenames, num_epochs, num_trainers, batch_size, rank,
            drop_last=drop_last, num_reducers=num_reducers,
            max_concurrent_epochs=max_concurrent_epochs,
            batch_queue=batch_queue, shuffle_result=shuffle_result,
            seed=seed, map_transform=map_transform,
            reduce_transform=reduce_transform, start_epoch=start_epoch,
            **shuffle_kwargs)
        self._prefetch_size = max(1, prefetch_size)
        if max_device_table_bytes is None:
            max_device_table_bytes = max(
                1, max_device_input_bytes // (self._prefetch_size + 2))
        # The watchdog supervises only the bulk path: a per-batch copy is
        # small, and the consumer's get is interruptible by close().
        wd = (rt_watchdog.get_watchdog()
              if policy["watchdog"] and device_rebatch else None)
        self._converter = _BatchConverter(
            spec, self.device, stack_features, self._prefetch_size + 1,
            device_rebatch=device_rebatch,
            device_rebatch_auto=device_rebatch_auto,
            max_table_bytes=max_device_table_bytes, watchdog=wd,
            bulk_transfer_deadline_s=policy["bulk_transfer_deadline_s"],
            stall_action=policy["stall_action"],
            double_buffer=bool(policy["device_double_buffer"]),
            transfer_retry=rt_retry.RetryPolicy.for_component(
                "device_dataset", retryable=rt_retry.transient_retryable,
                **{k: v for k, v in policy.items()
                   if k.startswith("retry_")}))
        #: The binding resolved at construction ("bulk" or "per_batch");
        #: ``transfer_stats()["fallback_engaged"]`` says if a stall or
        #: the spec later dropped the bulk one.
        self.binding = "bulk" if device_rebatch else "per_batch"
        # The delivery-latency loop closed at the device boundary: the
        # delivered->device and birth->device hops per source table and
        # this rank's freshness gauge.
        self._converter.latency_probe = rt_latency.LatencyProbe(
            queue=str(rank))
        self.batch_wait_stats = BatchWaitStats()
        # Persistent-prefetch state (one producer thread for ALL epochs).
        self._persistent = persistent_prefetch
        self._lock = threading.Lock()
        self._out: Optional[_queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pending_skips: dict = {}   # epoch -> skip_batches (pre-start)
        self._scheduled_skips: dict = {}  # epoch -> skip already producer-side
        self._started_epochs: set = set()  # epochs the producer entered
        self._consumer_skip = 0          # batches to drop client-side
        self._next_epoch = self._dataset.start_epoch  # next to consume
        self._epoch_set = False          # set_epoch called since last iter
        self._closed = False             # close() is terminal
        self._active_gen = None          # live persistent-epoch generator

    @property
    def batch_size(self) -> int:
        return self._dataset.batch_size

    @property
    def seed(self) -> int:
        return self._dataset.seed

    @property
    def num_epochs(self) -> Optional[int]:
        """The trial's epoch count; None for a stream."""
        return self._dataset.num_epochs

    @property
    def shuffle_result(self):
        """The shuffle's result (``dataset.ShufflingDataset``): its
        duration, or its ``TrialStats`` with ``collect_stats``."""
        return self._dataset.shuffle_result

    def transfer_stats(self) -> Dict[str, Any]:
        """Copies per epoch (per-batch, bulk, and the bulk chunks' sizes
        in batches), the peak device bytes of the input pipeline (items
        staged, queued or being consumed) and of one chunk, the chunk cap,
        the peak pinned host bytes, and whether a stall or the spec
        dropped the bulk binding."""
        c = self._converter
        with c._lock:
            copies = {epoch: {**counts,
                              "chunk_batches": dict(counts["chunk_batches"])}
                      for epoch, counts in c.copies.items()}
            peak_device, peak_chunk = c.peak_device_bytes, c.peak_chunk_bytes
        return {
            "binding": self.binding,
            "fallback_engaged": c.fallback_engaged,
            "copies_by_epoch": copies,
            "peak_device_bytes": peak_device,
            "peak_chunk_bytes": peak_chunk,
            "max_table_bytes": c.max_table_bytes,
            "peak_pinned_bytes": (c._stager.peak_pinned_bytes
                                  if c._stager is not None else 0),
        }

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Declare the epoch about to be iterated; ``skip_batches`` drops
        its first N batches (checkpoint resume). With
        ``persistent_prefetch`` epochs go in order, and a skip set before
        the producer enters the epoch happens at the Arrow level."""
        if not self._persistent:
            self._dataset.set_epoch(epoch, skip_batches=skip_batches)
            return
        if skip_batches < 0:
            raise ValueError(f"skip_batches must be >= 0, got {skip_batches}")
        # Validate BEFORE finalizing any in-flight iterator, so an illegal
        # call leaves the current epoch resumable. A suspended (mid-epoch)
        # iterator's epoch counts as consumed once finalized below, so the
        # expected argument is one past it.
        gen_state = (inspect.getgeneratorstate(self._active_gen)
                     if self._active_gen is not None else None)
        if gen_state == inspect.GEN_RUNNING:
            raise RuntimeError(
                "set_epoch called while another thread is iterating "
                "this dataset")
        expected = (self._next_epoch + 1
                    if gen_state == inspect.GEN_SUSPENDED
                    else self._next_epoch)
        if epoch != expected:
            raise ValueError(
                f"persistent_prefetch requires sequential epochs: expected "
                f"set_epoch({expected}), got set_epoch({epoch}). "
                "Construct with persistent_prefetch=False for out-of-order "
                "epoch iteration.")
        if self._active_gen is not None:
            # Finalize the previous epoch's iterator now (a consumer that
            # broke out mid-epoch without closing it must not depend on
            # GC timing): its finally marks that epoch consumed.
            try:
                self._active_gen.close()
            except ValueError:
                # The other thread resumed the generator in between.
                raise RuntimeError(
                    "set_epoch called while another thread is iterating "
                    "this dataset")
            self._active_gen = None
        # The lock guards only the skip maps shared with the producer;
        # _consumer_skip belongs to the consumer thread.
        with self._lock:
            if epoch in self._started_epochs:
                # The producer already ran (or is running) this epoch:
                # drop the first batches client-side, less what an earlier
                # set_epoch for this epoch had skipped at the Arrow level.
                already = self._scheduled_skips.get(epoch, 0)
                consumer_skip = max(0, skip_batches - already)
            else:
                # The producer will skip at the Arrow level, before any
                # conversion or copy. The two maps move together, so a
                # repeated or reduced skip neither drops twice nor leaves
                # a stale pending skip.
                if skip_batches:
                    self._pending_skips[epoch] = skip_batches
                else:
                    self._pending_skips.pop(epoch, None)
                self._scheduled_skips[epoch] = skip_batches
                consumer_skip = 0
        self._consumer_skip = consumer_skip
        self._epoch_set = True

    def __iter__(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        """Yield this epoch's ``(features, label)`` batches; a producer
        thread keeps ``prefetch_size`` items ready ahead."""
        if self._persistent:
            gen = self._iter_persistent()
            self._active_gen = gen
            return gen
        return self._iter_single_epoch()

    def _arrive(self, staged: _Staged) -> None:
        """Make the consumer's stream wait for ``staged``'s copy, once, and
        keep its memory alive until that stream's use of it."""
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            for t in staged.tensors():
                t.record_stream(stream)

    # -- persistent (cross-epoch) producer ---------------------------------

    def _iter_persistent(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        if self._closed:
            raise RuntimeError(
                "DeviceShufflingDataset was closed; the persistent producer "
                "cannot restart (it has already consumed the shuffle "
                "queue). Construct a new dataset to iterate again.")
        if not self._epoch_set:
            raise ValueError(
                "call set_epoch() before iterating each epoch")
        self._epoch_set = False
        epoch = self._next_epoch
        converter = self._converter
        if self._thread is None:
            self._out = _queue.Queue(maxsize=self._prefetch_size)
            # The producer references the ShufflingDataset and the
            # converter but NOT self, so a dataset dropped without close()
            # is collected and this finalizer releases the thread (and its
            # buffered device items).
            self._thread = threading.Thread(
                target=_persistent_producer,
                args=(self._dataset, converter, self._out, self._stop,
                      self._lock, self._pending_skips, self._started_epochs),
                daemon=True, name="rsdl-torch-prefetch")
            weakref.finalize(self, _release_producer, self._stop, self._out)
            self._thread.start()
        held: Optional[_Staged] = None
        handed_t = None  # when the last batch was handed out (yielded)
        try:
            while True:
                converter.release(held)
                held = None
                wait_start = timeit.default_timer()
                if handed_t is not None:
                    # The gap between handing out a batch and this get is
                    # the consumer's own work: the train_step stage.
                    rt_telemetry.record("train_step", epoch=epoch,
                                        dur_s=wait_start - handed_t,
                                        t=wait_start)
                    handed_t = None
                item = self._out.get()
                wait_s = timeit.default_timer() - wait_start
                self.batch_wait_stats.record(wait_s)
                rt_telemetry.record("batch_wait", epoch=epoch, dur_s=wait_s)
                if isinstance(item, BaseException):
                    raise item
                kind, item_epoch, staged = item
                if item_epoch < epoch:
                    # Remnants of an epoch left mid-way: copied in vain,
                    # dropped for correctness.
                    converter.release(staged)
                    continue
                if kind == "end":
                    rt_telemetry.epoch_complete(epoch, source="device")
                    break
                held = staged
                if kind == "table":
                    # A bulk chunk: its later batches record zero wait (they
                    # are on the device already). The first carve is
                    # supervised, the carve half of the bulk path's
                    # liveness contract.
                    start = min(self._consumer_skip, staged.n_batches)
                    self._consumer_skip -= start
                    bs = self._dataset.batch_size
                    wd = converter.watchdog
                    for b in range(start, staged.n_batches):
                        if b > start:
                            now = timeit.default_timer()
                            self.batch_wait_stats.record(0.0)
                            rt_telemetry.record("batch_wait", epoch=epoch,
                                                dur_s=0.0, t=now)
                            if handed_t is not None:
                                rt_telemetry.record(
                                    "train_step", epoch=epoch,
                                    dur_s=now - handed_t, t=now)
                                handed_t = None
                            batch = converter.slice_batch(staged, b, bs)
                        elif wd is not None:
                            with wd.watch(
                                    "device_dataset.bulk_carve",
                                    deadline_s=(converter
                                                .bulk_transfer_deadline_s),
                                    on_stall=converter._on_bulk_stall):
                                self._arrive(staged)
                                batch = converter.slice_batch(staged, b, bs)
                        else:
                            self._arrive(staged)
                            batch = converter.slice_batch(staged, b, bs)
                        handed_t = timeit.default_timer()
                        yield batch
                    continue
                if self._consumer_skip:
                    self._consumer_skip -= 1
                    continue
                self._arrive(staged)
                handed_t = timeit.default_timer()
                yield staged.features, staged.label
        finally:
            # Runs on completion AND when the epoch is left mid-way: the
            # epoch counts as consumed (the producer has pulled its tables
            # off the shuffle queue), so the next legal call is
            # set_epoch(epoch + 1); its leftovers are dropped above. A
            # leftover skip must not eat the next epoch.
            converter.release(held)
            self._consumer_skip = 0
            self._next_epoch = epoch + 1
            # Break the wrapper -> generator -> frame -> wrapper cycle, so
            # the epoch's last batch is freed without a cycle collection.
            self._active_gen = None

    def close(self) -> None:
        """Stop the persistent producer and drop its buffered items.

        Needed only when abandoning the dataset before its last epoch;
        the producer ends on its own after the final one. Idempotent and
        terminal: iterating after close() raises, and a consumer blocked
        on its next batch gets an error instead of hanging.
        """
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            # Join BEFORE draining: the producer sees the stop event
            # within one bounded put (0.1 s), so nothing refills the queue
            # between the drain and the error put below.
            self._thread.join(timeout=5)
            self._thread = None
        if self._out is not None:
            try:
                while True:
                    self._out.get_nowait()
            except _queue.Empty:
                pass
            try:
                self._out.put_nowait(
                    RuntimeError("DeviceShufflingDataset was closed while "
                                 "the epoch was still being iterated"))
            except _queue.Full:
                pass  # unreachable after the join and drain above
        self._active_gen = None

    # -- per-epoch producer (persistent_prefetch=False) --------------------

    def _iter_single_epoch(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        out: _queue.Queue = _queue.Queue(maxsize=self._prefetch_size)
        stop = threading.Event()
        done = object()
        converter = self._converter

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        epoch = self._dataset._epoch

        def producer() -> None:
            converter.epoch = epoch
            try:
                if _produce_epoch_batches(self._dataset, converter, epoch,
                                          lambda item: put(item[2])):
                    put(done)
            except BaseException as e:  # noqa: BLE001 - forwarded
                put(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="rsdl-torch-prefetch")
        thread.start()
        held: Optional[_Staged] = None
        handed_t = None
        try:
            while True:
                converter.release(held)
                held = None
                wait_start = timeit.default_timer()
                if handed_t is not None:
                    rt_telemetry.record("train_step", epoch=epoch,
                                        dur_s=wait_start - handed_t,
                                        t=wait_start)
                    handed_t = None
                item = out.get()
                wait_s = timeit.default_timer() - wait_start
                self.batch_wait_stats.record(wait_s)
                rt_telemetry.record("batch_wait", epoch=epoch, dur_s=wait_s)
                if item is done:
                    if epoch is not None:
                        rt_telemetry.epoch_complete(epoch, source="device")
                    break
                if isinstance(item, BaseException):
                    raise item
                held = item
                self._arrive(item)
                handed_t = timeit.default_timer()
                yield item.features, item.label
        finally:
            # Done or left mid-epoch: release the producer (it would block
            # on the bounded queue, pinning device items) and drop what it
            # buffered.
            converter.release(held)
            stop.set()
            try:
                while True:
                    out.get_nowait()
            except _queue.Empty:
                pass
            thread.join(timeout=5)


def batch_digest(features, label) -> torch.Tensor:
    """``(2, C)`` int64 on the batch's device: for each column of the
    batch (each feature tensor, then the label), the sums of its 32-bit
    words' low and high 16 bits, each weighted by row position (1..B).
    Exact (no sum can pass 2**63), so two streams are equal batch for
    batch exactly where their digests are."""
    tensors = features if isinstance(features, list) else [features]
    cols = []
    for t in tensors + [label]:
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        cols.append(t.reshape(t.shape[0], -1).to(torch.int64) & 0xFFFFFFFF)
    x = torch.cat(cols, dim=1)
    w = torch.arange(1, x.shape[0] + 1, device=x.device,
                     dtype=torch.int64)[:, None]
    return torch.stack([(w * (x & 0xFFFF)).sum(0), (w * (x >> 16)).sum(0)])
