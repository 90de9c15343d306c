"""PyTorch device binding: shuffled batches as device-resident tensors.

Counterpart of the JAX package's ``JaxShufflingDataset`` (per-batch path).
A column spec (names, shapes, dtypes of the features plus a label column)
is normalised with the same rules; spec'd columns are cast to their final
(narrow) dtypes at the map stage, before the shuffle; each exact-size
batch becomes ``(list of feature tensors, label)``, each ``(B, *shape)``
(default ``(B, 1)``; a fixed-size list column of width W gives
``(B, W)``, or ``(B, H, W, C)`` for a feature shape ``(H, W, C)``, as
decoded images are).

On CUDA a prefetch thread converts each batch to numpy, copies it into a
ring of pinned host buffers and issues ``to(device, non_blocking=True)``
on a dedicated copy stream, where int8/int16 columns are also widened to
int32 (on the device: the narrow bytes are what cross the bus). uint8
columns (image pixels) stay uint8 on the device, as the JAX package keeps
them: a quarter of f32's bytes, and the model casts them. The
consumer's stream waits on the batch's CUDA event, so the copy of batch
N+1 overlaps the training on batch N. On the CPU the same stream comes out
as CPU tensors. ``batch_wait_stats`` records how long the consumer was
blocked on each batch.
"""

from __future__ import annotations

import queue as _queue
import threading
import timeit
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.shuffle import column_to_rows
from ray_shuffling_data_loader_tpu_torch.stats import BatchWaitStats
from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device


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
    """Arrow column -> contiguous ndarray of ``dtype``, ``(B,)`` or, for a
    fixed-size list column, ``(B, W)`` (:func:`shuffle.column_to_rows`)."""
    arr = column_to_rows(column, name)
    return np.ascontiguousarray(arr.astype(dtype, copy=False))


class CastTransform:
    """Map-time cast of spec'd numeric, null-free columns to their final
    dtypes (an unchecked ``ndarray.astype``), before any shuffling."""

    __slots__ = ("targets",)

    def __init__(self, targets):
        self.targets = {k: np.dtype(v) for k, v in targets.items()}

    def __call__(self, table: pa.Table) -> pa.Table:
        columns = []
        changed = False
        for field in table.schema:
            col = table.column(field.name)
            target = self.targets.get(field.name)
            if (target is not None and col.null_count == 0
                    and (pa.types.is_integer(field.type)
                         or pa.types.is_floating(field.type))
                    and np.issubdtype(target, np.number)
                    and pa.from_numpy_dtype(target) != field.type):
                col = pa.array(col.combine_chunks().to_numpy(
                    zero_copy_only=False).astype(target, copy=False))
                changed = True
            columns.append(col)
        if not changed:
            return table
        return pa.table(columns, names=table.column_names)


def make_cast_transform(feature_columns: Sequence[Any],
                        feature_types: Sequence[np.dtype],
                        label_column: Any,
                        label_type: np.dtype) -> CastTransform:
    targets = dict(zip(feature_columns, feature_types))
    targets[label_column] = label_type
    return CastTransform(targets)


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

#: Batches staged ahead of the consumer (double buffering).
PREFETCH = 2


def _widen(t: torch.Tensor) -> torch.Tensor:
    """int8/int16 -> int32 (the DLRM indices); anything else, uint8
    pixels included, unchanged."""
    return t.to(torch.int32) if t.dtype in _NARROW_INTS else t


class _CudaStager:
    """Pinned host ring + dedicated copy stream for host-to-device copies.

    Slot ``k`` holds one pinned buffer per array; before a slot is
    refilled, the producer waits on the event of the copy that last read
    it, so a pinned buffer is never overwritten while a DMA reads it.
    """

    def __init__(self, device: torch.device, num_slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots: List[Tuple[List[torch.Tensor], Optional[Any]]] = [
            ([], None) for _ in range(num_slots)]
        self.next = 0

    def _pinned(self, buffers: List[torch.Tensor], i: int,
                arr: np.ndarray) -> torch.Tensor:
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        if i == len(buffers):
            buffers.append(torch.empty(0, dtype=dtype))
        buf = buffers[i]
        if tuple(buf.shape) != arr.shape or buf.dtype != dtype:
            buf = buffers[i] = torch.empty(arr.shape, dtype=dtype,
                                           pin_memory=True)
        np.copyto(buf.numpy(), arr)
        return buf

    def stage(self, arrays: List[np.ndarray]):
        """Copy ``arrays`` to the device; returns ``(tensors, event)``."""
        buffers, event = self.slots[self.next]
        if event is not None:
            event.synchronize()
        pinned = [self._pinned(buffers, i, a) for i, a in enumerate(arrays)]
        with torch.cuda.stream(self.stream):
            out = [_widen(p.to(self.device, non_blocking=True))
                   for p in pinned]
            event = torch.cuda.Event()
            event.record(self.stream)
        self.slots[self.next] = (buffers, event)
        self.next = (self.next + 1) % len(self.slots)
        return out, event


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
    ``PREFETCH`` batches are kept ready ahead of the consumer.
    """

    def __init__(self, filenames: Sequence[str], num_epochs: int,
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
                 start_epoch: int = 0):
        self.device = resolve_device(device)
        (self._feature_columns, self._feature_shapes, self._feature_types,
         self._label_column, self._label_shape, self._label_type) = (
             _normalize_data_spec(feature_columns, feature_shapes,
                                  feature_types, label_column, label_shape,
                                  label_type))
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
            reduce_transform=reduce_transform, start_epoch=start_epoch)
        self._stager = (_CudaStager(self.device, PREFETCH + 1)
                        if self.device.type == "cuda" else None)
        self.batch_wait_stats = BatchWaitStats()

    @property
    def batch_size(self) -> int:
        return self._dataset.batch_size

    @property
    def seed(self) -> int:
        return self._dataset.seed

    @property
    def num_epochs(self) -> int:
        return self._dataset.num_epochs

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        self._dataset.set_epoch(epoch, skip_batches=skip_batches)

    def _convert(self, table: pa.Table):
        return convert_to_arrays(
            table, self._feature_columns, self._feature_shapes,
            self._feature_types, self._label_column, self._label_shape,
            self._label_type)

    def _to_device(self, table: pa.Table):
        """One Arrow batch -> ``(features, label, event_or_None)``."""
        features, label = self._convert(table)
        if self._stager is None:
            tensors = [_widen(torch.from_numpy(np.array(a)).to(self.device))
                       for a in features + [label]]
            return tensors[:-1], tensors[-1], None
        tensors, event = self._stager.stage(features + [label])
        return tensors[:-1], tensors[-1], event

    def __iter__(self) -> Iterator[Tuple[List[torch.Tensor], torch.Tensor]]:
        """Yield this epoch's ``(features, label)`` batches; a producer
        thread keeps ``PREFETCH`` of them staged ahead."""
        out: _queue.Queue = _queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for table in self._dataset:
                    if not put(self._to_device(table)):
                        return
                put(done)
            except BaseException as e:  # forwarded to the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="rsdl-torch-prefetch")
        thread.start()
        return self._consume(out, stop, done, thread)

    def _consume(self, out: _queue.Queue, stop: threading.Event, done,
                 thread: threading.Thread):
        try:
            while True:
                wait_start = timeit.default_timer()
                item = out.get()
                self.batch_wait_stats.record(
                    timeit.default_timer() - wait_start)
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                features, label, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for t in features + [label]:
                        t.record_stream(stream)
                yield features, label
        finally:
            stop.set()
            thread.join(timeout=5)
