"""The Torch binding: shuffled batches as ``(List[Tensor], Tensor)`` on
the host.

The port's copy of the JAX package's ``torch_dataset.py``: a
``torch.utils.data.IterableDataset`` over :class:`dataset.ShufflingDataset`
whose column spec (feature columns, shapes and dtypes, and the label) is
normalized with the same rules and exception types, each column
converted by ``device_dataset._column_to_numpy`` (object and list columns
included) and ``torch.as_tensor``, then viewed as ``(-1, *shape)`` or
``(-1, 1)``.

It is a host binding: batches are CPU tensors and the trainer moves them
(``batch.to("cuda")``). The device binding, which lands batches on the
card itself (whole reducer tables copied in chunks), is
``device_dataset.DeviceShufflingDataset``.

The constructor takes the JAX package's arguments with their meaning:
``max_batch_queue_size`` bounds each queue of the shuffle that rank 0
launches, ``queue_name`` names that queue so that the datasets of the
other ranks in the process read theirs from it, and ``num_workers``,
``file_cache``, ``max_inflight_bytes`` and ``spill_dir`` go to the
shuffle. With a ``batch_queue`` from ``create_batch_queue_and_shuffle``
those configure nothing (the queue's shuffle has its own).

``python -m ray_shuffling_data_loader_tpu_torch.torch_dataset`` runs the
binding over generated data and prints the rows per second.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.data import IterableDataset

from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    _column_to_numpy)

#: The numpy dtype each supported torch dtype converts through.
_TORCH_TO_NUMPY = {
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


def _normalize_torch_data_spec(feature_columns=None,
                               feature_shapes=None,
                               feature_types=None,
                               label_column=None,
                               label_shape=None,
                               label_type=None):
    """Scalars become lists; shape and type lists must match the feature
    count (``ValueError``); a type must be a ``torch.dtype``
    (``TypeError``) of :data:`_TORCH_TO_NUMPY` (``ValueError``); types
    default to ``torch.float``."""
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
        for dtype in feature_types:
            if not isinstance(dtype, torch.dtype):
                raise TypeError(
                    "All values in feature_types should be torch.dtype "
                    f"instances, got {type(dtype)}")
            if dtype not in _TORCH_TO_NUMPY:
                raise ValueError(
                    f"Unsupported feature dtype {dtype}; supported: "
                    f"{sorted(map(str, _TORCH_TO_NUMPY))}")
    else:
        feature_types = [torch.float] * len(feature_columns)
    if not label_type:
        label_type = torch.float
    if label_type not in _TORCH_TO_NUMPY:
        raise ValueError(
            f"Unsupported label dtype {label_type}; supported: "
            f"{sorted(map(str, _TORCH_TO_NUMPY))}")
    return (feature_columns, feature_shapes, feature_types, label_column,
            label_shape, label_type)


def convert_to_tensor(table, feature_columns: List[Any],
                      feature_shapes: List[Any],
                      feature_types: List[torch.dtype], label_column: Any,
                      label_shape: Optional[int], label_type: torch.dtype):
    """Arrow batch -> ``(List[Tensor], Tensor)``: each feature viewed as
    ``(-1, *shape)`` (default ``(-1, 1)``), the label as
    ``(-1, label_shape)`` (default ``(-1, 1)``). A column already of its
    dtype is not copied."""
    feature_tensor = []
    for col, shape, dtype in zip(feature_columns, feature_shapes,
                                 feature_types):
        arr = _column_to_numpy(table.column(col), col,
                               np.dtype(_TORCH_TO_NUMPY[dtype]))
        t = torch.as_tensor(arr, dtype=dtype)
        if shape is not None:
            t = t.view(*(-1, *shape))
        else:
            t = t.view(-1, 1)
        feature_tensor.append(t)
    label_arr = _column_to_numpy(table.column(label_column), label_column,
                                 np.dtype(_TORCH_TO_NUMPY[label_type]))
    label_tensor = torch.as_tensor(label_arr, dtype=label_type)
    if label_shape:
        label_tensor = label_tensor.view(-1, label_shape)
    else:
        label_tensor = label_tensor.view(-1, 1)
    return feature_tensor, label_tensor


class TorchShufflingDataset(IterableDataset):
    """``IterableDataset`` of ``(List[Tensor], Tensor)`` CPU batches of
    exactly ``batch_size`` rows (the last one partial unless
    ``drop_last``). Call :meth:`set_epoch` before each epoch."""

    def __init__(self,
                 filenames: Sequence[str],
                 num_epochs: int,
                 num_trainers: int,
                 batch_size: int,
                 rank: int,
                 feature_columns: List[Any] = None,
                 feature_shapes: Optional[List[Any]] = None,
                 feature_types: Optional[List[torch.dtype]] = None,
                 label_column: Any = None,
                 label_shape: Optional[int] = None,
                 label_type: Optional[torch.dtype] = None,
                 drop_last: bool = False,
                 num_reducers: Optional[int] = None,
                 max_concurrent_epochs: int = 2,
                 batch_queue=None,
                 shuffle_result=None,
                 max_batch_queue_size: int = 0,
                 seed: int = 0,
                 num_workers: Optional[int] = None,
                 queue_name: str = "MultiQueue",
                 file_cache="auto",
                 max_inflight_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        super().__init__()
        # Checked before a shuffle starts: a bad spec launches nothing.
        self._spec = _normalize_torch_data_spec(
            feature_columns, feature_shapes, feature_types, label_column,
            label_shape, label_type)
        engine = {} if batch_queue is not None else dict(
            num_workers=num_workers, file_cache=file_cache,
            max_inflight_bytes=max_inflight_bytes, spill_dir=spill_dir)
        self._dataset = ShufflingDataset(
            filenames, num_epochs, num_trainers, batch_size, rank,
            drop_last=drop_last, num_reducers=num_reducers,
            max_concurrent_epochs=max_concurrent_epochs,
            batch_queue=batch_queue, shuffle_result=shuffle_result,
            seed=seed, max_batch_queue_size=max_batch_queue_size,
            queue_name=queue_name, **engine)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Declare the epoch about to be iterated; ``skip_batches`` drops
        its first N batches (checkpoint resume: the shuffle is seeded, so
        the epoch replays) as zero-copy Arrow slices, never converted."""
        self._dataset.set_epoch(epoch, skip_batches=skip_batches)

    def __iter__(self):
        for table in self._dataset:
            yield convert_to_tensor(table, *self._spec)


if __name__ == "__main__":
    import argparse
    import tempfile
    import timeit

    from ray_shuffling_data_loader_tpu_torch import data_generation as dg
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir

    parser = argparse.ArgumentParser(
        description="TorchShufflingDataset smoke run")
    parser.add_argument("--num-rows", type=int, default=10**6)
    parser.add_argument("--num-files", type=int, default=10)
    parser.add_argument("--num-epochs", type=int, default=4)
    parser.add_argument("--num-reducers", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=50_000)
    args = parser.parse_args()

    with tempfile.TemporaryDirectory() as tmpdir:
        print(f"Generating {args.num_rows} rows over {args.num_files} files.")
        filenames, _ = dg.generate_data(args.num_rows, args.num_files,
                                        tmpdir)
        feature_columns = list(dg.FEATURE_COLUMNS)
        start = timeit.default_timer()
        ds = TorchShufflingDataset(
            filenames,
            args.num_epochs,
            num_trainers=1,
            batch_size=args.batch_size,
            rank=0,
            num_reducers=args.num_reducers,
            feature_columns=feature_columns,
            feature_types=[torch.long] * len(feature_columns),
            label_column=dg.LABEL_COLUMN,
            label_type=torch.double)
        for epoch in plan_ir.epoch_range(0, args.num_epochs):
            ds.set_epoch(epoch)
            rows = batches = 0
            for features, label in ds:
                assert len(features) == len(feature_columns)
                batches += 1
                rows += label.shape[0]
            assert rows == args.num_rows, (rows, args.num_rows)
            print(f"epoch {epoch}: {batches} batches, {rows} rows")
        duration = timeit.default_timer() - start
        total = args.num_epochs * args.num_rows
        print(f"Done: {total} rows in {duration:.2f}s "
              f"({total / duration:,.0f} rows/s)")
