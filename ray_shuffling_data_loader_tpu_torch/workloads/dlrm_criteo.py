"""DLRM click-log workload: per-column narrow index dtypes, and online
training over a drifting click stream.

Casting each index column to the narrowest signed integer dtype that
covers its cardinality at the map stage shrinks every downstream byte
(partition, permute-gather, re-batch, host-to-device copy) from 76 to 43
bytes per row for the reference schema; the device widens the indices.

Click logs are the unbounded input of online training: the click-through
rate drifts as campaigns rotate, and a model trained on a frozen snapshot
decays. :func:`generate_drifting_stream` writes DLRM-schema files whose
click rate drifts sinusoidally with the file's stream position (the JAX
package's files, table for table), and :func:`run_online_training`
reads them through a ``streaming.StreamingShuffleRunner``, one sealed
window per epoch, updating an :class:`OnlineCTRModel` per reducer table.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ray_shuffling_data_loader_tpu_torch import data_generation as dg


def narrowest_dtype(cardinality: int) -> np.dtype:
    """Smallest signed integer dtype that represents [0, cardinality)."""
    if cardinality <= 2**7:
        return np.dtype(np.int8)
    if cardinality <= 2**15:
        return np.dtype(np.int16)
    if cardinality <= 2**31:
        return np.dtype(np.int32)
    return np.dtype(np.int64)


def dlrm_feature_types(columns: Optional[List[str]] = None
                       ) -> List[np.dtype]:
    """Narrowest dtype per feature column of the reference DATA_SPEC."""
    if columns is None:
        columns = list(dg.FEATURE_COLUMNS)
    return [narrowest_dtype(dg.DATA_SPEC[c][1]) for c in columns]


def dlrm_spec() -> Dict[str, Any]:
    """``DeviceShufflingDataset`` kwargs for the DLRM schema: one
    per-column feature list with narrow dtypes, float32 labels."""
    return {
        "feature_columns": list(dg.FEATURE_COLUMNS),
        "feature_types": dlrm_feature_types(),
        "label_column": dg.LABEL_COLUMN,
        "label_type": np.float32,
    }


# ---------------------------------------------------------------------------
# The drifting click stream: online training
# ---------------------------------------------------------------------------


def drifting_ctr(file_index: int, drift_period: float = 8.0,
                 base: float = 0.25, amplitude: float = 0.2) -> float:
    """The true click-through rate at stream position ``file_index``: a
    slow sinusoid (campaign rotation)."""
    return base + amplitude * math.sin(
        2.0 * math.pi * file_index / drift_period)


def generate_drifting_click_file(file_index: int, num_rows: int,
                                 data_dir: str, seed: int = 0,
                                 drift_period: float = 8.0) -> str:
    """One stream file: ``data_generation.generate_row_group`` rows from
    key ``file_index * num_rows``, the labels replaced by Bernoulli draws
    at :func:`drifting_ctr` from ``Philox(SeedSequence([seed,
    file_index]))``; snappy, one row group. Deterministic in ``(seed,
    file_index)``."""
    from ray_shuffling_data_loader_tpu_torch.utils import fileio
    table = dg.generate_row_group(file_index * num_rows, num_rows,
                                  seed=seed)
    ctr = drifting_ctr(file_index, drift_period)
    rng = np.random.Generator(np.random.Philox(
        np.random.SeedSequence([seed, file_index])))
    labels = (rng.random(num_rows) < ctr).astype(np.float64)
    table = table.set_column(table.schema.get_field_index(dg.LABEL_COLUMN),
                             dg.LABEL_COLUMN, [labels])
    filename = fileio.join(data_dir,
                           f"clicks_{file_index:05d}.parquet.snappy")
    fileio.write_parquet(table, filename, compression="snappy",
                         row_group_size=num_rows)
    return filename


def generate_drifting_stream(num_files: int, rows_per_file: int,
                             data_dir: str, seed: int = 0,
                             drift_period: float = 8.0) -> List[str]:
    """The whole drifting stream, in arrival order."""
    from ray_shuffling_data_loader_tpu_torch.utils import fileio
    fileio.makedirs(data_dir)
    return [generate_drifting_click_file(i, rows_per_file, data_dir,
                                         seed=seed,
                                         drift_period=drift_period)
            for i in range(num_files)]


class OnlineCTRModel:
    """Bias-only logistic regression trained by online SGD: the smallest
    model whose single logit has to keep moving to follow the drift."""

    def __init__(self, lr: float = 0.5):
        self.lr = float(lr)
        self.logit = 0.0
        self.steps = 0

    def predict(self) -> float:
        return 1.0 / (1.0 + math.exp(-self.logit))

    def update(self, labels: np.ndarray) -> None:
        """One SGD step on a batch: the gradient of the mean log loss in
        the logit is ``predict() - mean(labels)``."""
        if labels.size == 0:
            return
        self.logit += self.lr * (float(np.mean(labels)) - self.predict())
        self.steps += 1


def run_online_training(files: List[str], num_windows: int,
                        files_per_window: int = 2, seed: int = 0,
                        num_reducers: int = 2,
                        journal_path: Optional[str] = None,
                        lr: float = 0.5) -> List[Dict[str, Any]]:
    """Online training over a drifting click stream, end to end: a seeded
    ``SyntheticEventSource`` over ``files``, ``files_per_window``-file
    windows, each shuffled as an epoch, one :class:`OnlineCTRModel` step
    per reducer table. Returns one record per window, ``{"window",
    "observed_ctr", "estimate"}``: the window's label mean and the model
    after it. Deterministic in ``(files, seed)``."""
    from ray_shuffling_data_loader_tpu_torch import streaming as st

    model = OnlineCTRModel(lr=lr)
    per_epoch: Dict[int, Dict[str, float]] = {}
    history: List[Dict[str, Any]] = []

    def consumer(rank, epoch, refs):
        if refs is None:
            stats = per_epoch.pop(epoch, {"clicks": 0.0, "rows": 0.0})
            rows = max(1.0, stats["rows"])
            history.append({
                "window": epoch,
                "observed_ctr": stats["clicks"] / rows,
                "estimate": model.predict(),
            })
            return
        for ref in refs:
            table = ref.result() if hasattr(ref, "result") else ref
            labels = np.asarray(
                table.column(dg.LABEL_COLUMN).combine_chunks())
            model.update(labels)
            stats = per_epoch.setdefault(epoch,
                                         {"clicks": 0.0, "rows": 0.0})
            stats["clicks"] += float(labels.sum())
            stats["rows"] += float(labels.size)

    source = st.SyntheticEventSource(
        files, seed=seed, total_events=num_windows * files_per_window)
    # One window at a time: the model's updates must follow the stream's
    # order to mean anything.
    runner = st.StreamingShuffleRunner(
        source, consumer, num_reducers=num_reducers, num_trainers=1,
        seed=seed, max_concurrent_epochs=1,
        policy=st.WindowPolicy(max_files=files_per_window),
        journal_path=journal_path)
    runner.run()
    history.sort(key=lambda rec: rec["window"])
    return history
