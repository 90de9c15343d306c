"""Workload recipes: a seeded synthetic data generator plus the column spec
that wires the workload into ``DeviceShufflingDataset``.

- ``dlrm_criteo``: the DLRM click-log schema with narrow index dtypes.
- ``bert_mlm``: BERT MLM on pre-tokenized sequence Parquet, with masking
  on the device.
- ``imagenet``: encoded-image Parquet, decoded inside the shuffle's
  reducers, for ResNet.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, List, Tuple


def _file_plan(num_rows: int, num_files: int):
    """``(file_index, global_row_index, rows_in_file)`` covering all rows:
    ``max(1, num_rows // num_files)`` rows per file, the last file taking
    what is left (the JAX package's stride arithmetic)."""
    rows_per_file = max(1, num_rows // num_files)
    plan = []
    for file_index, start in enumerate(range(0, num_rows, rows_per_file)):
        plan.append((file_index, start, min(rows_per_file, num_rows - start)))
    return plan


def generate_shards(write_file: Callable[[int, int, int], Tuple[str, int]],
                    total_rows: int, num_files: int
                    ) -> Tuple[List[str], int]:
    """Fan ``write_file(file_index, global_row_index, num_rows) -> (path,
    nbytes)`` out over a thread pool (one thread per host core) along
    :func:`_file_plan`; returns the paths in file order and the total
    bytes."""
    plan = _file_plan(total_rows, num_files)
    with cf.ThreadPoolExecutor(max_workers=min(len(plan), os.cpu_count() or 1),
                               thread_name_prefix="rsdl-gen") as pool:
        results = list(pool.map(lambda p: write_file(*p), plan))
    filenames, sizes = zip(*results)
    return list(filenames), sum(sizes)
