"""Synthetic DLRM-style Parquet data, from a seed.

The schema is the JAX package's ``data_generation.DATA_SPEC``: 17 int64
embedding-index columns with Criteo-like cardinalities, 2 small categorical
columns, a float64 label in ``[0, 1)``, and a globally unique ``key``
column. :func:`generate_table`'s bytes differ from the JAX generator's
(plain seeded numpy); the parity tests feed both packages the same files.
:func:`generate_row_group` is the JAX package's generator, column for
column (the native xoshiro256** fills, seeded per column): the drifting
click stream (``workloads.dlrm_criteo``) is built on it, so a seed gives
the JAX package's files.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

# Column spec: name -> (low, high, dtype).
DATA_SPEC = {
    "embeddings_name0": (0, 2385, np.int64),
    "embeddings_name1": (0, 201, np.int64),
    "embeddings_name2": (0, 201, np.int64),
    "embeddings_name3": (0, 6, np.int64),
    "embeddings_name4": (0, 19, np.int64),
    "embeddings_name5": (0, 1441, np.int64),
    "embeddings_name6": (0, 201, np.int64),
    "embeddings_name7": (0, 22, np.int64),
    "embeddings_name8": (0, 156, np.int64),
    "embeddings_name9": (0, 1216, np.int64),
    "embeddings_name10": (0, 9216, np.int64),
    "embeddings_name11": (0, 88999, np.int64),
    "embeddings_name12": (0, 941792, np.int64),
    "embeddings_name13": (0, 9405, np.int64),
    "embeddings_name14": (0, 83332, np.int64),
    "embeddings_name15": (0, 828767, np.int64),
    "embeddings_name16": (0, 945195, np.int64),
    "one_hot0": (0, 3, np.int64),
    "one_hot1": (0, 50, np.int64),
    "labels": (0, 1, np.float64),
}

EMBEDDING_COLUMNS = [c for c in DATA_SPEC if c.startswith("embeddings")]
ONE_HOT_COLUMNS = [c for c in DATA_SPEC if c.startswith("one_hot")]
FEATURE_COLUMNS = EMBEDDING_COLUMNS + ONE_HOT_COLUMNS
LABEL_COLUMN = "labels"
KEY_COLUMN = "key"


def generate_table(first_row: int, num_rows: int, seed: int) -> pa.Table:
    """``num_rows`` rows whose keys start at ``first_row``; deterministic in
    ``(seed, first_row)``."""
    rng = np.random.Generator(np.random.Philox(
        np.random.SeedSequence([seed, first_row])))
    columns = {KEY_COLUMN: np.arange(first_row, first_row + num_rows,
                                     dtype=np.int64)}
    for col, (low, high, dtype) in DATA_SPEC.items():
        if np.issubdtype(dtype, np.integer):
            columns[col] = rng.integers(low, high, size=num_rows,
                                        dtype=np.int64)
        else:
            columns[col] = low + (high - low) * rng.random(num_rows)
    return pa.table(columns)


def generate_row_group(global_row_index: int, num_rows: int,
                       seed: int = 0) -> pa.Table:
    """The JAX package's ``generate_row_group(_, global_row_index,
    num_rows, seed)``: keys from ``global_row_index``, each column filled
    by the native generator from ``(seed * 1_000_003 + global_row_index) *
    53 + column index``."""
    from ray_shuffling_data_loader_tpu_torch import native
    columns = {KEY_COLUMN: np.arange(global_row_index,
                                     global_row_index + num_rows,
                                     dtype=np.int64)}
    for col_index, (col, (low, high, dtype)) in enumerate(DATA_SPEC.items()):
        col_seed = (seed * 1_000_003 + global_row_index) * 53 + col_index
        if np.issubdtype(dtype, np.integer):
            columns[col] = low + native.fill_random_int64(num_rows,
                                                          high - low,
                                                          col_seed)
        else:
            columns[col] = low + (high - low) * native.fill_random_double(
                num_rows, col_seed)
    return pa.table(columns)


def generate_data(num_rows: int, num_files: int, data_dir: str,
                  seed: int = 0, num_row_groups_per_file: int = 1
                  ) -> Tuple[List[str], int]:
    """Write ``num_rows`` rows over ``num_files`` snappy Parquet files of
    ``num_row_groups_per_file`` row groups each; returns ``(paths,
    in-memory bytes)``. Each file is written under a temporary name and
    renamed into place, so processes that generate the same files into one
    directory at once (the ranks of a one-machine world) never read a
    partial file."""
    os.makedirs(data_dir, exist_ok=True)
    rows_per_file = max(1, num_rows // num_files)
    filenames, nbytes = [], 0
    for file_index, start in enumerate(range(0, num_rows, rows_per_file)):
        n = min(rows_per_file, num_rows - start)
        table = generate_table(start, n, seed)
        path = os.path.join(data_dir,
                            f"input_data_{file_index}.parquet.snappy")
        tmp = f"{path}.{os.getpid()}.tmp"
        pq.write_table(table, tmp, compression="snappy",
                       row_group_size=-(-n // num_row_groups_per_file))
        os.replace(tmp, path)
        filenames.append(path)
        nbytes += table.nbytes
    return filenames, nbytes
