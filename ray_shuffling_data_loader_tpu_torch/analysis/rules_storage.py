"""Storage-plane discipline.

Every dataset byte the pipeline reads is supposed to flow through
``storage/`` — the tiered (shm -> disk -> remote) cache, the
``storage_read``/``storage_stall`` chaos sites and the retry policy all
live at that boundary. A raw ``pyarrow.parquet`` read somewhere else
still works against a local filesystem, so nothing fails until the
dataset moves to a remote backend and that one code path silently reads
cold, uncached, un-injectable and un-retried. ``raw-dataset-read``
closes the hole from the producer side: library code opens datasets via
``storage.read_table`` / ``storage.open_parquet`` (or the ``fileio``
primitive the storage plane itself is built on), never ``pq.*``
directly.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, register)

#: ``pyarrow.parquet`` entry points that materialize dataset bytes.
_PQ_READERS = frozenset({"read_table", "read_pandas", "ParquetFile",
                         "ParquetDataset", "read_schema", "read_metadata"})
#: Receiver tails that name the pyarrow.parquet module (``pq``,
#: ``parquet``, ``pyarrow.parquet``, ``pa.parquet``).
_PQ_RECEIVERS = frozenset({"pq", "parquet", "pyarrow.parquet",
                           "pa.parquet"})


@register
class RawDatasetReadRule(Rule):
    id = "raw-dataset-read"
    category = "storage"
    description = ("dataset read bypasses storage/ — a raw "
                   "`pyarrow.parquet` call skips the tiered cache, the "
                   "`storage_read`/`storage_stall` chaos sites and the "
                   "storage retry policy, so it silently reads cold and "
                   "unprotected the day the dataset moves to a remote "
                   "backend; go through `storage.read_table` / "
                   "`storage.open_parquet` (or utils/fileio inside the "
                   "storage plane)")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.dataset_read_globs):
            return
        if ctx.path_matches(ctx.config.dataset_read_exempt_globs):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in _PQ_READERS):
                continue
            receiver = dotted_name(func.value)
            if receiver not in _PQ_RECEIVERS:
                continue
            yield ctx.violation(
                self, node,
                f"raw `{receiver}.{func.attr}` bypasses the storage "
                "plane — route dataset reads through storage."
                "read_table / storage.open_parquet so they hit the "
                "tiered cache, the chaos sites and the retry policy")
