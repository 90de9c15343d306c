"""Map-time row transforms the process pool ships to its workers: they
pickle by reference to this module, which imports NumPy and pyarrow only,
so a worker that unpickles one loads no torch."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import pyarrow as pa


class CastTransform:
    """Map-time cast of spec'd numeric, null-free columns to their final
    dtypes (an unchecked ``ndarray.astype``), before any shuffling."""

    __slots__ = ("targets",)

    #: Per-row and row-count preserving: the streaming map
    #: (``shuffle._fused_stream_columns``) may apply it per record batch
    #: instead of per file, with the same bytes either way.
    row_elementwise = True

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
