"""DLRM click-log workload: per-column narrow index dtypes.

Casting each index column to the narrowest signed integer dtype that
covers its cardinality at the map stage shrinks every downstream byte
(partition, permute-gather, re-batch, host-to-device copy) from 76 to 43
bytes per row for the reference schema; the device widens the indices.
"""

from __future__ import annotations

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
