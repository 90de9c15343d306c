"""BERT-MLM workload: pre-tokenized sequence Parquet -> sequence batches.

Rows are fixed-length token sequences stored as ``FixedSizeList<int32>``
columns. The shuffle moves whole rows and ``DeviceShufflingDataset`` turns
each batch into a ``(batch, seq_len)`` int32 tensor. Masking is dynamic and
on the device: :func:`mlm_mask` draws with an explicit ``torch.Generator``
on the tokens' device and applies the BERT 80/10/10 rule
(:func:`apply_mlm_rule`), so every epoch sees fresh masks at no host cost.

The generated files are byte-for-byte those of the JAX package's
``workloads/bert_mlm.py`` for the same seed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from ray_shuffling_data_loader_tpu_torch import workloads
from ray_shuffling_data_loader_tpu_torch.models.bert import IGNORE_ID

TOKENS_COLUMN = "input_ids"
LABEL_COLUMN = "label"
KEY_COLUMN = "key"

# Special-token ids of the synthetic vocab: [PAD]=0, [CLS]=1, [SEP]=2,
# [MASK]=3; real corpora pass their own ids to mlm_mask.
PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
MASK_ID = 3
NUM_SPECIAL_TOKENS = 4


def generate_file(file_index: int, global_row_index: int, num_rows: int,
                  data_dir: str, seq_len: int, vocab_size: int,
                  seed: int) -> Tuple[str, int]:
    """One snappy Parquet shard of ``[CLS] body... [SEP]`` token rows, an
    int64 zero ``label`` and an int64 ``key``; returns ``(path, nbytes)``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, file_index]))
    tokens = rng.integers(NUM_SPECIAL_TOKENS, vocab_size,
                          size=(num_rows, seq_len), dtype=np.int32)
    tokens[:, 0] = CLS_ID
    tokens[:, -1] = SEP_ID
    table = pa.table({
        TOKENS_COLUMN: pa.FixedSizeListArray.from_arrays(
            pa.array(tokens.reshape(-1)), seq_len),
        LABEL_COLUMN: np.zeros(num_rows, dtype=np.int64),
        KEY_COLUMN: np.arange(global_row_index, global_row_index + num_rows,
                              dtype=np.int64),
    })
    filename = os.path.join(data_dir,
                            f"tokenized_shard_{file_index}.parquet.snappy")
    pq.write_table(table, filename, compression="snappy")
    return filename, table.nbytes


def generate_tokenized_parquet(num_sequences: int,
                               num_files: int,
                               data_dir: str,
                               seq_len: int = 128,
                               vocab_size: int = 30522,
                               seed: int = 0) -> Tuple[List[str], int]:
    """``num_sequences`` seeded token rows over ``num_files`` shards."""
    os.makedirs(data_dir, exist_ok=True)

    def write_file(file_index: int, start: int, n: int) -> Tuple[str, int]:
        return generate_file(file_index, start, n, data_dir, seq_len,
                             vocab_size, seed)

    return workloads.generate_shards(write_file, num_sequences, num_files)


def apply_mlm_rule(tokens: torch.Tensor, select_u: torch.Tensor,
                   action_u: torch.Tensor, random_tokens: torch.Tensor,
                   mask_prob: float = 0.15, mask_token_id: int = MASK_ID,
                   num_special_tokens: int = NUM_SPECIAL_TOKENS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BERT 80/10/10 rule on given draws -> ``(inputs, targets)``.

    A position is selected where ``select_u < mask_prob`` and its token is
    not special (``>= num_special_tokens``). A selected position becomes
    ``mask_token_id`` where ``action_u < 0.8``, ``random_tokens`` where
    ``action_u >= 0.9``, and keeps its token in between. ``targets`` holds
    the original token where selected and ``IGNORE_ID`` elsewhere.
    """
    selected = (select_u < mask_prob) & (tokens >= num_special_tokens)
    mask_token = torch.full_like(tokens, mask_token_id)
    inputs = torch.where(
        selected & (action_u < 0.8), mask_token,
        torch.where(selected & (action_u >= 0.9), random_tokens, tokens))
    targets = torch.where(selected, tokens, torch.full_like(tokens,
                                                            IGNORE_ID))
    return inputs, targets


def mlm_mask(tokens: torch.Tensor, generator: torch.Generator,
             vocab_size: int, mask_prob: float = 0.15,
             mask_token_id: int = MASK_ID,
             num_special_tokens: int = NUM_SPECIAL_TOKENS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic MLM masking on the tokens' device: three draws from
    ``generator`` (which must live on that device) fed to
    :func:`apply_mlm_rule`."""
    kw = {"generator": generator, "device": tokens.device}
    select_u = torch.rand(tokens.shape, **kw)
    action_u = torch.rand(tokens.shape, **kw)
    random_tokens = torch.randint(num_special_tokens, vocab_size,
                                  tokens.shape, dtype=tokens.dtype, **kw)
    return apply_mlm_rule(tokens, select_u, action_u, random_tokens,
                          mask_prob, mask_token_id, num_special_tokens)


def bert_mlm_spec(seq_len: int) -> Dict[str, Any]:
    """``DeviceShufflingDataset`` kwargs for the tokenized-sequence layout:
    ``(batch, seq_len)`` int32 tokens, int32 labels."""
    return {
        "feature_columns": [TOKENS_COLUMN],
        "feature_shapes": [(seq_len,)],
        "feature_types": [np.int32],
        "label_column": LABEL_COLUMN,
        "label_type": np.int32,
    }
