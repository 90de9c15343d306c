"""DLRM-style recommendation model (counterpart of the JAX package's
``models/dlrm.py``).

One embedding table per sparse feature, looked up through
``ops.embedding.lookup_features`` (on the card, the tables above
``ONE_HOT_MAX_VOCAB`` go through one launch of the CUDA gather kernel);
the dot interaction (strict upper triangle of the ``F x F`` Gram matrix)
plus the mean embedding feed the top MLP. Parameters are float32,
compute is ``compute_dtype``, logits are float32.

Tensor parallelism (:func:`param_specs`, ``parallel.tp``): every table is
split on its columns, so each rank gathers ``(B, E/tp)`` vectors from its
blocks (one launch of the gather kernel on the card); the Gram matrix, a
sum over E, is each rank's partial ``(B, F, F)`` product in f32, summed by
``reduce_from_model`` and rounded to the compute dtype once, as the JAX
package's single product is (bf16 products are exact in f32, so the two
differ only in the f32 summation order: an entry may land one bf16 ulp,
2^-8 relative, apart where its sum falls beside a rounding boundary);
the mean embedding is gathered over the model axis;
a dense branch's replicated ``(B, E)`` output is cut to this rank's
columns; the MLPs are Megatron layers (``models.mlp``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_shuffling_data_loader_tpu_torch.models import mlp
from ray_shuffling_data_loader_tpu_torch.models.mlp import MLP
from ray_shuffling_data_loader_tpu_torch.ops import embedding
from ray_shuffling_data_loader_tpu_torch.parallel import tp as tpar
from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device

# The reference DATA_SPEC's categorical cardinalities: 17 embedding
# columns + 2 one-hots, 2,912,607 rows in all.
DATA_SPEC_VOCAB_SIZES: Tuple[int, ...] = (
    2385, 201, 201, 6, 19, 1441, 201, 22, 156, 1216, 9216, 88999, 941792,
    9405, 83332, 828767, 945195, 3, 50)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: Tuple[int, ...] = DATA_SPEC_VOCAB_SIZES
    embed_dim: int = 32
    dense_dim: int = 0  # the reference schema has no dense features
    bottom_hidden: Tuple[int, ...] = (64,)
    top_hidden: Tuple[int, ...] = (512, 256)
    compute_dtype: torch.dtype = torch.bfloat16
    lookup_mode: str = "auto"

    @property
    def num_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def num_interacting(self) -> int:
        return self.num_sparse + (1 if self.dense_dim > 0 else 0)

    @property
    def interaction_dim(self) -> int:
        n = self.num_interacting
        return n * (n - 1) // 2

    @property
    def top_in_dim(self) -> int:
        # The dense branch's vector, or the mean embedding without one.
        return self.interaction_dim + self.embed_dim


#: The DLRM width bench.py trains by default (``mlperf``): all 19 tables,
#: embed 128, top MLP (1024, 1024, 512, 256), bf16 compute.
MLPERF = DLRMConfig(embed_dim=128, top_hidden=(1024, 1024, 512, 256))


def param_specs(config: DLRMConfig, model_axis: str = "model"
                ) -> Dict[str, Tuple]:
    """The JAX package's layout: each table split on its embedding dim over
    ``model_axis``, the MLPs Megatron-parallel (``mlp.param_specs``)."""
    specs: Dict[str, Tuple] = {f"embeddings.table_{i}": (None, model_axis)
                               for i in range(config.num_sparse)}
    branches = [("top", (config.top_in_dim, *config.top_hidden, 1))]
    if config.dense_dim > 0:
        branches.insert(0, ("bottom", (config.dense_dim,
                                       *config.bottom_hidden,
                                       config.embed_dim)))
    for prefix, dims in branches:
        for name, spec in mlp.param_specs(dims, model_axis).items():
            specs[f"{prefix}.{name}"] = spec
    return specs


class DLRM(nn.Module):
    """Parameters: ``embeddings.table_{i}`` ``(V_i, E)`` ~ N(0, 1/E),
    ``top.w{i}``/``top.b{i}`` (and ``bottom.*`` with dense features).
    ``device=None`` means CUDA and raises without it."""

    tp: Optional[tpar.ModelParallel] = None

    def __init__(self, config: DLRMConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        scale = 1.0 / math.sqrt(config.embed_dim)
        self.embeddings = nn.ParameterDict({
            f"table_{i}": nn.Parameter(
                torch.randn((vocab, config.embed_dim), generator=generator,
                            device=device) * scale)
            for i, vocab in enumerate(config.vocab_sizes)})
        if config.dense_dim > 0:
            self.bottom = MLP(config.dense_dim, config.bottom_hidden,
                              config.embed_dim, config.compute_dtype,
                              device=device, generator=generator)
        self.top = MLP(config.top_in_dim, config.top_hidden, 1,
                       config.compute_dtype, device=device,
                       generator=generator)
        iu, ju = torch.triu_indices(config.num_interacting,
                                    config.num_interacting, offset=1,
                                    device=device)
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)

    def forward(self, dense: Optional[torch.Tensor], sparse) -> torch.Tensor:
        """``sparse`` is a ``(B, num_sparse)`` index tensor or a list of
        per-feature ``(B,)``/``(B, 1)`` index tensors (what
        ``DeviceShufflingDataset`` yields). Returns ``(B, 1)`` f32
        logits."""
        config = self.config
        dtype = config.compute_dtype
        mp = self.tp
        if mp is not None:
            mp.require({f"embeddings.table_{i}": 1
                        for i in range(config.num_sparse)})
        is_columns = isinstance(sparse, (list, tuple))
        if is_columns and len(sparse) != config.num_sparse:
            raise ValueError(
                f"expected {config.num_sparse} sparse columns, got "
                f"{len(sparse)}")
        vectors = embedding.lookup_features(
            [self.embeddings[f"table_{i}"] for i in range(config.num_sparse)],
            [sparse[i].reshape(-1) if is_columns else sparse[:, i]
             for i in range(config.num_sparse)],
            dtype, mode=config.lookup_mode)
        if config.dense_dim > 0:
            vectors.append(tpar.scatter_to_model(
                self.bottom(dense).to(dtype), mp, -1))
        stacked = torch.stack(vectors, dim=1)  # (B, F, E) or (B, F, E/tp)
        if mp is None:
            gram = torch.bmm(stacked, stacked.transpose(1, 2))  # (B, F, F)
        else:
            part = stacked.float()
            gram = tpar.reduce_from_model(
                torch.bmm(part, part.transpose(1, 2)), mp).to(dtype)
        interactions = gram[:, self._iu, self._ju]
        first_order = tpar.gather_from_model(stacked.mean(dim=1), mp, -1)
        top_in = torch.cat([interactions, first_order], dim=1).to(dtype)
        return self.top(top_in)


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE-with-logits, in the JAX package's form."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(model: DLRM, dense: Optional[torch.Tensor], sparse,
            labels: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(model(dense, sparse), labels)


def validate_sparse_batch(config: DLRMConfig, sparse) -> None:
    """Host-side bounds check of a sparse batch in either layout: the model
    clamps out-of-range indices, so run this to surface a broken
    pipeline loudly."""
    def host(a) -> np.ndarray:
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    if isinstance(sparse, (list, tuple)):
        if len(sparse) != config.num_sparse:
            raise ValueError(
                f"expected {config.num_sparse} sparse columns, got "
                f"{len(sparse)}")
        columns: Sequence[np.ndarray] = [host(c).reshape(-1) for c in sparse]
    else:
        arr = host(sparse)
        if arr.shape[-1] != config.num_sparse:
            raise ValueError(
                f"expected {config.num_sparse} sparse features, got "
                f"{arr.shape[-1]}")
        columns = [arr[:, i] for i in range(config.num_sparse)]
    for i, (col, vocab) in enumerate(zip(columns, config.vocab_sizes)):
        lo, hi = col.min(), col.max()
        if lo < 0 or hi >= vocab:
            raise ValueError(
                f"sparse feature {i} has indices in [{lo}, {hi}] "
                f"outside vocab [0, {vocab})")
