"""Load the JAX package's DLRM parameters into the port.

The JAX pytree is ``{"embeddings": {"table_i": (V, E)}, "top": {"w{i}":
(d_in, d_out), "b{i}": (d_out,)}, ["bottom": ...]}``. The port stores MLP
weights in the same ``(d_in, d_out)`` layout (``x @ w + b``), so the
mapping is a rename with no transpose.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_shuffling_data_loader_tpu_torch.models.dlrm import DLRMConfig


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def from_jax_params(config: DLRMConfig,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``DLRM`` state dict for a JAX parameter pytree (numpy
    leaves). Raises on a missing, extra or mis-shaped entry."""
    state = {name: torch.from_numpy(np.array(value, dtype=np.float32))
             for name, value in _flatten(params_np)}
    expected = {f"embeddings.table_{i}": (v, config.embed_dim)
                for i, v in enumerate(config.vocab_sizes)}
    branches = [("top", config.top_in_dim, config.top_hidden, 1)]
    if config.dense_dim > 0:
        branches.append(("bottom", config.dense_dim, config.bottom_hidden,
                         config.embed_dim))
    for prefix, d_in, hidden, d_out in branches:
        dims = (d_in, *hidden, d_out)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            expected[f"{prefix}.w{i}"] = (a, b)
            expected[f"{prefix}.b{i}"] = (b,)
    if set(state) != set(expected):
        raise ValueError(
            f"parameter names differ: missing "
            f"{sorted(set(expected) - set(state))}, extra "
            f"{sorted(set(state) - set(expected))}")
    for name, shape in expected.items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(state[name].shape)}, "
                             f"expected {shape}")
    return state
