"""Load the JAX package's DLRM and BERT parameters into the port.

The DLRM pytree is ``{"embeddings": {"table_i": (V, E)}, "top": {"w{i}":
(d_in, d_out), "b{i}": (d_out,)}, ["bottom": ...]}``; the BERT pytree is
``{"token_emb", "pos_emb", "emb_ln": {"scale", "bias"}, "layer_{i}": {...},
"mlm_bias"}``. The port stores weights in the same ``(d_in, d_out)`` layout
(``x @ w + b``) under the same nested names, so the mapping is a flatten
with no transpose.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ray_shuffling_data_loader_tpu_torch.models.bert import BertConfig
from ray_shuffling_data_loader_tpu_torch.models.dlrm import DLRMConfig


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def _state_dict(params_np: Mapping[str, Any],
                expected: Dict[str, Tuple[int, ...]]
                ) -> Dict[str, torch.Tensor]:
    """Flattened f32 tensors of ``params_np``; raises on a missing, extra
    or mis-shaped entry."""
    state = {name: torch.from_numpy(np.array(value, dtype=np.float32))
             for name, value in _flatten(params_np)}
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


def from_jax_params(config: DLRMConfig,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``DLRM`` state dict for a JAX parameter pytree (numpy
    leaves). Raises on a missing, extra or mis-shaped entry."""
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
    return _state_dict(params_np, expected)


def bert_from_jax_params(config: BertConfig, params_np: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``Bert`` state dict for a JAX parameter pytree (numpy
    leaves). Raises on a missing, extra or mis-shaped entry."""
    h, f = config.hidden_dim, config.ffn_dim
    expected = {"token_emb": (config.vocab_size, h),
                "pos_emb": (config.max_seq_len, h),
                "emb_ln.scale": (h,), "emb_ln.bias": (h,),
                "mlm_bias": (config.vocab_size,)}
    layer = {"qkv_w": (h, 3 * h), "qkv_b": (3 * h,),
             "attn_out_w": (h, h), "attn_out_b": (h,),
             "ln1.scale": (h,), "ln1.bias": (h,),
             "ffn_in_w": (h, f), "ffn_in_b": (f,),
             "ffn_out_w": (f, h), "ffn_out_b": (h,),
             "ln2.scale": (h,), "ln2.bias": (h,)}
    for i in range(config.num_layers):
        for name, shape in layer.items():
            expected[f"layer_{i}.{name}"] = shape
    return _state_dict(params_np, expected)
