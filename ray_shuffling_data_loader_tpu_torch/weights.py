"""Load the JAX package's DLRM, BERT and ResNet parameters into the port.

The DLRM pytree is ``{"embeddings": {"table_i": (V, E)}, "top": {"w{i}":
(d_in, d_out), "b{i}": (d_out,)}, ["bottom": ...]}``; the BERT pytree is
``{"token_emb", "pos_emb", "emb_ln": {"scale", "bias"}, "layer_{i}": {...},
"mlm_bias"}``. The port stores weights in the same ``(d_in, d_out)`` layout
(``x @ w + b``) under the same nested names, so the mapping is a flatten
with no transpose. The ResNet pytree is flat (``stem_conv``,
``s{i}b{j}_conv1``, ``s{i}b{j}_gn1: {"scale", "bias"}``, ..., ``fc_w``,
``fc_b``); its conv kernels go from HWIO to the port's OIHW, and ``fc_w``
keeps its ``(cin, num_classes)`` layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ray_shuffling_data_loader_tpu_torch.models.bert import BertConfig
from ray_shuffling_data_loader_tpu_torch.models.dlrm import DLRMConfig
from ray_shuffling_data_loader_tpu_torch.models.resnet import ResNetConfig


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


def resnet_from_jax_params(config: ResNetConfig, params_np: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The port's ``ResNet`` state dict for a JAX parameter pytree (numpy
    leaves): conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``), the
    rest as they are. Raises on a missing, extra or mis-shaped entry."""
    expected = {"stem_conv": (config.width, 3, 7, 7),
                "stem_gn.scale": (config.width,),
                "stem_gn.bias": (config.width,)}
    cin = config.width
    for stage, num_blocks in enumerate(config.stage_sizes):
        cmid = config.width * (2 ** stage)
        cout = cmid * 4
        for block in range(num_blocks):
            name = f"s{stage}b{block}"
            convs = [("conv1", "gn1", cin, cmid, 1),
                     ("conv2", "gn2", cmid, cmid, 3),
                     ("conv3", "gn3", cmid, cout, 1)]
            if block == 0:
                convs.append(("proj", "proj_gn", cin, cout, 1))
            for conv, gn, c_in, c_out, k in convs:
                expected[f"{name}_{conv}"] = (c_out, c_in, k, k)
                expected[f"{name}_{gn}.scale"] = (c_out,)
                expected[f"{name}_{gn}.bias"] = (c_out,)
            cin = cout
    expected["fc_w"] = (cin, config.num_classes)
    expected["fc_b"] = (config.num_classes,)
    converted = {
        key: (np.asarray(value).transpose(3, 2, 0, 1)
              if np.ndim(value) == 4 else value)
        for key, value in params_np.items()}
    return _state_dict(converted, expected)
