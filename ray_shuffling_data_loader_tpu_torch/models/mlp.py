"""Tabular MLP: float32 parameters, compute in ``compute_dtype``, float32
output logits (counterpart of the JAX package's ``models/mlp.py``).

Weights are stored ``(d_in, d_out)`` and applied as ``x @ w + b``, the JAX
package's layout, so its parameters load without a transpose
(``weights.from_jax_params``).

Tensor parallelism (:func:`param_specs`, ``parallel.tp``): a layer whose
weight is split on its output dimension is column-parallel (its input
through ``copy_to_model``, its bias split too, its output a block of
columns); one split on its input dimension is row-parallel (the partial
products summed by ``reduce_from_model`` before the replicated bias); a
replicated layer takes the whole activation, gathered where the layer
before left it split.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ray_shuffling_data_loader_tpu_torch.parallel import tp as tpar
from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device


def param_specs(dims: Sequence[int], model_axis: str = "model"
                ) -> Dict[str, Tuple]:
    """The JAX package's Megatron layout for an MLP of layer widths
    ``dims`` (``MLP.dims``: input, hidden..., output): even layers split
    their output dimension (and bias) over ``model_axis``, odd layers their
    input dimension, and the last layer is replicated."""
    specs: Dict[str, Tuple] = {}
    n_layers = len(dims) - 1
    for i in range(n_layers):
        if i == n_layers - 1:
            specs[f"w{i}"], specs[f"b{i}"] = (None, None), (None,)
        elif i % 2 == 0:
            specs[f"w{i}"], specs[f"b{i}"] = (None, model_axis), (model_axis,)
        else:
            specs[f"w{i}"], specs[f"b{i}"] = (model_axis, None), (None,)
    return specs


class MLP(nn.Module):
    """``len(hidden_dims) + 1`` affine layers, ReLU between them.
    Parameters ``w{i}`` ``(d_in, d_out)`` are He-initialised from
    ``generator``; biases ``b{i}`` start at zero. ``device=None`` means
    CUDA and raises without it. After ``parallel.tp.shard_module_``
    (``tp`` set), the forward runs each layer by its spec."""

    tp: Optional[tpar.ModelParallel] = None

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 out_dim: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.dims = (in_dim, *hidden_dims, out_dim)
        self.num_layers = len(self.dims) - 1
        for i, (d_in, d_out) in enumerate(zip(self.dims[:-1],
                                              self.dims[1:])):
            w = torch.randn((d_in, d_out), generator=generator,
                            device=device) * math.sqrt(2.0 / d_in)
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(
                f"b{i}", nn.Parameter(torch.zeros(d_out, device=device)))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = features.to(dtype)
        split = False  # x's last dimension is this rank's block
        for i in range(self.num_layers):
            w = getattr(self, f"w{i}").to(dtype)
            b = getattr(self, f"b{i}").to(dtype)
            if self.tp is None:
                x = x @ w + b
            else:
                x, split = self._tp_layer(i, x, w, b, split)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        if split:
            x = tpar.gather_from_model(x, self.tp, -1)
        return x.to(torch.float32)

    def _tp_layer(self, i: int, x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, split: bool):
        """Layer ``i`` by its spec; returns its output and whether that is
        split on its last dimension."""
        mp = self.tp
        dim = mp.dims[f"w{i}"]
        mp.require({f"b{i}": 0 if dim == 1 else None})
        if dim == 1:  # column-parallel
            if split:
                x = tpar.gather_from_model(x, mp, -1)
            return tpar.copy_to_model(x, mp) @ w + b, True
        if dim == 0:  # row-parallel
            if not split:
                x = tpar.scatter_to_model(x, mp, -1)
            return tpar.reduce_from_model(x @ w, mp) + b, False
        if split:
            x = tpar.gather_from_model(x, mp, -1)
        return x @ w + b, False
