"""Tabular MLP: float32 parameters, compute in ``compute_dtype``, float32
output logits (counterpart of the JAX package's ``models/mlp.py``).

Weights are stored ``(d_in, d_out)`` and applied as ``x @ w + b``, the JAX
package's layout, so its parameters load without a transpose
(``weights.from_jax_params``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device


class MLP(nn.Module):
    """``len(hidden_dims) + 1`` affine layers, ReLU between them.
    Parameters ``w{i}`` ``(d_in, d_out)`` are He-initialised from
    ``generator``; biases ``b{i}`` start at zero. ``device=None`` means
    CUDA and raises without it."""

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
        for i in range(self.num_layers):
            w = getattr(self, f"w{i}").to(dtype)
            b = getattr(self, f"b{i}").to(dtype)
            x = x @ w + b
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x.to(torch.float32)
