"""ResNet with GroupNorm (counterpart of the JAX package's
``models/resnet.py``; BASELINE config 3, ResNet-50 on ImageNet Parquet).

Images ``(N, H, W, 3)`` (the loader's NHWC batch) -> f32 logits ``(N,
num_classes)``. Parameters are f32, compute is ``compute_dtype``; every
GroupNorm runs in f32 (population variance over ``(H, W, C/G)``, eps 1e-5)
and casts back. Parameters carry the JAX keys (``stem_conv``,
``s{i}b{j}_conv1``, ``..._gn1.{scale,bias}``, ``..._proj``,
``..._proj_gn``, ``fc_w``, ``fc_b``), so the JAX weights map one to one
(``weights.resnet_from_jax_params``): conv kernels are stored OIHW (JAX:
HWIO), ``fc_w`` ``(cin, num_classes)`` as in JAX.

The input is permuted to NCHW, a view whose memory is ``channels_last``;
on the card the model's conv weights are ``channels_last`` too, so cuDNN
runs NHWC convolutions with no layout copies. Convolutions pad as XLA's
``padding="SAME"``: where a stride-2 window meets an even size, one more
pixel at the bottom and right than at the top and left (the 7x7 stem on
224 pads (2, 3)), zeros before a convolution and ``-inf`` before the max
pool; PyTorch's symmetric padding would move the window grid by a pixel.

Tensor parallelism (:func:`param_specs`, ``parallel.tp``): each conv takes
its input through ``copy_to_model`` and this rank's block of output
channels, and its output is gathered on the channel dim before the
replicated GroupNorm; ``fc_w`` is row-parallel over the pooled features.
A check of the layout, not of speed: every conv output crosses the model
axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from ray_shuffling_data_loader_tpu_torch.parallel import tp as tpar
from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    num_groups: int = 32
    compute_dtype: torch.dtype = torch.bfloat16
    # Recompute each residual block in the backward pass
    # (torch.utils.checkpoint, non-reentrant).
    remat: bool = False


def resnet50(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), num_classes=num_classes)


def resnet18_cifar(num_classes: int = 10) -> ResNetConfig:
    """Small variant for tests and CPU runs."""
    return ResNetConfig(stage_sizes=(1, 1), width=16,
                        num_classes=num_classes, num_groups=8)


class GroupNormParams(nn.Module):
    """``scale`` (ones) and ``bias`` (zeros), f32."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))


def _conv_init(generator, device, kh: int, kw: int, cin: int,
               cout: int) -> nn.Parameter:
    """He-normal ``(cout, cin, kh, kw)`` kernel (fan-in ``kh*kw*cin``)."""
    return nn.Parameter(
        torch.randn((cout, cin, kh, kw), generator=generator, device=device)
        * math.sqrt(2.0 / (kh * kw * cin)))


def group_norm(x: torch.Tensor, params: GroupNormParams, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over consecutive channel groups of NCHW ``x``, in f32,
    cast back to ``x``'s dtype. The group count is ``min(num_groups, C)``,
    lowered until it divides C."""
    channels = x.shape[1]
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return F.group_norm(x.float(), groups, params.scale, params.bias,
                        eps).to(x.dtype)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(before, after)``,
    the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float) -> torch.Tensor:
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def conv_same(x: torch.Tensor, kernel: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` on NCHW ``x`` with
    an OIHW ``kernel`` cast to ``x``'s dtype."""
    kernel = kernel.to(x.dtype)
    kh, kw = kernel.shape[2:]
    pads = (same_padding(x.shape[2], kh, stride)
            + same_padding(x.shape[3], kw, stride))
    if pads[0] == pads[1] and pads[2] == pads[3]:  # symmetric: no copy
        return F.conv2d(x, kernel, stride=stride, padding=(pads[0], pads[2]))
    return F.conv2d(_pad_same(x, kh, stride, 0.0), kernel, stride=stride)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``lax.reduce_window(x, -inf, max, ..., "SAME")`` on NCHW ``x``."""
    return F.max_pool2d(_pad_same(x, window, stride, -math.inf), window,
                        stride)


class ResNet(nn.Module):
    """Parameters as the JAX package's pytree (module docstring); conv
    kernels He-normal and ``fc_w`` ``N(0, 1/cin)`` from ``generator``,
    GroupNorm scales one and biases zero, ``fc_b`` zero. ``device=None``
    means CUDA and raises without it; on CUDA the conv kernels are kept
    ``channels_last``."""

    tp: Optional[tpar.ModelParallel] = None

    def __init__(self, config: ResNetConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config

        def conv(name, kh, kw, cin, cout):
            setattr(self, name, _conv_init(generator, device, kh, kw, cin,
                                           cout))

        def gn(name, channels):
            setattr(self, name, GroupNormParams(channels, device))

        conv("stem_conv", 7, 7, 3, config.width)
        gn("stem_gn", config.width)
        cin = config.width
        for stage, num_blocks in enumerate(config.stage_sizes):
            cmid = config.width * (2 ** stage)
            cout = cmid * 4
            for block in range(num_blocks):
                name = f"s{stage}b{block}"
                conv(f"{name}_conv1", 1, 1, cin, cmid)
                gn(f"{name}_gn1", cmid)
                conv(f"{name}_conv2", 3, 3, cmid, cmid)
                gn(f"{name}_gn2", cmid)
                conv(f"{name}_conv3", 1, 1, cmid, cout)
                gn(f"{name}_gn3", cout)
                if block == 0:
                    conv(f"{name}_proj", 1, 1, cin, cout)
                    gn(f"{name}_proj_gn", cout)
                cin = cout
        self.fc_w = nn.Parameter(
            torch.randn((cin, config.num_classes), generator=generator,
                        device=device) * math.sqrt(1.0 / cin))
        self.fc_b = nn.Parameter(torch.zeros(config.num_classes,
                                             device=device))
        if device.type == "cuda":
            self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return apply(self, images)


def _conv(model: ResNet, x: torch.Tensor, name: str,
          stride: int = 1) -> torch.Tensor:
    """:func:`conv_same` with the kernel ``name``; under tensor parallelism
    with this rank's output channels, gathered over the model axis."""
    mp = model.tp
    if mp is not None:
        mp.require({name: 0})
    return tpar.gather_from_model(conv_same(
        tpar.copy_to_model(x, mp), getattr(model, name), stride), mp, 1)


def _block(x: torch.Tensor, model: ResNet, name: str,
           stride: int) -> torch.Tensor:
    """One bottleneck block: 1x1 -> 3x3 (carrying the stride) -> 1x1, each
    followed by GroupNorm, plus the residual, projected by a 1x1 on a
    stage's first block."""
    groups = model.config.num_groups

    def p(key):
        return getattr(model, f"{name}_{key}")

    residual = x
    y = F.relu(group_norm(_conv(model, x, f"{name}_conv1"), p("gn1"),
                          groups))
    y = F.relu(group_norm(_conv(model, y, f"{name}_conv2", stride),
                          p("gn2"), groups))
    y = group_norm(_conv(model, y, f"{name}_conv3"), p("gn3"), groups)
    if hasattr(model, f"{name}_proj"):
        residual = group_norm(_conv(model, residual, f"{name}_proj", stride),
                              p("proj_gn"), groups)
    return F.relu(y + residual)


def apply(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """Images ``(N, H, W, 3)`` -> f32 logits ``(N, num_classes)`` (the JAX
    package's ``apply``)."""
    config = model.config
    dtype = config.compute_dtype
    # NHWC -> an NCHW view in channels_last memory: no copy.
    x = images.permute(0, 3, 1, 2).to(dtype)
    x = _conv(model, x, "stem_conv", stride=2)
    x = F.relu(group_norm(x, model.stem_gn, config.num_groups))
    x = max_pool_same(x)
    for stage, num_blocks in enumerate(config.stage_sizes):
        for block in range(num_blocks):
            name = f"s{stage}b{block}"
            stride = 2 if (stage > 0 and block == 0) else 1
            if config.remat:
                x = checkpoint.checkpoint(_block, x, model, name, stride,
                                          use_reentrant=False)
            else:
                x = _block(x, model, name, stride)
    x = x.mean(dim=(2, 3))  # global average pool
    mp = model.tp
    if mp is not None:
        mp.require({"fc_w": 0, "fc_b": None})
    logits = (tpar.reduce_from_model(
        tpar.scatter_to_model(x, mp, -1) @ model.fc_w.to(dtype), mp)
        + model.fc_b.to(dtype))
    return logits.float()


def param_specs(config: ResNetConfig, model_axis: str = "model"
                ) -> Dict[str, Tuple]:
    """The JAX package's layout in the port's names and OIHW kernels: each
    conv's output channels over ``model_axis`` (the JAX spec's last, HWIO,
    entry), GroupNorm replicated, ``fc_w`` split on its input dim, ``fc_b``
    replicated."""
    specs: Dict[str, Tuple] = {}
    for name, param in ResNet(config, device="meta").named_parameters():
        if name == "fc_w":
            specs[name] = (model_axis, None)
        elif param.ndim == 4:
            specs[name] = (model_axis, None, None, None)
        else:
            specs[name] = (None,)
    return specs


def loss_fn(model: ResNet, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy; ``labels`` are int class ids ``(N,)`` or
    ``(N, 1)``."""
    logits = apply(model, images)
    return F.cross_entropy(logits, labels.reshape(-1).long())
