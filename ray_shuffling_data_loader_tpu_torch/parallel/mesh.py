"""Named-axis meshes over process groups (counterpart of the JAX package's
``parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the default process group, which the caller initialises first
(``init_process_group`` with its address, world size and rank). Each axis
has a process group of its own (``mesh.get_group(name)``), which the
collectives of that axis use.

Axis convention, as in the JAX package:

- ``"data"``: the batch dimension; one loader rank per data coordinate.
- ``"model"``: tensor-parallel parameters (``parallel.tp``: Megatron
  column and row blocks of the parameters that ``param_specs`` shard);
  the ranks of one model group hold the same data.
- ``"seq"``: the sequence dimension (ring attention and Ulysses).

There is no global array in PyTorch: each rank holds its block of the
global batch, which :func:`batch_sharding` takes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def named_mesh(shape: Sequence[int], names: Sequence[str],
               device=None) -> DeviceMesh:
    """A mesh of ``shape`` over all ranks, axes named ``names``.

    ``device=None`` means CUDA and raises without a card;
    ``device="cpu"`` meshes CPU ranks. Every axis group runs the default
    group's backend (NCCL on cards; gloo on the CPU, or on CUDA tensors
    where several ranks share one card). The default process group must
    be initialised and its size must be the product of ``shape``.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group "
                           "(torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"mesh shape {tuple(shape)} holds {size} ranks; "
                         f"the world has {world}")
    mesh = init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))
    # Every axis must run the default group's backend: over a gloo world on
    # CUDA tensors (several ranks on one card, where NCCL refuses), an
    # axis group quietly made with another backend would fail at its
    # first collective instead.
    backend = dist.get_backend()
    for name in names:
        got = dist.get_backend(mesh.get_group(name))
        if got != backend:
            raise RuntimeError(f"mesh axis {name!r} got backend {got!r}; "
                               f"the default group runs {backend!r}")
    return mesh


def make_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh: ``model_parallel`` ranks per model
    group, the rest on the data axis (pure data parallelism by default)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide "
                         f"the world size {world}")
    return named_mesh((world // model_parallel, model_parallel),
                      (DATA_AXIS, MODEL_AXIS), device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return dist.get_world_size(mesh.get_group(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def model_group(mesh: DeviceMesh):
    """The process group of this rank's model axis (its tensor-parallel
    peers)."""
    return mesh.get_group(MODEL_AXIS)


def batch_group(mesh: DeviceMesh):
    """The process group of the ranks that hold other data than this one:
    every axis but ``"model"``, whose peers hold the same batch. None (the
    default group, every rank) where the mesh has no model axis of more
    than one rank. Raises ``NotImplementedError`` for a model axis beside
    two or more other axes (``data`` with ``seq``)."""
    names = tuple(mesh.mesh_dim_names)
    if MODEL_AXIS not in names or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    others = [n for n in names if n != MODEL_AXIS]
    if len(others) != 1:
        raise NotImplementedError(
            f"a model axis beside the axes {others} is not supported (one "
            f"data axis, no seq axis)")
    return mesh.get_group(others[0])


def batch_sharding(mesh: DeviceMesh, x: torch.Tensor,
                   data_axis: Optional[str] = DATA_AXIS,
                   seq_axis: Optional[str] = None) -> torch.Tensor:
    """This rank's block of the global batch ``x``: dimension 0 split over
    ``data_axis`` and, with ``seq_axis``, dimension 1 over it (a view).
    Raises where an axis size does not divide its dimension."""
    for dim, axis in ((0, data_axis), (1, seq_axis)):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over axis {axis!r} of size {n}")
        step = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axis) * step, step)
    return x


def flat_collective(tensors: Sequence[torch.Tensor],
                    collective: Callable[[torch.Tensor], Any]) -> None:
    """Run ``collective`` (in place, e.g. ``dist.all_reduce``) over
    ``tensors`` as one flat buffer per dtype, so that the launches stay
    few, and copy the result back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        torch._foreach_copy_(group, [c.view_as(t) for c, t in zip(
            flat.split([t.numel() for t in group]), group)])


def replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Make every parameter and buffer of ``module`` rank 0's, in place;
    returns ``module``."""
    flat_collective([t.data for t in [*module.parameters(),
                                      *module.buffers()]],
                    lambda flat: dist.broadcast(flat, src=0))
    return module


def local_data_shard_info(mesh: DeviceMesh,
                          data_axis: str = DATA_AXIS) -> Tuple[int, int]:
    """``(rank, num_trainers)`` of this rank's loader: its coordinate on
    ``data_axis`` and that axis's size. Ranks that differ only on other
    axes (``seq`` and ``model`` peers) read the same stream."""
    return axis_index(mesh, data_axis), axis_size(mesh, data_axis)
