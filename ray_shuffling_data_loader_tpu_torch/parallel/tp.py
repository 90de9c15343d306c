"""Megatron tensor parallelism over a mesh's ``"model"`` axis.

The JAX package places global arrays by ``NamedSharding(mesh, spec)`` and
lets XLA insert the collectives. PyTorch has no global array: here each
rank holds its block of every sharded parameter, and the collectives are
written out as the region operators below.

**Specs.** A spec is a tuple with one entry per dimension of a parameter,
an axis name or None, as ``jax.sharding.PartitionSpec`` reads it (a
shorter tuple leaves the rest None). ``param_specs`` is a flat dict keyed
by the model's ``named_parameters()`` names (``models.*.param_specs``).
Only the model axis shards parameters, at most one dimension each.

**Layout.** Rank r of the model axis holds the r-th contiguous block of a
sharded dimension. A module's ``tp_fused`` dict names parameters whose
sharded dimension holds several blocks side by side (BERT's fused q|k|v
projection): each block is split on its own, so rank r holds the r-th
part of every block (the same heads of q, k and v).

**Region operators** (``torch.autograd.Function``s over the model group):

- :func:`copy_to_model`: identity forward, all-reduce backward (the input
  of a column-parallel layer);
- :func:`reduce_from_model`: all-reduce forward, identity backward (the
  output of a row-parallel layer);
- :func:`gather_from_model`: all-gather forward, this rank's slice
  backward (the input of a replicated region);
- :func:`scatter_to_model`: this rank's slice forward, all-gather backward.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which counts a replicated region's gradient once per
rank. A replicated region computes the same values on every rank of the
model axis, so the slice backward of a gather is the whole gradient.

:func:`shard_module_` cuts a model's parameters to this rank's blocks and
hands every module a :class:`ModelParallel` (``module.tp``), which the
models' forwards read; :func:`full_state_dict` gathers the blocks back.
Each collective adds its payload bytes (an all-reduce's tensor, an
all-gather's output) to :class:`CollectiveStats`, and with
``stats.timed`` its milliseconds between a device synchronisation before
and one after.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
from ray_shuffling_data_loader_tpu_torch.parallel.mesh import MODEL_AXIS

Spec = Tuple[Optional[str], ...]


class CollectiveStats:
    """Calls, payload bytes and (when ``timed``) milliseconds of the model
    axis's collectives, by operator name; shared by a model's modules."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.ms: Dict[str, float] = {}

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "ms": dict(self.ms)}


@dataclasses.dataclass(eq=False)
class ModelParallel:
    """The model axis as one module sees it: its group, size and this
    rank's coordinate, the sharded dimension of each of the module's
    parameters (names relative to the module; None: replicated) and the
    model's collective counters."""

    group: Any
    size: int
    rank: int
    dims: Dict[str, Optional[int]]
    stats: CollectiveStats

    def require(self, layout: Mapping[str, Optional[int]]) -> None:
        """Raise ``ValueError`` unless each named parameter is sharded on
        the given dimension (None: replicated): the layout a forward is
        written for."""
        for name, dim in layout.items():
            if self.dims.get(name) != dim:
                raise ValueError(
                    f"tensor-parallel forward needs {name} sharded on "
                    f"dimension {dim} over the model axis; its spec shards "
                    f"dimension {self.dims.get(name)}")

    def run(self, name: str, x: torch.Tensor, nbytes: int,
            collective: Callable[[], Any]) -> None:
        """Run ``collective`` on ``x``'s device, counting ``nbytes``."""
        self.stats.calls[name] = self.stats.calls.get(name, 0) + 1
        self.stats.bytes[name] = self.stats.bytes.get(name, 0) + nbytes
        if not self.stats.timed:
            collective()
            return
        _sync(x)
        start = time.perf_counter()
        collective()
        _sync(x)
        self.stats.ms[name] = (self.stats.ms.get(name, 0.0)
                               + (time.perf_counter() - start) * 1e3)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# -- collectives and region operators ---------------------------------------


def _all_reduce(x: torch.Tensor, mp: ModelParallel,
                name: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    mp.run(name, out, out.numel() * out.element_size(),
           lambda: dist.all_reduce(out, group=mp.group))
    return out


def _all_gather(x: torch.Tensor, mp: ModelParallel, dim: int,
                name: str) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mp.size)]
    mp.run(name, x, mp.size * x.numel() * x.element_size(),
           lambda: dist.all_gather(parts, x, group=mp.group))
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mp, "copy_to_model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return _all_reduce(x, mp, "reduce_from_model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return _all_gather(x, mp, dim, "gather_from_model")

    @staticmethod
    def backward(ctx, grad):
        return (shard_tensor(grad, ctx.dim, 1, ctx.mp.size, ctx.mp.rank),
                None, None)


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return shard_tensor(x, dim, 1, mp.size, mp.rank)

    @staticmethod
    def backward(ctx, grad):
        return (_all_gather(grad, ctx.mp, ctx.dim, "scatter_to_model"),
                None, None)


def copy_to_model(x: torch.Tensor,
                  mp: Optional[ModelParallel]) -> torch.Tensor:
    """Identity; the backward all-reduces the gradient over the model
    axis (each rank's column block contributed a part of it). Each
    operator is the identity without a model axis (``mp`` None, or one
    rank)."""
    if mp is None or mp.size == 1:
        return x
    return _CopyToModel.apply(x, mp)


def reduce_from_model(x: torch.Tensor,
                      mp: Optional[ModelParallel]) -> torch.Tensor:
    """The sum of ``x`` over the model axis; the backward passes the
    gradient through."""
    if mp is None or mp.size == 1:
        return x
    return _ReduceFromModel.apply(x, mp)


def gather_from_model(x: torch.Tensor, mp: Optional[ModelParallel],
                      dim: int) -> torch.Tensor:
    """The model axis's blocks of ``x`` concatenated on ``dim`` in rank
    order; the backward keeps this rank's block of the gradient."""
    if mp is None or mp.size == 1:
        return x
    return _GatherFromModel.apply(x, mp, dim % x.ndim)


def scatter_to_model(x: torch.Tensor, mp: Optional[ModelParallel],
                     dim: int) -> torch.Tensor:
    """This rank's block of ``x`` on ``dim``; the backward all-gathers the
    gradient."""
    if mp is None or mp.size == 1:
        return x
    return _ScatterToModel.apply(x, mp, dim % x.ndim)


# -- specs, sharding and gathering ------------------------------------------


def param_layout(model: nn.Module, specs: Mapping[str, Spec],
                 axis_names: Sequence[str], axis_sizes: Sequence[int]
                 ) -> Dict[str, Optional[int]]:
    """The sharded dimension of each parameter (None: replicated) on a
    mesh of ``axis_names`` and ``axis_sizes``. Raises ``ValueError`` where
    ``specs`` misses or adds a parameter, names an axis the mesh lacks,
    shards on another axis than ``"model"`` or more than one dimension,
    or where the axis size does not divide the dimension (each block of a
    fused parameter)."""
    names = dict(model.named_parameters())
    if set(specs) != set(names):
        raise ValueError(
            f"param_specs must name every parameter: missing "
            f"{sorted(set(names) - set(specs))}, unknown "
            f"{sorted(set(specs) - set(names))}")
    sizes = dict(zip(axis_names, axis_sizes))
    fused = fused_blocks(model)
    layout: Dict[str, Optional[int]] = {}
    for name, param in names.items():
        spec = tuple(specs[name])
        if len(spec) > param.ndim:
            raise ValueError(f"{name}: spec {spec} has more entries than "
                             f"the parameter's {param.ndim} dimensions")
        dims = [d for d, a in enumerate(spec) if a is not None]
        for d in dims:
            if spec[d] not in sizes:
                raise ValueError(f"{name}: spec {spec} names axis "
                                 f"{spec[d]!r}; the mesh has "
                                 f"{tuple(axis_names)}")
            if spec[d] != MODEL_AXIS:
                raise ValueError(f"{name}: spec {spec} shards on "
                                 f"{spec[d]!r}; only the {MODEL_AXIS!r} "
                                 f"axis shards parameters")
        if len(dims) > 1:
            raise ValueError(f"{name}: spec {spec} shards more than one "
                             f"dimension")
        dim = dims[0] if dims else None
        if dim is not None:
            parts = fused.get(name, 1) * sizes[MODEL_AXIS]
            if param.shape[dim] % parts:
                raise ValueError(
                    f"{name}: dimension {dim} of {tuple(param.shape)} does "
                    f"not split into {parts} blocks (the model axis of "
                    f"size {sizes[MODEL_AXIS]}"
                    + (f", {fused[name]} fused blocks)" if name in fused
                       else ")"))
        layout[name] = dim
    return layout


def mesh_layout(model: nn.Module, specs: Mapping[str, Spec],
                mesh) -> Dict[str, Optional[int]]:
    """:func:`param_layout` against ``mesh``'s axes."""
    return param_layout(model, specs, mesh.mesh_dim_names,
                        tuple(mesh.mesh.shape))


def fused_blocks(model: nn.Module) -> Dict[str, int]:
    """Full parameter name -> number of side-by-side blocks, from every
    module's ``tp_fused``."""
    out = {}
    for prefix, module in model.named_modules():
        for name, blocks in getattr(module, "tp_fused", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = blocks
    return out


def shard_tensor(t: torch.Tensor, dim: Optional[int], blocks: int,
                 size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``t``: the rank-th of ``size`` parts of
    each of the ``blocks`` blocks of dimension ``dim``, contiguous (a 4-D
    tensor in ``channels_last`` stays so)."""
    if dim is None:
        return t
    n = t.shape[dim] // blocks
    part = n // size
    local = t.unflatten(dim, (blocks, n)).narrow(
        dim + 1, rank * part, part).flatten(dim, dim + 1)
    if (t.ndim == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)):
        return local.contiguous(memory_format=torch.channels_last)
    return local.contiguous()


def unshard_tensors(parts: Sequence[torch.Tensor], dim: Optional[int],
                    blocks: int) -> torch.Tensor:
    """The inverse of :func:`shard_tensor` over the parts of every rank."""
    if dim is None:
        return parts[0]
    pieces = [p.unflatten(dim, (blocks, p.shape[dim] // blocks))
              for p in parts]
    return torch.cat(pieces, dim + 1).flatten(dim, dim + 1)


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    module_name, _, attr = name.rpartition(".")
    return model.get_submodule(module_name), attr


def shard_module_(model: nn.Module, specs: Mapping[str, Spec],
                  mesh) -> Dict[nn.Parameter, nn.Parameter]:
    """Cut each sharded parameter of ``model`` to this rank's block of the
    model axis, in place, as a new contiguous ``nn.Parameter``, and give
    every module its :class:`ModelParallel` (``module.tp``; left as it was
    when no parameter is sharded). Returns ``{old: new}`` for the
    optimizer to follow (:func:`follow_params`)."""
    layout = mesh_layout(model, specs, mesh)
    if all(dim is None for dim in layout.values()):
        return {}
    group = pmesh.model_group(mesh)
    size = dist.get_world_size(group)
    rank = pmesh.axis_index(mesh, MODEL_AXIS)
    fused = fused_blocks(model)
    replaced = {}
    for name, dim in layout.items():
        if dim is None:
            continue
        module, attr = _owner(model, name)
        old = getattr(module, attr)
        new = nn.Parameter(shard_tensor(old.detach(), dim,
                                        fused.get(name, 1), size, rank),
                           requires_grad=old.requires_grad)
        setattr(module, attr, new)
        replaced[old] = new
    stats = CollectiveStats()
    for prefix, module in model.named_modules():
        start = f"{prefix}." if prefix else ""
        module.tp = ModelParallel(
            group, size, rank,
            {n[len(start):]: d for n, d in layout.items()
             if n.startswith(start)}, stats)
    return replaced


def follow_params(optimizer: torch.optim.Optimizer,
                  replaced: Mapping[nn.Parameter, nn.Parameter]) -> None:
    """Point ``optimizer`` at the parameters :func:`shard_module_` made.
    Raises ``ValueError`` once the optimizer holds state (its moments
    would be the global shapes)."""
    if not replaced:
        return
    if optimizer.state:
        raise ValueError("shard the model before its optimizer has stepped")
    for group in optimizer.param_groups:
        group["params"] = [replaced.get(p, p) for p in group["params"]]


def spec_dim(spec: Spec) -> Optional[int]:
    """The dimension a (checked) spec shards, or None."""
    return next((d for d, a in enumerate(spec) if a is not None), None)


def gather_tensor(t: torch.Tensor, dim: Optional[int], blocks: int,
                  group) -> torch.Tensor:
    """The global tensor of which each rank of ``group`` holds ``t``."""
    if dim is None:
        return t
    t = t.detach().contiguous()
    # One slot per rank of the collective's own group, as all_gather
    # requires. rsdl-lint: disable=fixed-world-assumption
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return unshard_tensors(parts, dim, blocks)


def _gathered(model, specs, mesh):
    group = pmesh.model_group(mesh)
    fused = fused_blocks(model)
    return lambda name, t: gather_tensor(t, spec_dim(specs.get(name, ())),
                                         fused.get(name, 1), group)


def _sharded(model, specs, mesh):
    size = pmesh.axis_size(mesh, MODEL_AXIS)
    rank = pmesh.axis_index(mesh, MODEL_AXIS)
    fused = fused_blocks(model)
    return lambda name, t: shard_tensor(t, spec_dim(specs.get(name, ())),
                                        fused.get(name, 1), size, rank)


def full_state_dict(model: nn.Module, specs: Mapping[str, Spec],
                    mesh) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with each parameter that ``specs`` shards
    (``model`` holds this rank's block) gathered into its global tensor: a
    collective over the model axis, which every rank calls."""
    fn = _gathered(model, specs, mesh)
    return {name: fn(name, t) for name, t in model.state_dict().items()}


def shard_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Spec],
                     mesh) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a global state dict (the inverse of
    :func:`full_state_dict`), for ``model.load_state_dict``."""
    fn = _sharded(model, specs, mesh)
    return {name: fn(name, t) for name, t in state.items()}


def _map_optimizer_state(model, optimizer, state: dict, fn) -> dict:
    # Per-parameter tensors (Adam's moments) have the parameter's shape;
    # the step count is a scalar and stays as it is.
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    return {**state, "state": {
        index: {key: (fn(order[index], value)
                      if torch.is_tensor(value) and value.ndim else value)
                for key, value in entry.items()}
        for index, entry in state["state"].items()}}


def full_optimizer_state_dict(model: nn.Module,
                              optimizer: torch.optim.Optimizer,
                              specs: Mapping[str, Spec], mesh) -> dict:
    """``optimizer.state_dict()`` with the moments of each sharded
    parameter gathered into global tensors (a collective over the model
    axis)."""
    return _map_optimizer_state(model, optimizer, optimizer.state_dict(),
                                _gathered(model, specs, mesh))


def shard_optimizer_state_dict(model: nn.Module,
                               optimizer: torch.optim.Optimizer,
                               state: dict, specs: Mapping[str, Spec],
                               mesh) -> dict:
    """This rank's blocks of a global optimizer state dict (the inverse of
    :func:`full_optimizer_state_dict`)."""
    return _map_optimizer_state(model, optimizer, state,
                                _sharded(model, specs, mesh))
