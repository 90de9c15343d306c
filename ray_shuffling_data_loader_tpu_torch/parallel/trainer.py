"""Data-, sequence- and tensor-parallel trainer over a mesh (counterpart
of the JAX package's ``parallel/trainer.py``).

The JAX package jits one SPMD program over global arrays, and XLA inserts
the gradient collectives. Here every rank runs the step on its block of
the global batch with its own copy of the replicated parameters and, with
``param_specs``, its block of the sharded ones (``parallel.tp``):

- at construction the parameters are broadcast from rank 0, so every
  rank starts from the same global values (the JAX package places one
  pytree), then cut to this rank's blocks of the model axis;
- ``loss_fn(model, *batch)`` returns this rank's term of the global loss:
  the terms over the ranks that hold different data (the data axis and
  ``seq``, never ``model``, whose peers compute the same term) sum to it
  (a per-example mean over a data rank's block is divided by the data
  axis's size; ``models.bert.loss_fn`` with a ``mesh`` returns its term
  itself);
- after ``backward`` the gradients (and the loss term) are summed over
  those ranks (``parallel.mesh.batch_group``), one ``all_reduce`` of one
  flat buffer per dtype, so the update every rank applies is the global
  gradient's, as in the JAX package; then the optimizer steps
  (``train.make_optimizer``: the update of ``optax.adam``), each rank on
  its blocks (Adam is elementwise). A sharded parameter's gradient is
  whole on its rank; a replicated one is the same on every model peer,
  so it stays one value across them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
from ray_shuffling_data_loader_tpu_torch.parallel import tp
from ray_shuffling_data_loader_tpu_torch.utils import tracing

LossFn = Callable[..., torch.Tensor]


def make_train_step(model: torch.nn.Module, loss_fn: LossFn,
                    optimizer: torch.optim.Optimizer,
                    collective_ms: Optional[List[float]] = None,
                    group=None) -> Callable:
    """``step(*batch) -> loss``: this rank's loss term and its gradients,
    both summed over the ranks of ``group`` (None: all ranks), then one
    optimizer update. Returns the global loss (no host sync). With a
    ``collective_ms`` list, each step appends the wall milliseconds of its
    gradient all-reduce, between a device synchronisation before it and
    one after it."""
    params = [p for p in model.parameters() if p.requires_grad]
    # A group of one rank sums nothing (tensor parallelism alone: every
    # rank on one model axis): no collective, the same bits. Over gloo it
    # would stage every gradient through the host: 30-441 ms for a DLRM
    # mlperf rank at TP=2 on an H100, whose whole step takes 37-41 ms.
    alone = dist.get_world_size(group) == 1

    def sync() -> None:
        if params and params[0].is_cuda:
            torch.cuda.synchronize(params[0].device)

    def train_step(*batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        total = loss.detach().to(torch.float32).reshape(1)
        if alone:
            if collective_ms is not None:
                collective_ms.append(0.0)
        else:
            if collective_ms is not None:
                sync()
                start = time.perf_counter()
            pmesh.flat_collective(
                [p.grad for p in params] + [total],
                lambda flat: dist.all_reduce(flat, group=group))
            if collective_ms is not None:
                sync()
                collective_ms.append((time.perf_counter() - start) * 1e3)
        optimizer.step()
        return total[0]

    return train_step


class SpmdTrainer:
    """Owns a model (replicated, or sharded over the model axis), its
    optimizer and the step.

    Args:
        mesh: the mesh (``parallel.mesh``), spanning every rank.
        loss_fn: ``loss_fn(model, *batch) -> this rank's loss term``.
        model: the model, on the mesh's device; its parameters are
            overwritten with rank 0's.
        optimizer: a ``torch.optim`` optimizer over ``model``'s parameters
            that has not stepped yet (it is pointed at the shards).
        param_specs: ``None`` (replicate every parameter) or a spec per
            parameter name (``models.*.param_specs``, ``parallel.tp``):
            each parameter the specs shard is cut to this rank's block of
            the model axis (``tp.shard_module_``), and the model's forward
            runs the Megatron collectives. Raises ``ValueError`` on a spec
            that names an axis the mesh lacks, misses or adds a parameter,
            or does not divide a dimension.
        time_collectives: record each step's all-reduce milliseconds in
            ``collective_ms`` (it adds a device synchronisation before and
            after the all-reduce).
    """

    def __init__(self, mesh, loss_fn: LossFn, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 param_specs: Optional[Any] = None,
                 time_collectives: bool = False):
        for name, p in model.named_parameters():
            if p.device.type != mesh.device_type:
                raise ValueError(f"parameter {name} is on {p.device}; the "
                                 f"mesh is over {mesh.device_type}")
        if param_specs is not None:
            tp.mesh_layout(model, param_specs, mesh)  # raises before a send
        self.mesh = mesh
        self.param_specs = param_specs
        self.model = pmesh.replicated(model)
        if param_specs is not None:
            tp.follow_params(optimizer,
                             tp.shard_module_(model, param_specs, mesh))
        self.optimizer = optimizer
        self.collective_ms: Optional[List[float]] = (
            [] if time_collectives else None)
        self._step = make_train_step(model, loss_fn, optimizer,
                                     self.collective_ms,
                                     pmesh.batch_group(mesh))
        self._step_count = 0

    def train_step(self, *batch) -> torch.Tensor:
        """One optimizer step on this rank's block of the batch; returns
        the global loss (on the device, no sync). The step is one
        ``train#N`` range on the profiler's timeline."""
        with tracing.step_span(self._step_count):
            loss = self._step(*batch)
        self._step_count += 1
        return loss

    def block_until_ready(self) -> None:
        if self.mesh.device_type == "cuda":
            torch.cuda.synchronize()


def batch_shardings(mesh, batch: Sequence[torch.Tensor],
                    data_axis: Optional[str] = pmesh.DATA_AXIS,
                    seq_axis: Optional[str] = None):
    """This rank's block of each tensor of a global batch
    (:func:`parallel.mesh.batch_sharding`)."""
    return tuple(pmesh.batch_sharding(mesh, t, data_axis, seq_axis)
                 for t in batch)
