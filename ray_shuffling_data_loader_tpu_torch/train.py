"""Training steps: one optimizer micro-step per ``microbatch``-row slice of
each loader batch (counterpart of bench.py's micro-batched train phase),
for DLRM and for BERT MLM (Adam), BERT MLM split over a ``("data",
"seq")`` mesh (:func:`make_bert_spmd_micro_step`), and ResNet on decoded
images (SGD, :func:`make_resnet_micro_step`).

Adam is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the
defaults of ``optax.adam(lr)``: lr 1e-3 for DLRM, 1e-4 for BERT (the JAX
package's ``workloads/bert_mlm.py``). Both compute ``m_hat / (sqrt(v_hat) +
eps)``, but round in a different order, so trajectories agree to float32
rounding, not bit for bit. SGD is ``torch.optim.SGD(lr=1e-2)``, no
momentum and no weight decay: ``optax.sgd(1e-2)`` of the JAX package's
ImageNet smoke run.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ray_shuffling_data_loader_tpu_torch.models import bert, dlrm, resnet
from ray_shuffling_data_loader_tpu_torch.ops import ring_attention
from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
from ray_shuffling_data_loader_tpu_torch.parallel.trainer import SpmdTrainer
from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm

MicroStep = Callable[[Sequence[torch.Tensor], torch.Tensor], torch.Tensor]

#: ``optax.adam``'s learning rate in the JAX package's BERT-MLM smoke run.
BERT_LR = 1e-4
#: ``optax.sgd``'s learning rate in the JAX package's ImageNet smoke run.
RESNET_LR = 1e-2


def make_optimizer(model: torch.nn.Module,
                   lr: float = 1e-3) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def make_sgd(model: torch.nn.Module,
             lr: float = RESNET_LR) -> torch.optim.SGD:
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=0.0,
                           weight_decay=0.0)


def make_micro_step(model: dlrm.DLRM,
                    optimizer: torch.optim.Optimizer) -> MicroStep:
    """``step(cols, labels) -> loss``: forward, backward and one optimizer
    update on one micro-batch. The loss stays on the device (no sync)."""

    def step(cols: Sequence[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = dlrm.loss_fn(model, None, list(cols), labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_bert_update(model: bert.Bert, optimizer: torch.optim.Optimizer,
                     attention_fn: Optional[bert.AttentionFn] = None
                     ) -> Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]:
    """``update(inputs, targets) -> loss``: MLM forward, backward and one
    optimizer update on already-masked tokens."""

    def update(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = bert.loss_fn(model, inputs, targets,
                            attention_fn=attention_fn)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return update


def make_bert_micro_step(model: bert.Bert, optimizer: torch.optim.Optimizer,
                         generator: torch.Generator,
                         attention_fn: Optional[bert.AttentionFn] = None
                         ) -> MicroStep:
    """``step(cols, labels) -> loss`` for BERT MLM: ``cols[0]`` is the
    ``(B, S)`` token batch (``labels`` is unused); masks it on the device
    with ``generator`` (:func:`bert_mlm.mlm_mask`), then one
    :func:`make_bert_update` step."""
    update = make_bert_update(model, optimizer, attention_fn)
    vocab_size = model.config.vocab_size

    def step(cols: Sequence[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        inputs, targets = bert_mlm.mlm_mask(cols[0], generator, vocab_size)
        return update(inputs, targets)

    return step


def make_bert_spmd_micro_step(mesh, model: bert.Bert,
                              optimizer: torch.optim.Optimizer,
                              generator: torch.Generator,
                              strategy: str = "ring") -> MicroStep:
    """``step(cols, labels) -> global loss`` for BERT MLM on a ``("data",
    "seq")`` mesh (the JAX package's sequence-parallel dry run).

    ``cols[0]`` is this data rank's ``(B, S)`` token batch: each rank's
    loader is ``DeviceShufflingDataset(rank=, num_trainers=)`` from
    ``parallel.mesh.local_data_shard_info``, so the ``seq`` peers of a data
    rank read the same batches. The whole batch is masked with
    ``generator`` before the rank takes its sequence chunk, so the peers,
    whose generators must be seeded alike, agree on the masked positions.
    Attention is ``strategy`` (``"ring"`` or ``"ulysses"``) over ``seq``,
    through the flash kernels on CUDA; one :class:`SpmdTrainer` step
    follows (the parameters are broadcast from rank 0 here)."""
    attention_fn = ring_attention.make_attention_fn(
        mesh, pmesh.SEQ_AXIS, strategy, batch_axis=pmesh.DATA_AXIS)
    seq_index = pmesh.axis_index(mesh, pmesh.SEQ_AXIS)

    def loss_fn(model, inputs, targets):
        return bert.loss_fn(model, inputs, targets, attention_fn=attention_fn,
                            position_offset=seq_index * inputs.shape[1],
                            mesh=mesh)

    trainer = SpmdTrainer(mesh, loss_fn, model, optimizer)
    vocab_size = model.config.vocab_size

    def step(cols: Sequence[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        inputs, targets = bert_mlm.mlm_mask(cols[0], generator, vocab_size)
        return trainer.train_step(*(
            pmesh.batch_sharding(mesh, t, data_axis=None,
                                 seq_axis=pmesh.SEQ_AXIS)
            for t in (inputs, targets)))

    return step


def make_resnet_micro_step(model: resnet.ResNet,
                           optimizer: torch.optim.Optimizer) -> MicroStep:
    """``step(cols, labels) -> loss`` for ResNet: ``cols[0]`` is the
    ``(B, H, W, 3)`` uint8 image batch, scaled to ``[0, 1]`` in f32 on its
    device, then the model's compute dtype, softmax cross-entropy over
    ``labels`` reshaped to ``(B,)``, and one optimizer update."""

    def step(cols: Sequence[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        images = cols[0].to(torch.float32) / 255.0
        loss = resnet.loss_fn(model, images, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_chunk(micro_step: MicroStep, cols: List[torch.Tensor],
                labels: torch.Tensor, microbatch: int) -> torch.Tensor:
    """Run one micro-step per ``microbatch``-row slice of a loader batch;
    returns the micro-step losses as one device tensor."""
    rows = labels.shape[0]
    if microbatch < 1 or rows % microbatch:
        raise ValueError(
            f"microbatch {microbatch} must divide the batch of {rows} rows")
    losses = []
    for lo in range(0, rows, microbatch):
        hi = lo + microbatch
        losses.append(micro_step([c[lo:hi] for c in cols], labels[lo:hi]))
    return torch.stack(losses)
