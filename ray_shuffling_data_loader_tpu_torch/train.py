"""DLRM training steps: one Adam micro-step per ``microbatch``-row slice of
each loader batch (counterpart of bench.py's micro-batched train phase).

Adam is ``torch.optim.Adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)``, the
defaults of ``optax.adam(1e-3)``. Both compute ``m_hat / (sqrt(v_hat) +
eps)``, but round in a different order, so trajectories agree to float32
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ray_shuffling_data_loader_tpu_torch.models import dlrm

MicroStep = Callable[[Sequence[torch.Tensor], torch.Tensor], torch.Tensor]


def make_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)


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
