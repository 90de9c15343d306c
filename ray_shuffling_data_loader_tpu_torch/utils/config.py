"""Configuration constants and the device rule of the port's entry points
(own copy of the JAX package's ``utils/config.py`` plus
:func:`resolve_device`). torch is imported by :func:`resolve_device`
alone, so the host-only modules that read the constants (the dataset, the
queue server's child process) load no torch."""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

# Fraction of host cores given to reducers when num_reducers is not set.
REDUCER_HOST_CORE_SHARE = 0.6


def default_num_reducers(num_trainers: int,
                         num_cpus: Optional[int] = None) -> int:
    """num_trainers * host_cpus * REDUCER_HOST_CORE_SHARE, at least 1."""
    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
    return max(1, int(num_trainers * num_cpus * REDUCER_HOST_CORE_SHARE))


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means ``torch.device("cuda")`` and raises when CUDA is
    absent; anything else is taken as given (``"cpu"`` in the tests)."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the "
                "host")
        return torch.device("cuda")
    return torch.device(device)
