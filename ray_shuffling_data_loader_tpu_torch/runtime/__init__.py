"""Runtime health of the device binding (own copies of the JAX package's
``runtime/`` modules that ``device_dataset`` needs): the policy registry
(``policy``), the deadline watchdog (``watchdog``), the bounded retry
(``retry``) and seeded fault injection (``faults``); and the two
forensic tools, exported here as the JAX package exports them:

- :mod:`.locksan` — the opt-in (``RSDL_LOCKSAN=1``) runtime lock
  sanitizer: wraps port-allocated locks to record the actual
  acquisition-order graph and held-while-blocking events, the JSON
  artifact that ``--concurrency --locksan-graph`` cross-checks against
  the static lock-order graph;
- :mod:`.regress` — differential forensics between two bench rounds
  from their flight capsules (``python -m
  ray_shuffling_data_loader_tpu_torch.runtime.regress BASE CUR``).

Both load on first access (``runtime.locksan``, ``from ... import
regress``), not when this package is imported: the package's
``__init__`` loads ``locksan`` by path before anything allocates a lock,
and ``python -m`` runs either module without a second copy of it.
"""

import importlib

__all__ = ["locksan", "regress"]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
