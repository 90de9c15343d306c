"""PyTorch/CUDA port of the shuffling data loader, for NVIDIA Hopper.

A second package beside ``ray_shuffling_data_loader_tpu`` (the JAX
reference, which it never imports). It carries the DLRM train path end to
end: Parquet -> seeded map/reduce shuffle (``shuffle``) -> per-rank queue
(``multiqueue``) -> exact re-batching (``dataset``) -> staged host-to-device
copies (``device_dataset``) -> DLRM (``models``) with a hand-written CUDA
embedding row gather (``ops.embedding``, ``kernels/gather.cu``) -> Adam
(``train``).

Entry points take ``device=None``, meaning ``torch.device("cuda")``, and
raise when CUDA is absent; pass ``device="cpu"`` to run on the host, where
each kernel's plain PyTorch version stands in.

Importing this package imports no submodule; import what you use. The
one exception is opt-in: with ``RSDL_LOCKSAN=1`` in the environment it
first loads ``runtime/locksan.py`` by path (not through ``runtime``, so
that nothing else of the package allocates a lock first) and arms the
runtime lock sanitizer over every lock the port then allocates.
"""

import os as _os

if _os.environ.get("RSDL_LOCKSAN") == "1":
    import importlib.util as _ilu
    import sys as _sys

    _LOCKSAN_NAME = __name__ + ".runtime.locksan"
    if _LOCKSAN_NAME not in _sys.modules:
        _spec = _ilu.spec_from_file_location(
            _LOCKSAN_NAME, _os.path.join(_os.path.dirname(__file__),
                                         "runtime", "locksan.py"))
        _locksan = _ilu.module_from_spec(_spec)
        # Registered under its canonical name, so a later
        # ``from ...runtime import locksan`` reuses this module and its
        # records instead of loading a fresh, unpatched copy.
        _sys.modules[_LOCKSAN_NAME] = _locksan
        _spec.loader.exec_module(_locksan)
    _sys.modules[_LOCKSAN_NAME].arm_from_env()

__version__ = "0.1.0"
