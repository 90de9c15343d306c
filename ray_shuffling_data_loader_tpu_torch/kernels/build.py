"""Build and bind the port's CUDA kernels.

``kernels/*.cu`` expose a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds). They are compiled for ``sm_90a`` at first use by
``torch.utils.cpp_extension.load`` into ``kernels/_build/`` inside the
package (listed in ``.gitignore``), then bound with ``ctypes``. A build
failure raises: no caller falls back to a plain PyTorch version when a card
is present.
"""

from __future__ import annotations

import ctypes
import os
import threading

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
GATHER_SOURCE = os.path.join(KERNEL_DIR, "gather.cu")

#: nvcc flags: Hopper's arch-specific target, full optimisation.
CUDA_FLAGS = ["-O3", "-std=c++17",
              "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_gather_lib = None


def _compile(name: str, source: str) -> str:
    """Compile ``source`` into a shared library; returns its path."""
    from torch.utils import cpp_extension
    os.makedirs(BUILD_DIR, exist_ok=True)
    return cpp_extension.load(
        name=name, sources=[source], build_directory=BUILD_DIR,
        extra_cuda_cflags=CUDA_FLAGS, is_python_module=False,
        verbose=False)


def gather_library() -> ctypes.CDLL:
    """The gather kernel's library, built on first call and cached."""
    global _gather_lib
    with _lock:
        if _gather_lib is None:
            path = _compile("rsdl_torch_gather", GATHER_SOURCE)
            lib = ctypes.CDLL(path)
            lib.rsdl_gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            lib.rsdl_gather_rows.restype = ctypes.c_int
            lib.rsdl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rsdl_cuda_error_string.restype = ctypes.c_char_p
            _gather_lib = lib
        return _gather_lib
