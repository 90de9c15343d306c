"""Build and bind the port's CUDA kernels.

``kernels/*.cu`` expose a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds). Each source is compiled for ``sm_90a`` at first
use, by ``nvcc`` into a shared library in ``kernels/_build/`` inside the
package (listed in ``.gitignore``) named by a hash of the source and the
flags, then bound with ``ctypes``. The hash covers every local header the
source includes (``#include "..."``, found beside the source or in
``kernels/``, which is on the include path), so a changed header rebuilds
the library. Libraries build independently (one lock each), so several can
be built at once from threads. A build failure
raises: no caller falls back to a plain PyTorch version when a card is
present. ``PTXAS_INFO`` keeps each build's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from typing import Callable, Dict, List

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
GATHER_SOURCE = os.path.join(KERNEL_DIR, "gather.cu")
FLASH_SOURCE = os.path.join(KERNEL_DIR, "flash_attention.cu")

#: nvcc flags: Hopper's arch-specific target, full optimisation.
CUDA_FLAGS = ["-O3", "-std=c++17",
              "-gencode=arch=compute_90a,code=sm_90a"]

#: ``-Xptxas -v`` output of each library built by this process, by name.
PTXAS_INFO: Dict[str, str] = {}

_locks = {"rsdl_torch_gather": threading.Lock(),
          "rsdl_torch_flash": threading.Lock()}
_libs: Dict[str, ctypes.CDLL] = {}

_p, _i, _i64, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)


def _nvcc() -> str:
    from torch.utils import cpp_extension
    home = cpp_extension.CUDA_HOME or os.environ.get("CUDA_HOME")
    if not home:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is not set)")
    return os.path.join(home, "bin", "nvcc")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_sources(source: str) -> List[str]:
    """``source`` and every local header it includes (``#include "..."``),
    directly or through another header, each found beside the file that
    includes it or in ``kernels/``. Raises where a header is in neither
    place."""
    pending, found = [os.path.abspath(source)], []
    while pending:
        path = pending.pop()
        if path in found:
            continue
        found.append(path)
        with open(path, "rb") as f:
            names = _LOCAL_INCLUDE.findall(f.read())
        for name in names:
            candidates = [os.path.join(folder, name.decode()) for folder in
                          (os.path.dirname(path), KERNEL_DIR)]
            header = next((c for c in candidates if os.path.exists(c)), None)
            if header is None:
                raise FileNotFoundError(
                    f"{path} includes {name.decode()!r}, found neither "
                    f"beside it nor in {KERNEL_DIR}")
            pending.append(os.path.abspath(header))
    return found


def _source_digest(source: str) -> str:
    """sha256 of the flags and of :func:`local_sources`."""
    digest = hashlib.sha256(" ".join(CUDA_FLAGS).encode())
    for path in local_sources(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def library_path(name: str, source: str) -> str:
    """Where the library ``name`` built from ``source`` (as it and its
    headers read now) lives."""
    return os.path.join(BUILD_DIR,
                        f"lib{name}-{_source_digest(source)[:16]}.so")


def _compile(name: str, source: str) -> str:
    """Compile ``source`` into a shared library; returns its path."""
    path = library_path(name, source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *CUDA_FLAGS, "-Xptxas=-v", f"-I{KERNEL_DIR}", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source} "
                           f"(rc {proc.returncode}):\n{proc.stderr[-8000:]}")
    PTXAS_INFO[name] = proc.stderr
    os.replace(tmp, path)
    return path


def _library(name: str, source: str,
             bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _locks[name]:
        if name not in _libs:
            lib = ctypes.CDLL(_compile(name, source))
            lib.rsdl_cuda_error_string.argtypes = [_i]
            lib.rsdl_cuda_error_string.restype = ctypes.c_char_p
            bind(lib)
            _libs[name] = lib
        return _libs[name]


#: Most tables one gather launch takes (``kMaxGroups`` in gather.cu).
GATHER_MAX_GROUPS = 32


class GatherGroup(ctypes.Structure):
    """One table of a gather launch: ``RsdlGatherGroup`` in gather.cu,
    whose ``static_assert``s state the layout this must match."""
    _fields_ = [("table", _p), ("idx", _p), ("out", _p),
                ("vocab", _i64), ("out_stride", _i64),
                ("idx_code", ctypes.c_int32), ("reserved", ctypes.c_int32)]


class GatherArgs(ctypes.Structure):
    """The gather kernel's by-value parameter: ``RsdlGatherArgs``."""
    _fields_ = [("group", GatherGroup * GATHER_MAX_GROUPS),
                ("batch", _i64), ("embed", _i64),
                ("num_groups", ctypes.c_int32), ("out_code", ctypes.c_int32)]


def _bind_gather(lib: ctypes.CDLL) -> None:
    lib.rsdl_gather_rows.argtypes = [ctypes.POINTER(GatherArgs), _p]
    lib.rsdl_gather_rows.restype = _i


def _bind_flash(lib: ctypes.CDLL) -> None:
    # Pointers, then b, h, sq, sk, d, scale and the stream.
    shape = [_i64, _i64, _i64, _i64, _i, _f, _p]
    lib.rsdl_flash_fwd.argtypes = [_p] * 6 + shape
    lib.rsdl_flash_dq.argtypes = [_p] * 8 + shape
    lib.rsdl_flash_dkv.argtypes = [_p] * 10 + shape
    for fn in (lib.rsdl_flash_fwd, lib.rsdl_flash_dq, lib.rsdl_flash_dkv):
        fn.restype = _i


def gather_library() -> ctypes.CDLL:
    """The gather kernel's library, built on first call and cached."""
    return _library("rsdl_torch_gather", GATHER_SOURCE, _bind_gather)


def flash_library() -> ctypes.CDLL:
    """The three flash-attention kernels' library, built on first call and
    cached."""
    return _library("rsdl_torch_flash", FLASH_SOURCE, _bind_flash)
