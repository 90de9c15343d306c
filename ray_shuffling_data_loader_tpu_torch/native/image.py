"""Threaded libjpeg/libpng batch image decoder (``src/image_decode.cpp``).

The port's own copy of the JAX package's native decoder. It is built with
``g++`` at first use into ``native/_build/`` (listed in ``.gitignore``) by
the package's builder (:func:`native.build_library`: named by a hash of
the source and the flags), and bound with ``ctypes``.
Unlike the JAX package's loader it never gives way quietly: a failed
build or load raises, and ``workloads.imagenet.decode_transform`` takes
the decoder by name. :func:`missing_prerequisites` says beforehand whether
a host can build it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from ray_shuffling_data_loader_tpu_torch.native import (build_library,
                                                        library_file)

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
SOURCE = os.path.join(NATIVE_DIR, "src", "image_decode.cpp")

#: g++ flags; the codec libraries are linked after the source.
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
LIBS = ["-ljpeg", "-lpng"]

#: Decode threads per call (one call per reducer output).
DEFAULT_THREADS = max(1, min(8, os.cpu_count() or 1))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the library built from :data:`SOURCE` as it reads now lives."""
    return library_file(SOURCE, "libimage_decode", CXX_FLAGS, LIBS,
                        BUILD_DIR)


def missing_prerequisites() -> List[str]:
    """What this host lacks to build the decoder: ``"g++"``, ``"png.h"``,
    ``"jpeglib.h"`` (each header looked up by ``g++`` itself). Empty when
    the build can run."""
    if shutil.which("g++") is None:
        return ["g++"]
    missing = []
    for header in ("png.h", "jpeglib.h"):
        proc = subprocess.run(
            ["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
            input=f"#include <{header}>\n", capture_output=True, text=True,
            timeout=60, check=False)
        if proc.returncode != 0:
            missing.append(header)
    return missing


def _build() -> str:
    return build_library(SOURCE, "libimage_decode", CXX_FLAGS, LIBS,
                         BUILD_DIR)


def library() -> ctypes.CDLL:
    """The decoder's library, built on first call and cached; raises
    ``RuntimeError`` where it cannot be built and ``OSError`` where it
    cannot be loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.rsdl_decode_images.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
            lib.rsdl_decode_images.restype = ctypes.c_int64
            _lib = lib
        return _lib


def decode_batch(payloads: Sequence[bytes], height: int, width: int,
                 nthreads: Optional[int] = None) -> np.ndarray:
    """Decode JPEG/PNG payloads into one ``(n, height * width * 3)`` uint8
    RGB array. Raises ``ValueError`` naming the first payload that failed
    to decode or did not have the shape."""
    lib = library()
    n = len(payloads)
    out = np.empty((n, height * width * 3), dtype=np.uint8)
    if n == 0:
        return out
    srcs = (ctypes.c_char_p * n)(*payloads)
    sizes = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=n)
    rc = lib.rsdl_decode_images(
        srcs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        height, width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nthreads or DEFAULT_THREADS)
    if rc != 0:
        raise ValueError(
            f"image {rc - 1} failed to decode to ({height}, {width}, 3): "
            "an unsupported format or other dimensions")
    return out
