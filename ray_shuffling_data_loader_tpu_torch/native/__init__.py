"""Native (C++) host kernels of the shuffle, loaded via ctypes.

The port's own copy of the JAX package's ``native/__init__.py`` over its
own copy of ``src/shuffle_native.cpp``. The library is built with ``g++``
at first use into ``native/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, so processes that build at once never
load a half-written file. Unlike the JAX package's loader there is no
NumPy fallback at run time: a failed build or load raises. The NumPy
versions of the partition kernels stay in ``partition.py`` as their plain
versions, which the tests hold these against.

What lives here:

- the partition plan (``plan_partition_flat``, ``partition_counts``,
  ``assign_dest``, ``partition_indices``) and the reduce's fused
  ``scatter_gather``;
- ``crc32`` (zlib-compatible; the spill files' checksum);
- the buffer ledger (:class:`NativeBufferPool`, :func:`buffer_ledger`,
  :func:`account_table`, :func:`trim_freelist`): every decoded table, map
  output, reducer output and transport receive buffer is charged to it
  for the lifetime of its Python handle, and the memory budget reads it.
  A last-reference release wakes budget waiters (``runtime/release.py``);
- the transport's pump (:func:`frame_send`, :func:`read_exact_into`,
  :func:`alloc_tracked_buffer`);
- the seeded xoshiro256** fills of the generated data
  (:func:`fill_random_int64`, :func:`fill_random_double`), the JAX
  package's, so a seed gives the same columns in both packages.

:func:`build_library` is also the builder of ``native/image.py``.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import subprocess
import threading
import weakref
import zlib
from typing import List, Optional, Sequence

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
SOURCE = os.path.join(NATIVE_DIR, "src", "shuffle_native.cpp")

# No -march=native: a library built on one host must load on another of
# the same architecture (the integer kernels gain nothing from it).
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_file(source: str, stem: str, flags: Sequence[str],
                 libs: Sequence[str], build_dir: str) -> str:
    """Where the library built from ``source`` as it reads now, with these
    flags, lives: ``<build_dir>/<stem>-<digest>.so``."""
    digest = hashlib.sha256(" ".join(list(flags) + list(libs)).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_library(source: str, stem: str, flags: Sequence[str],
                  libs: Sequence[str], build_dir: str) -> str:
    """Build ``source`` with ``g++`` unless its digest-named library is
    there already; returns its path. The compiler writes a file of its own
    that is then renamed into place, so concurrent builds (threads or
    processes) are safe. Raises ``RuntimeError`` where ``g++`` cannot run
    or fails."""
    path = library_file(source, stem, flags, libs, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *flags, source, "-o", tmp, *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, check=False)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {source}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {source} "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def library_path() -> str:
    """The shuffle library's path for :data:`SOURCE` as it reads now."""
    return library_file(SOURCE, "libshuffle_native", CXX_FLAGS, [],
                        BUILD_DIR)


def _bind(lib: ctypes.CDLL) -> None:
    i64, u64, u32p, i64p = (ctypes.c_int64, ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_int64))
    lib.rsdl_partition_indices.argtypes = [u32p, i64, i64, i64p, i64p]
    lib.rsdl_partition_indices.restype = ctypes.c_int
    lib.rsdl_plan_partition.argtypes = [i64, i64, u64, i64p, i64p,
                                        ctypes.c_int]
    lib.rsdl_plan_partition.restype = ctypes.c_int
    lib.rsdl_partition_counts.argtypes = [i64, i64, u64, i64, i64p,
                                          ctypes.c_int]
    lib.rsdl_partition_counts.restype = ctypes.c_int
    lib.rsdl_assign_dest.argtypes = [i64, i64, u64, i64, i64p,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.rsdl_assign_dest.restype = ctypes.c_int
    lib.rsdl_crc32.argtypes = [ctypes.c_void_p, i64, ctypes.c_uint32]
    lib.rsdl_crc32.restype = ctypes.c_uint32
    lib.rsdl_scatter_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        i64, ctypes.c_int32, ctypes.c_int]
    lib.rsdl_scatter_gather.restype = ctypes.c_int
    lib.rsdl_buffer_alloc.argtypes = [i64]
    lib.rsdl_buffer_alloc.restype = i64
    lib.rsdl_buffer_register.argtypes = [i64]
    lib.rsdl_buffer_register.restype = i64
    lib.rsdl_buffer_data.argtypes = [i64]
    lib.rsdl_buffer_data.restype = ctypes.c_void_p
    lib.rsdl_buffer_size.argtypes = [i64]
    lib.rsdl_buffer_size.restype = i64
    lib.rsdl_buffer_incref.argtypes = [i64]
    lib.rsdl_buffer_incref.restype = i64
    lib.rsdl_buffer_decref.argtypes = [i64]
    lib.rsdl_buffer_decref.restype = i64
    lib.rsdl_buffer_bytes_in_use.argtypes = []
    lib.rsdl_buffer_bytes_in_use.restype = i64
    lib.rsdl_buffer_count.argtypes = []
    lib.rsdl_buffer_count.restype = i64
    lib.rsdl_frame_send.argtypes = [ctypes.c_int, ctypes.c_void_p, i64,
                                    ctypes.c_void_p, i64]
    lib.rsdl_frame_send.restype = ctypes.c_int
    lib.rsdl_read_exact.argtypes = [ctypes.c_int, ctypes.c_void_p, i64]
    lib.rsdl_read_exact.restype = i64
    lib.rsdl_buffer_trim_freelist.argtypes = []
    lib.rsdl_buffer_trim_freelist.restype = None
    lib.rsdl_buffer_freelist_bytes.argtypes = []
    lib.rsdl_buffer_freelist_bytes.restype = i64
    lib.rsdl_fill_random_int64.argtypes = [i64p, i64, i64, u64, ctypes.c_int]
    lib.rsdl_fill_random_int64.restype = None
    lib.rsdl_fill_random_double.argtypes = [
        ctypes.POINTER(ctypes.c_double), i64, u64, ctypes.c_int]
    lib.rsdl_fill_random_double.restype = None


def library() -> ctypes.CDLL:
    """The shuffle library, built on first call and cached; raises
    ``RuntimeError`` where it cannot be built and ``OSError`` where it
    cannot be loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library(SOURCE, "libshuffle_native",
                                            CXX_FLAGS, [], BUILD_DIR))
            _bind(lib)
            _lib = lib
        return _lib


# Fixed, so a seed's fill is the same on any host: the per-thread streams
# depend on this count, not on the host's cores (the JAX package's value).
FILL_THREADS = 8


def fill_random_int64(n: int, bound: int, seed: int) -> np.ndarray:
    """``n`` uniform int64 in ``[0, bound)`` from ``seed``, on
    :data:`FILL_THREADS` threads."""
    if bound < 1:
        raise ValueError(f"bound must be >= 1, got {bound}")
    out = np.empty(n, dtype=np.int64)
    library().rsdl_fill_random_int64(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, bound,
        seed & 0xFFFFFFFFFFFFFFFF, FILL_THREADS)
    return out


def fill_random_double(n: int, seed: int) -> np.ndarray:
    """``n`` uniform doubles in ``[0, 1)`` from ``seed`` (as
    :func:`fill_random_int64`)."""
    out = np.empty(n, dtype=np.float64)
    library().rsdl_fill_random_double(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        seed & 0xFFFFFFFFFFFFFFFF, FILL_THREADS)
    return out


def _notify_release() -> None:
    """Wake budget waiters blocked on ledger releases
    (``runtime/release.py``)."""
    from ray_shuffling_data_loader_tpu_torch.runtime import release
    release.notify_release()


def crc32(data, value: int = 0) -> int:
    """``zlib.crc32``-compatible checksum over any contiguous buffer, run
    by the native kernel without the GIL (``crc = crc32(chunk, crc)``
    chains as with zlib, so recorded checksums are valid in either)."""
    try:
        buf = np.frombuffer(data, dtype=np.uint8)
    except ValueError:  # non-contiguous or exotic buffer: zlib takes it
        return zlib.crc32(data, value)
    if buf.nbytes == 0:
        return value & 0xFFFFFFFF
    return int(library().rsdl_crc32(buf.ctypes.data, buf.nbytes,
                                    value & 0xFFFFFFFF))


def partition_indices(assignments: np.ndarray,
                      num_reducers: int) -> List[np.ndarray]:
    """O(n) stable counting-sort partition of row indices by reducer."""
    if num_reducers < 1:
        raise ValueError(f"num_reducers must be >= 1, got {num_reducers}")
    lib = library()
    assignments = np.asarray(assignments)
    if assignments.dtype != np.uint32:
        # Values that would wrap modulo 2**32 must raise, not
        # mis-partition.
        if assignments.size and (assignments.min() < 0
                                 or assignments.max() >= 2**32):
            raise ValueError(
                f"assignment value out of range for num_reducers={num_reducers}")
    assignments = np.ascontiguousarray(assignments, dtype=np.uint32)
    n = len(assignments)
    out = np.empty(n, dtype=np.int64)
    offsets = np.empty(num_reducers + 1, dtype=np.int64)
    rc = lib.rsdl_partition_indices(
        assignments.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
        num_reducers, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError(
            f"assignment value out of range for num_reducers={num_reducers}")
    return [out[offsets[r]:offsets[r + 1]] for r in range(num_reducers)]


def partition_counts(num_rows: int, num_reducers: int, key: int,
                     row0: int = 0, nthreads: int = 1) -> np.ndarray:
    """Per-reducer row counts for ``num_rows`` rows of the ``key`` hash
    stream starting at global row ``row0``: no data, no index array."""
    counts = np.empty(num_reducers, dtype=np.int64)
    rc = library().rsdl_partition_counts(
        num_rows, num_reducers, key & 0xFFFFFFFFFFFFFFFF, row0,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max(1, nthreads))
    if rc != 0:
        raise ValueError(
            f"invalid partition_counts arguments (num_rows={num_rows}, "
            f"num_reducers={num_reducers})")
    return counts


def assign_dest(num_rows: int, num_reducers: int, key: int, row0: int,
                cursors: np.ndarray) -> np.ndarray:
    """Destination slots for one record batch of the streaming map:
    ``dest[i] = cursors[assign(row0 + i)]++`` (cursors advance in place).
    int32 output; raises where a slot passes the int32 range."""
    assert cursors.dtype == np.int64 and cursors.flags.c_contiguous
    dest = np.empty(num_rows, dtype=np.int32)
    rc = library().rsdl_assign_dest(
        num_rows, num_reducers, key & 0xFFFFFFFFFFFFFFFF, row0,
        cursors.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dest.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(
            "assign_dest arguments invalid or destination exceeds int32 "
            f"(num_rows={num_rows}, num_reducers={num_reducers})")
    return dest


def plan_partition_flat(num_rows: int, num_reducers: int, key: int,
                        nthreads: int = 1
                        ) -> "tuple[np.ndarray, np.ndarray]":
    """The map's partition plan in one kernel: ``(indices, offsets)``,
    reducer ``r``'s rows ``indices[offsets[r]:offsets[r+1]]`` in original
    row order; the per-row assignment array is never materialized."""
    indices = np.empty(num_rows, dtype=np.int64)
    offsets = np.empty(num_reducers + 1, dtype=np.int64)
    rc = library().rsdl_plan_partition(
        num_rows, num_reducers, key & 0xFFFFFFFFFFFFFFFF,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max(1, nthreads))
    if rc != 0:
        raise ValueError(
            f"invalid plan_partition arguments (num_rows={num_rows}, "
            f"num_reducers={num_reducers})")
    return indices, offsets


def scatter_gather(src: np.ndarray, idx: Optional[np.ndarray],
                   dest: np.ndarray, out: np.ndarray,
                   nthreads: int = 1) -> None:
    """Fused ``out[dest] = src[idx]`` (``src[i]`` when ``idx`` is None)
    in one memory pass. ``dest`` entries must be unique; ``idx``/``dest``
    int32; ``src``/``out`` contiguous with one 1/2/4/8-byte item size."""
    n = len(dest)
    if idx is not None:
        assert idx.dtype == np.int32 and idx.flags.c_contiguous
        assert len(idx) == n
    assert dest.dtype == np.int32 and dest.flags.c_contiguous
    assert src.flags.c_contiguous and out.flags.c_contiguous
    assert src.dtype.itemsize == out.dtype.itemsize
    rc = library().rsdl_scatter_gather(
        src.ctypes.data, 0 if idx is None else idx.ctypes.data,
        dest.ctypes.data, out.ctypes.data, n, src.dtype.itemsize,
        nthreads)
    if rc != 0:
        raise ValueError(
            f"unsupported element size {src.dtype.itemsize} for "
            "native scatter_gather")


class NativeBufferPool:
    """Handle over the C++ ref-counted host buffer pool: the process-wide
    ledger of pipeline bytes. Two kinds of entries share it: ``alloc``
    (real 64-byte-aligned blocks, the transport's receive buffers) and
    ``register`` (accounting-only entries for bytes Arrow owns).

    ``peak_bytes`` is the most ``bytes_in_use`` has read at any
    ``alloc``/``register`` since :meth:`reset_peak` (the ledger only grows
    there, so no peak is missed)."""

    _peak_lock = threading.Lock()
    _peak = 0

    def _note(self) -> None:
        in_use = self.bytes_in_use()
        if in_use > NativeBufferPool._peak:
            with NativeBufferPool._peak_lock:
                NativeBufferPool._peak = max(NativeBufferPool._peak, in_use)

    def register(self, size: int) -> int:
        """Ledger-only entry for externally-allocated bytes."""
        if size < 0:
            raise ValueError(f"buffer size must be >= 0, got {size}")
        buf_id = library().rsdl_buffer_register(size)
        if buf_id == 0:
            raise MemoryError(f"native buffer register of {size} bytes failed")
        self._note()
        return buf_id

    def alloc(self, size: int) -> int:
        if size < 0:
            raise ValueError(f"buffer size must be >= 0, got {size}")
        buf_id = library().rsdl_buffer_alloc(size)
        if buf_id == 0:
            raise MemoryError(f"native buffer alloc of {size} bytes failed")
        self._note()
        return buf_id

    def view(self, buf_id: int) -> np.ndarray:
        """uint8 view of the buffer (no copy, no ownership transfer)."""
        lib = library()
        size = lib.rsdl_buffer_size(buf_id)
        if size < 0:
            raise KeyError(f"unknown buffer id {buf_id}")
        data = lib.rsdl_buffer_data(buf_id)
        if not data:
            # register()-created entries carry no memory.
            raise KeyError(f"buffer id {buf_id} is accounting-only")
        return np.ctypeslib.as_array(
            ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8)), shape=(size,))

    def incref(self, buf_id: int) -> int:
        count = library().rsdl_buffer_incref(buf_id)
        if count < 0:
            raise KeyError(f"unknown buffer id {buf_id}")
        return count

    def decref(self, buf_id: int) -> int:
        count = library().rsdl_buffer_decref(buf_id)
        if count < 0:
            raise KeyError(f"unknown buffer id {buf_id}")
        if count == 0:
            _notify_release()
        return count

    def bytes_in_use(self) -> int:
        return library().rsdl_buffer_bytes_in_use()

    def buffer_count(self) -> int:
        return library().rsdl_buffer_count()

    def freelist_bytes(self) -> int:
        """Bytes held in the size-class reuse cache (not in use)."""
        return library().rsdl_buffer_freelist_bytes()

    def trim_freelist(self) -> None:
        """Release every cached free-list block back to the OS."""
        library().rsdl_buffer_trim_freelist()
        _notify_release()

    def peak_bytes(self) -> int:
        with NativeBufferPool._peak_lock:
            return NativeBufferPool._peak

    def reset_peak(self) -> None:
        """Restart the peak from the bytes in use now. The ledger is read
        before the peak's lock is taken, so that lock stays a leaf: the
        callers that hold their own locks while they allocate (a queue's
        state, a spilled table, a pool task's finalizer) reach it with no
        order to keep."""
        in_use = self.bytes_in_use()
        with NativeBufferPool._peak_lock:
            NativeBufferPool._peak = in_use


def buffer_ledger() -> NativeBufferPool:
    """THE process-wide buffer ledger (file cache, map and reducer tables,
    transport receive buffers)."""
    return NativeBufferPool()


def trim_freelist() -> None:
    """Give the pool's recycled buffers back to the OS (end-of-trial
    hygiene of the shuffle drivers)."""
    buffer_ledger().trim_freelist()


def account_table(table) -> None:
    """Charge an Arrow table's bytes to the ledger for the lifetime of its
    Python wrapper (the handle every stage passes on, so 'wrapper alive'
    is 'bytes in flight')."""
    nbytes = table.nbytes
    if nbytes <= 0:
        return
    ledger = buffer_ledger()
    buf_id = ledger.register(nbytes)
    weakref.finalize(table, ledger.decref, buf_id)


def frame_send(fd: int, header, payload) -> None:
    """Send a frame (header then payload) as one ``writev`` stream outside
    the GIL; ``header``/``payload`` are contiguous buffer-protocol
    objects. Raises ``OSError`` on a socket error."""
    h = np.frombuffer(header, dtype=np.uint8)
    p = np.frombuffer(payload, dtype=np.uint8)
    rc = library().rsdl_frame_send(fd, h.ctypes.data, h.nbytes,
                                   p.ctypes.data, p.nbytes)
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc))


# RSDL_EEOF_MID_MESSAGE of shuffle_native.cpp: far outside the errno
# range, so a real EPIPE from read() stays distinguishable.
_EEOF_MID_MESSAGE = 1000000


def read_exact_into(fd: int, buf: np.ndarray, n: int) -> bool:
    """Read exactly ``n`` bytes from ``fd`` into ``buf`` in one GIL-free
    call. True on success, False on a clean EOF before the first byte;
    raises ``OSError`` on a socket error or an EOF mid-message."""
    assert buf.nbytes >= n and buf.flags.c_contiguous
    got = library().rsdl_read_exact(fd, buf.ctypes.data, n)
    if got == n:
        return True
    if got == 0:
        return False
    err = -got
    if err == _EEOF_MID_MESSAGE:
        raise OSError(errno.EPIPE, "peer closed connection mid-message")
    raise OSError(err, os.strerror(err))


def alloc_tracked_buffer(size: int) -> np.ndarray:
    """A pool-allocated uint8 buffer as an ndarray; its bytes go back to
    the pool when the array (and everything that references it:
    memoryviews, Arrow buffers over it) is collected."""
    ledger = buffer_ledger()
    buf_id = ledger.alloc(size)
    arr = ledger.view(buf_id)
    weakref.finalize(arr, ledger.decref, buf_id)
    return arr
