"""Parquet IO over local paths and remote URIs (own copy of the JAX
package's ``utils/fileio.py``).

Plain paths and ``file://`` URIs stay on the local fast path (the
compressed bytes memory-mapped); other schemes go through pyarrow's
native filesystems (``gs://``, ``s3://``, ``hdfs://``) and, for schemes
pyarrow does not know, fsspec (``memory://`` in the tests).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import pyarrow as pa
import pyarrow.parquet as pq


def parse_uri(path: str) -> Tuple[Optional["pa.fs.FileSystem"], str]:
    """``(filesystem, path within it)``; ``(None, local path)`` for a
    plain path or a ``file://`` URI."""
    if "://" not in path:
        return None, path
    scheme, rest = path.split("://", 1)
    if scheme == "file":
        return None, rest
    import pyarrow.fs as pafs
    try:
        return pafs.FileSystem.from_uri(path)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, ValueError):
        pass
    import fsspec
    fs, inner = fsspec.core.url_to_fs(path)
    return pafs.PyFileSystem(pafs.FSSpecHandler(fs)), inner


def read_parquet(path: str) -> pa.Table:
    """One Parquet file from a local path or a URI: row groups and
    columns decoded on threads, column-chunk reads coalesced, local files
    memory-mapped."""
    fs, inner = parse_uri(path)
    if fs is None:
        return pq.read_table(inner, use_threads=True, pre_buffer=True,
                             memory_map=True)
    return pq.read_table(inner, filesystem=fs, use_threads=True,
                         pre_buffer=True)


def write_parquet(table: pa.Table, path: str, **kwargs) -> None:
    """Write one Parquet file to a local path or a URI."""
    fs, inner = parse_uri(path)
    if fs is None:
        pq.write_table(table, inner, **kwargs)
    else:
        pq.write_table(table, inner, filesystem=fs, **kwargs)


def makedirs(path: str) -> None:
    """``mkdir -p`` on any filesystem (a no-op where directories are
    virtual, as in object stores)."""
    fs, inner = parse_uri(path)
    if fs is None:
        os.makedirs(inner, exist_ok=True)
        return
    try:
        fs.create_dir(inner, recursive=True)
    except (pa.ArrowNotImplementedError, OSError):
        pass


def join(base: str, *parts: str) -> str:
    """Path join that keeps ``/`` separators for a URI."""
    if "://" not in base:
        return os.path.join(base, *parts)
    return "/".join([base.rstrip("/"), *parts])


def listdir(path: str) -> List[str]:
    """Files under a directory or prefix, returned with the same scheme
    as ``path`` so that they round-trip through :func:`read_parquet`."""
    fs, inner = parse_uri(path)
    if fs is None:
        return sorted(
            os.path.join(inner, name) for name in os.listdir(inner))
    import pyarrow.fs as pafs
    scheme = path.split("://", 1)[0]
    infos = fs.get_file_info(pafs.FileSelector(inner, recursive=False))
    # info.path has no scheme; fsspec-backed filesystems report it with a
    # leading '/', native ones (gs/s3) as 'bucket/key': normalise both.
    return sorted(f"{scheme}://{info.path.lstrip('/')}" for info in infos
                  if info.type == pafs.FileType.File)


def file_size(path: str) -> int:
    """Bytes of ``path``; 0 if it does not exist."""
    fs, inner = parse_uri(path)
    if fs is None:
        return os.path.getsize(inner) if os.path.exists(inner) else 0
    import pyarrow.fs as pafs
    info = fs.get_file_info(inner)
    return info.size if info.type == pafs.FileType.File else 0


class _RemoteTextFile:
    """Buffered text writer for a remote URI. Object stores have no
    append, so ``mode='a'`` reads the existing object first and uploads
    the concatenation on close (the CSV reports of
    ``stats.process_stats`` are small)."""

    def __init__(self, fs, inner: str, mode: str):
        import io
        self._fs = fs
        self._inner = inner
        self._buf = io.StringIO()
        self._closed = False
        if "a" in mode:
            import pyarrow.fs as pafs
            if fs.get_file_info(inner).type == pafs.FileType.File:
                with fs.open_input_stream(inner) as f:
                    self._buf.write(f.read().decode())

    def write(self, text: str) -> int:
        return self._buf.write(text)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._fs.open_output_stream(self._inner) as f:
            f.write(self._buf.getvalue().encode())

    def __enter__(self) -> "_RemoteTextFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_text(path: str, mode: str = "w"):
    """Open a text file for writing on any filesystem. ``mode`` is
    ``'w'`` or ``'a'`` (a trailing ``'+'`` is ignored: the CSV writers
    never read back through the handle)."""
    fs, inner = parse_uri(path)
    if fs is None:
        return open(inner, mode.replace("+", ""), newline="")
    return _RemoteTextFile(fs, inner, mode)
