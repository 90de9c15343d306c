"""Parquet IO over local paths and remote URIs (own copy of the JAX
package's ``utils/fileio.py``).

Plain paths and ``file://`` URIs stay on the local fast path (the
compressed bytes memory-mapped); other schemes go through pyarrow's
native filesystems (``gs://``, ``s3://``, ``hdfs://``) and, for schemes
pyarrow does not know, fsspec (``memory://`` in the tests).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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


def file_size(path: str) -> int:
    """Bytes of ``path``; 0 if it does not exist."""
    fs, inner = parse_uri(path)
    if fs is None:
        return os.path.getsize(inner) if os.path.exists(inner) else 0
    import pyarrow.fs as pafs
    info = fs.get_file_info(inner)
    return info.size if info.type == pafs.FileType.File else 0
