"""Where dataset bytes live (own copy of the JAX package's
``storage/source.py``): one :class:`StorageSource` contract and three
sources behind it.

``LocalSource``
    :func:`utils.fileio.read_parquet`: the local mmap fast path, and
    pyarrow or fsspec filesystems for URIs.
``HTTPRangeSource``
    Range reads from any static HTTP(S) file server with stdlib
    ``http.client``; transient failures retry under the ``storage``
    retry policy.
``SimulatedObjectStore``
    Local files behind a remote-latency model: first-byte latency,
    bandwidth, multiplicative jitter and a transient error rate, every
    draw a pure function of ``(seed, path, attempt)``, so one seed gives
    the same stalls and errors on any host.

Reads go through :func:`storage.read_table` / :func:`storage.open_parquet`,
where the ``storage_read`` and ``storage_stall`` fault sites fire,
outside the in-place retry.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.utils import fileio


def _remote_bytes():
    return rt_metrics.counter("rsdl_storage_remote_bytes_read_total",
                              "bytes fetched from the remote storage tier")


class StorageSource:
    """Where dataset bytes come from. Sources are thread-safe and
    deterministic: ``read_table`` of one path gives equal tables on every
    call, which is what makes a refetch after a lost cache entry
    invisible in the stream."""

    #: Tier label in logs ("local", "http", "sim").
    name: str = "source"

    def read_table(self, path: str) -> pa.Table:
        """Fetch and decode one Parquet object."""
        raise NotImplementedError

    def open_parquet(self, path: str) -> pq.ParquetFile:
        """A :class:`pq.ParquetFile` over the object, for the streaming
        map's record-batch reader."""
        raise NotImplementedError

    def read_bytes(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        """A byte range of the object (``length`` None: to the end)."""
        raise NotImplementedError

    def size(self, path: str) -> int:
        """The object's size in bytes, 0 if it does not exist."""
        raise NotImplementedError


class LocalSource(StorageSource):
    """Filesystem (and pyarrow/fsspec URI) reads."""

    name = "local"

    def read_table(self, path: str) -> pa.Table:
        return fileio.read_parquet(path)

    def open_parquet(self, path: str) -> pq.ParquetFile:
        fs, inner = fileio.parse_uri(path)
        if fs is None:
            return pq.ParquetFile(inner)
        return pq.ParquetFile(fs.open_input_file(inner))

    def read_bytes(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        fs, inner = fileio.parse_uri(path)
        if fs is None:
            with open(inner, "rb") as f:
                f.seek(offset)
                return f.read() if length is None else f.read(length)
        with fs.open_input_file(inner) as f:
            f.seek(offset)
            return f.read() if length is None else f.read(length)

    def size(self, path: str) -> int:
        return fileio.file_size(path)


class HTTPRangeSource(StorageSource):
    """GET with a ``Range:`` header against any HTTP(S) file server: one
    kept-alive connection per thread; socket errors and 5xx replies retry
    under the ``storage`` retry policy, 4xx replies raise
    ``FileNotFoundError``. Paths resolve against ``base_url``, so a run's
    file names stay relative."""

    name = "http"

    def __init__(self, base_url: str,
                 retry: Optional[rt_retry.RetryPolicy] = None):
        import urllib.parse
        parsed = urllib.parse.urlsplit(base_url)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"HTTPRangeSource wants http(s), "
                             f"got {base_url!r}")
        self._scheme = parsed.scheme
        self._netloc = parsed.netloc
        self._prefix = parsed.path.rstrip("/")
        self._retry = retry or rt_retry.RetryPolicy.for_component(
            "storage", retryable=rt_retry.transient_retryable)
        self._local = threading.local()
        self._bytes_lock = threading.Lock()
        self.bytes_read = 0

    def _conn(self):
        import http.client
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self._scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(self._netloc, timeout=60)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            finally:
                self._local.conn = None

    def _request(self, method: str, path: str,
                 headers: Optional[Dict[str, str]] = None):
        conn = self._conn()
        try:
            conn.request(method, f"{self._prefix}/{path.lstrip('/')}",
                         headers=headers or {})
            resp = conn.getresponse()
        except (OSError, ConnectionError) as e:
            self._drop_conn()  # a stale keep-alive: the retry redials
            raise OSError(f"http {method} {path}: {e}") from e
        if resp.status >= 500:
            resp.read()
            raise OSError(f"http {method} {path}: server error "
                          f"{resp.status}")
        if resp.status >= 400:
            resp.read()
            raise FileNotFoundError(f"http {method} {path}: {resp.status}")
        return resp

    def _fetch(self, path: str, offset: int,
               length: Optional[int]) -> bytes:
        headers = {}
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        data = self._request("GET", path, headers).read()
        with self._bytes_lock:
            self.bytes_read += len(data)
        _remote_bytes().inc(len(data))
        return data

    def read_bytes(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        return self._retry.call(self._fetch, path, offset, length,
                                describe=f"http range {path}")

    def read_table(self, path: str) -> pa.Table:
        return pq.read_table(pa.BufferReader(self.read_bytes(path)))

    def open_parquet(self, path: str) -> pq.ParquetFile:
        # The whole object: the map reads every column anyway.
        return pq.ParquetFile(pa.BufferReader(self.read_bytes(path)))

    def size(self, path: str) -> int:
        def head() -> int:
            resp = self._request("HEAD", path)
            resp.read()
            return int(resp.headers.get("Content-Length", 0))
        try:
            return self._retry.call(head, describe=f"http head {path}")
        except FileNotFoundError:
            return 0


class SimulatedObjectStore(StorageSource):
    """Local files behind a deterministic remote-latency model.

    A fetch sleeps a first-byte latency plus ``size / bandwidth``, both
    scaled by a seeded jitter, and may raise a transient ``OSError`` at
    the error rate (which the read's retry absorbs, as a real remote
    blip). Every draw is a sha256 of ``(seed, salt, path, attempt)``: no
    RNG state, so a fixed seed replays the same sequence. The knobs are
    the policy keys ``storage_sim_*`` (``RSDL_STORAGE_SIM_FIRST_BYTE_MS``,
    ``_MB_PER_S``, ``_JITTER_PCT``, ``_ERROR_RATE``, ``_SEED``); keyword
    arguments override them."""

    name = "sim"

    def __init__(self, inner: Optional[StorageSource] = None,
                 first_byte_ms: Optional[float] = None,
                 mb_per_s: Optional[float] = None,
                 jitter_pct: Optional[float] = None,
                 error_rate: Optional[float] = None,
                 seed: Optional[int] = None,
                 sleep=time.sleep):
        def res(key, override):
            return rt_policy.resolve("storage", key, override=override)
        self._inner = inner or LocalSource()
        self.first_byte_ms = res("storage_sim_first_byte_ms", first_byte_ms)
        self.mb_per_s = res("storage_sim_mb_per_s", mb_per_s)
        self.jitter_pct = res("storage_sim_jitter_pct", jitter_pct)
        self.error_rate = res("storage_sim_error_rate", error_rate)
        self.seed = res("storage_sim_seed", seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._attempts: Dict[str, int] = {}
        self.bytes_read = 0
        self.fetches = 0

    def _draw(self, path: str, attempt: int, salt: str) -> float:
        """Uniform [0, 1) from a stable hash."""
        digest = hashlib.sha256(
            f"{self.seed}:{salt}:{path}:{attempt}".encode()).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64)

    def _next_attempt(self, path: str) -> int:
        with self._lock:
            attempt = self._attempts.get(path, 0)
            self._attempts[path] = attempt + 1
            return attempt

    def _simulate(self, path: str, nbytes: int) -> None:
        attempt = self._next_attempt(path)
        if (self.error_rate > 0
                and self._draw(path, attempt, "err") < self.error_rate):
            raise OSError(
                f"simulated object-store error for {path!r} "
                f"(attempt {attempt}, rate {self.error_rate:g})")
        jitter = 1.0 + (self.jitter_pct / 100.0) * (
            2.0 * self._draw(path, attempt, "lat") - 1.0)
        delay = self.first_byte_ms / 1000.0
        if self.mb_per_s > 0:
            delay += nbytes / (self.mb_per_s * 1e6)
        delay *= max(0.0, jitter)
        if delay > 0:
            self._sleep(delay)
        with self._lock:
            self.bytes_read += nbytes
            self.fetches += 1
        _remote_bytes().inc(nbytes)

    def read_table(self, path: str) -> pa.Table:
        self._simulate(path, self._inner.size(path))
        return self._inner.read_table(path)

    def open_parquet(self, path: str) -> pq.ParquetFile:
        # The whole object crosses the simulated wire, as over HTTP.
        return pq.ParquetFile(pa.BufferReader(self.read_bytes(path)))

    def read_bytes(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        data = self._inner.read_bytes(path, offset, length)
        self._simulate(path, len(data))
        return data

    def size(self, path: str) -> int:
        return self._inner.size(path)

    def reset(self) -> None:
        """Forget the attempt counters: replays the same draws."""
        with self._lock:
            self._attempts.clear()
            self.bytes_read = 0
            self.fetches = 0
