"""The port's native host library (``native/__init__.py`` over
``native/src/shuffle_native.cpp``) against the JAX package's library and
against each kernel's plain NumPy version (``partition.py``, numpy
indexing, ``zlib``), bit for bit; the buffer ledger and the release
channel; the library build; and the transport's native pump both ways
between the port and the JAX package.

Inputs come from ``np.random.default_rng`` with fixed seeds.
"""

import gc
import os
import socket
import threading
import time
import zlib

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import native as jnative
from ray_shuffling_data_loader_tpu.parallel import transport as jtp
from ray_shuffling_data_loader_tpu_torch import native as tnative
from ray_shuffling_data_loader_tpu_torch import partition as tpart
from ray_shuffling_data_loader_tpu_torch.native import image as timage
from ray_shuffling_data_loader_tpu_torch.parallel import transport as ttp
from ray_shuffling_data_loader_tpu_torch.runtime import release

RECV_TIMEOUT_S = 30.0


@pytest.mark.parametrize("num_rows,num_reducers,nthreads",
                         [(0, 3, 1), (1000, 7, 1), (200_000, 16, 4)])
def test_plan_partition_flat_equals_jax_and_plain(num_rows, num_reducers,
                                                  nthreads):
    key = tpart.partition_key(11, 2, 5)
    flat, offsets = tnative.plan_partition_flat(num_rows, num_reducers, key,
                                                nthreads=nthreads)
    jflat, joffsets = jnative.plan_partition_flat(num_rows, num_reducers,
                                                  key, nthreads=nthreads)
    pflat, poffsets = tpart.plan_partition_flat(num_rows, num_reducers, 11,
                                                2, 5)
    for a, b in ((flat, jflat), (flat, pflat), (offsets, joffsets),
                 (offsets, poffsets)):
        np.testing.assert_array_equal(a, b)
    assert flat.dtype == pflat.dtype == np.int64


@pytest.mark.parametrize("row0", [0, 70_001])
def test_partition_counts_equal_jax_and_plain(row0):
    key = tpart.partition_key(3, 1, 0)
    got = tnative.partition_counts(100_000, 9, key, row0=row0, nthreads=4)
    np.testing.assert_array_equal(
        got, jnative.partition_counts(100_000, 9, key, row0=row0))
    np.testing.assert_array_equal(
        got, tpart.partition_counts(100_000, 9, 3, 1, 0, row0=row0))


@pytest.mark.parametrize("batches", [[5000], [700, 1300, 2000, 1000]])
def test_assign_dest_equals_jax_and_plain(batches):
    num_reducers, total = 6, sum(batches)
    counts = tpart.partition_counts(total, num_reducers, 4, 0, 2)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    native_cursors, jax_cursors, plain_cursors = (start.copy(),
                                                  start.copy(), start.copy())
    key = tpart.partition_key(4, 0, 2)
    row0 = 0
    seen = []
    for n in batches:
        got = tnative.assign_dest(n, num_reducers, key, row0, native_cursors)
        want = jnative.assign_dest(n, num_reducers, key, row0, jax_cursors)
        plain = tpart.assign_dest_batch(n, num_reducers, 4, 0, 2, row0,
                                        plain_cursors)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
        seen.append(got)
        row0 += n
    np.testing.assert_array_equal(native_cursors, plain_cursors)
    # The slots are the counting sort's layout: flat[dest] = row.
    flat, _ = tpart.plan_partition_flat(total, num_reducers, 4, 0, 2)
    layout = np.empty(total, np.int64)
    layout[np.concatenate(seen)] = np.arange(total)
    np.testing.assert_array_equal(layout, flat)


def test_partition_indices_equals_jax_and_stable_sort():
    assignments = np.random.default_rng(0).integers(0, 5, 10_000,
                                                    dtype=np.uint32)
    got = tnative.partition_indices(assignments, 5)
    want = jnative.partition_indices(assignments, 5)
    order = np.argsort(assignments, kind="stable")
    np.testing.assert_array_equal(np.concatenate(got), order)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tnative.partition_indices(np.array([0, 9], np.uint32), 5)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32,
                                   np.int64])
@pytest.mark.parametrize("with_idx", [False, True])
def test_scatter_gather_equals_numpy(dtype, with_idx):
    rng = np.random.default_rng(1)
    n = 70_000  # above the kernel's threading floor
    src = rng.integers(0, 100, n).astype(dtype)
    dest = rng.permutation(n).astype(np.int32)
    idx = rng.permutation(n).astype(np.int32) if with_idx else None
    out = np.zeros(n, dtype)
    tnative.scatter_gather(src, idx, dest, out, nthreads=4)
    want = np.zeros(n, dtype)
    want[dest] = src if idx is None else src[idx]
    np.testing.assert_array_equal(out, want)
    jout = np.zeros(n, dtype)
    jnative.scatter_gather(src, idx, dest, jout, nthreads=4)
    np.testing.assert_array_equal(out, jout)


def test_crc32_chains_like_zlib_and_equals_jax():
    data = np.random.default_rng(2).bytes(1 << 20)
    crc = 0
    for lo in range(0, len(data), 300_001):
        crc = tnative.crc32(data[lo:lo + 300_001], crc)
    assert crc == zlib.crc32(data) == jnative.crc32(data)
    assert tnative.crc32(b"") == 0
    assert tnative.crc32(b"abc", 7) == zlib.crc32(b"abc", 7)


@pytest.fixture
def no_collections():
    """No cyclic collection while a test reads the process-wide ledger
    (another test's garbage would release its bytes in the middle)."""
    gc.collect()
    gc.disable()
    yield
    gc.enable()


def test_ledger_register_decref_and_trim(no_collections):
    ledger = tnative.buffer_ledger()
    ledger.trim_freelist()
    base, count = ledger.bytes_in_use(), ledger.buffer_count()
    ledger.reset_peak()
    a = ledger.register(1000)
    b = ledger.alloc(10_000)  # charged its 16 KiB size class
    assert ledger.bytes_in_use() == base + 1000 + 16384
    assert ledger.buffer_count() == count + 2
    assert ledger.peak_bytes() >= base + 1000 + 16384
    assert ledger.incref(a) == 2
    assert ledger.decref(a) == 1
    assert ledger.decref(a) == 0
    with pytest.raises(KeyError):
        ledger.decref(a)
    with pytest.raises(KeyError):
        ledger.view(ledger.register(1))  # accounting-only: no memory
    assert ledger.view(b).nbytes == 10_000
    ledger.decref(b)
    assert ledger.freelist_bytes() >= 16384  # the block is kept for reuse
    ledger.trim_freelist()
    assert ledger.freelist_bytes() == 0


def test_account_table_and_tracked_buffer_release_on_collect(monkeypatch):
    import pyarrow as pa
    # Entries are followed by id: other tests' objects may be collected
    # (and their bytes released) by the collections below.
    made, released = {}, []
    register, alloc, decref = (tnative.NativeBufferPool.register,
                               tnative.NativeBufferPool.alloc,
                               tnative.NativeBufferPool.decref)

    def spy(method, size_of):
        def wrapper(self, size):
            buf_id = method(self, size)
            made[buf_id] = size_of(size)
            return buf_id
        return wrapper

    monkeypatch.setattr(tnative.NativeBufferPool, "register",
                        spy(register, lambda n: n))
    monkeypatch.setattr(tnative.NativeBufferPool, "alloc",
                        spy(alloc, lambda n: n))
    monkeypatch.setattr(tnative.NativeBufferPool, "decref",
                        lambda self, i: released.append(i) or decref(self, i))
    table = pa.table({"x": np.arange(100_000, dtype=np.int64)})
    tnative.account_table(table)
    (table_id,) = made
    assert made[table_id] == table.nbytes
    seq = release.release_seq()
    del table
    gc.collect()
    assert table_id in released
    assert release.release_seq() > seq  # the last decref notified
    buf = tnative.alloc_tracked_buffer(5000)
    (buf_id,) = set(made) - {table_id}
    view = memoryview(buf)
    del buf
    gc.collect()
    assert buf_id not in released  # the view pins it
    del view
    gc.collect()
    assert buf_id in released


def test_release_wakes_wait_while_within_50ms():
    ledger = tnative.buffer_ledger()
    base = ledger.bytes_in_use()
    buf_id = ledger.register(1 << 20)
    woke = {}

    def waiter():
        start = time.monotonic()
        woke["ok"] = release.wait_while(
            lambda: ledger.bytes_in_use() > base, timeout_s=10.0,
            heartbeat_s=5.0)
        woke["at"] = time.monotonic()
        woke["waited"] = woke["at"] - start

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)  # the waiter is blocked on its 5 s heartbeat
    released_at = time.monotonic()
    ledger.decref(buf_id)
    t.join(timeout=10)
    assert woke["ok"]
    assert woke["at"] - released_at < 0.05
    assert not release.wait_while(lambda: True, timeout_s=0.05,
                                  heartbeat_s=0.01)


def test_frame_send_and_read_exact_over_a_socket_pair():
    a, b = socket.socketpair()
    try:
        payload = np.random.default_rng(3).bytes(3 << 20)
        sender = threading.Thread(target=tnative.frame_send,
                                  args=(a.fileno(), b"HEAD", payload))
        sender.start()
        head = np.empty(4, np.uint8)
        assert tnative.read_exact_into(b.fileno(), head, 4)
        body = tnative.alloc_tracked_buffer(len(payload))
        assert tnative.read_exact_into(b.fileno(), body, len(payload))
        sender.join(timeout=10)
        assert head.tobytes() == b"HEAD" and body.tobytes() == payload
        a.close()
        assert not tnative.read_exact_into(b.fileno(), head, 4)  # clean EOF
    finally:
        a.close()
        b.close()


def test_native_pump_3mb_payloads_both_ways_with_the_jax_transport():
    addresses = [("127.0.0.1", 0)] * 2
    port = ttp.TcpTransport(0, addresses, recv_timeout_s=RECV_TIMEOUT_S)
    jax_side = jtp.TcpTransport(1, addresses, recv_timeout_s=RECV_TIMEOUT_S)
    pair = [port, jax_side]
    try:
        for t in pair:
            t.start()
        bound = [("127.0.0.1", t.bound_port()) for t in pair]
        for t in pair:
            t.addresses = bound
            t.connect()
        big = np.random.default_rng(4).bytes(3 << 20)
        port.send(1, (0, 1, 2), big)
        jax_side.send(0, (0, 1, 2), big[::-1])
        port.send(1, (0, 2, 2), b"small")
        assert bytes(jax_side.recv(0, (0, 1, 2))) == big
        assert bytes(jax_side.recv(0, (0, 2, 2))) == b"small"
        got = port.recv(1, (0, 1, 2))
        assert isinstance(got, memoryview) and bytes(got) == big[::-1]
        stats = port.stats()
        assert (stats["frames_sent"], stats["frames_sent_native"]) == (2, 1)
        assert stats["bytes_sent_native"] == len(big)
        assert stats["bytes_sent"] == len(big) + 5
        assert (stats["frames_received_native"],
                stats["bytes_received_native"]) == (1, len(big))
    finally:
        for t in pair:
            t.close()


def test_libraries_are_digest_named_and_a_failed_build_raises(monkeypatch,
                                                              tmp_path):
    path = tnative.library_path()
    assert os.path.basename(path).startswith("libshuffle_native-")
    tnative.library()
    assert os.path.exists(path)
    assert os.path.dirname(timage.library_path()) == tnative.BUILD_DIR
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build_library(tnative.SOURCE, "libbroken",
                              tnative.CXX_FLAGS + ["-DNO", "-Werror=bogus"],
                              [], str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "CXX_FLAGS", ["-definitely-not-a-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.crc32(b"x")
