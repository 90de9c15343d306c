"""The port's storage plane (``storage/``, ``utils/fileio.py``) against the
JAX package's, on the same files and seeds.

Mirrors the JAX package's ``tests/test_storage.py`` and
``tests/test_fileio.py``, each case run on both packages' classes: the
tiered store's promote, demote and eviction; a corrupt disk entry falling
through to a refetch equal bit for bit (also under a whole shuffle); the
``storage_read``/``storage_stall`` fault sites firing once per key with
the stream unchanged; prefetch accounting; a ``get`` joining a warm in
flight; the simulated object store's seeded draws (equal across the two
packages); ``HTTPRangeSource`` against a file server on a loopback
thread; a ``memory://`` round trip; and a tiered shuffle over the
simulated store with the idle-lane prefetch giving JAX's stream. Shuffles
run on the thread backend (the file cache is a thread-plane seam).
"""

import glob
import http.server
import importlib
import os
import threading

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import storage as jst
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.runtime import metrics as jmetrics
from ray_shuffling_data_loader_tpu.utils import fileio as jfileio
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch import storage as tst
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.utils import fileio as tfileio

jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

NUM_EPOCHS = 2
NUM_REDUCERS = 4
NUM_TRAINERS = 2
SEED = 17


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    """Threads, no chaos and the default source in both packages."""
    monkeypatch.setenv("RSDL_EXECUTOR_BACKEND", "thread")
    jprev, tprev = jst.set_source(None), tst.set_source(None)
    yield
    jst.set_source(jprev)
    tst.set_source(tprev)
    jfaults.clear()
    tfaults.clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_storage"))
    filenames, _ = jdg.generate_data_local(2000, 4, 1, 0.0, d, seed=3)
    return filenames


def _table(rows, offset=0):
    return pa.table({"key": pa.array(range(offset, offset + rows),
                                     type=pa.int64())})


def _write(tmp_path, name, rows, offset=0):
    path = str(tmp_path / name)
    pq.write_table(_table(rows, offset), path)
    return path


def _ctr(name, **labels):
    return jmetrics.counter(name, **labels).value


def _stream(run, filenames, **kw):
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    run(filenames, consumer, NUM_EPOCHS, NUM_REDUCERS, NUM_TRAINERS,
        seed=SEED, num_workers=2, **kw)
    return {k: [r.result(timeout=60) for r in v] for k, v in refs.items()}


def assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert len(got[k]) == len(want[k]), (what, k)
        for a, b in zip(got[k], want[k]):
            assert a.equals(b), f"{what}: rank/epoch {k} differs"


def _quiet_sim(pkg, **kw):
    args = dict(first_byte_ms=0.0, mb_per_s=0.0, jitter_pct=0.0,
                error_rate=0.0, seed=0, sleep=lambda s: None)
    args.update(kw)
    return pkg.SimulatedObjectStore(inner=pkg.LocalSource(), **args)


def test_tiered_promote_demote_and_disk_eviction(tmp_path):
    t1, t2, t3 = (_table(1000, i * 1000) for i in range(3))
    outcomes = {}
    for name, pkg in (("jax", jst), ("port", tst)):
        store = pkg.TieredStore(
            hot_bytes=2 * t1.nbytes + 100,
            disk=pkg.DiskTier(max_bytes=1 << 20,
                              cache_dir=str(tmp_path / name / "d1")))
        ev0 = _ctr("rsdl_storage_evictions_total", tier="hot")
        try:
            seen = [store.put("t1", t1), store.put("t2", t2),
                    store.put("t3", t3)]  # demotes t1, the LRU entry
            seen.append(store.resident("t1"))  # still on disk
            seen.append(store.get("t1").equals(t1))  # disk hit, promoted
            seen.append(store.get("t2").equals(t2))
            seen.append(store.bytes_cached > store.disk.bytes_cached > 0)
            outcomes[name] = seen
            if name == "jax":
                want_evictions = _ctr("rsdl_storage_evictions_total",
                                      tier="hot") - ev0
            else:
                assert store.hot_evictions == want_evictions == 3
                assert store.disk.hits == 2 and store.hot_hits == 0
        finally:
            store.close()
        assert store.bytes_cached == 0
    assert outcomes["port"] == outcomes["jax"] == [True] * 7

    # The disk tier alone, budgeted for 2.5 files: LRU eviction.
    sizes = {}
    for name, pkg in (("jax", jst), ("port", tst)):
        probe = pkg.DiskTier(max_bytes=1 << 20,
                             cache_dir=str(tmp_path / name / "probe"))
        probe.put("t1", t1)
        sizes[name] = probe.disk_bytes
        probe.close()
        small = pkg.DiskTier(max_bytes=int(sizes[name] * 2.5),
                             cache_dir=str(tmp_path / name / "d2"))
        try:
            assert small.put("a", t1) and small.put("b", t2)
            assert small.put("c", t3)
            assert "a" not in small and "b" in small and "c" in small
            assert small.disk_bytes <= small.max_bytes
            assert small.get("a") is None and small.get("b").equals(t2)
        finally:
            small.close()
        # No eviction and no ledger charge in the legacy face.
        legacy = pkg.DiskTableCache(max_bytes=int(sizes[name] * 1.5),
                                    cache_dir=str(tmp_path / name / "d3"))
        try:
            assert legacy.put("a", t1) and not legacy.put("b", t2)
            assert "a" in legacy and legacy.bytes_cached == 0
        finally:
            legacy.close()
    assert sizes["port"] == sizes["jax"]


def _flip_a_byte(path):
    with open(path, "r+b") as f:
        f.seek(200)
        byte = f.read(1)
        f.seek(200)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_disk_corruption_falls_through_to_a_refetch(tmp_path):
    path = _write(tmp_path, "obj.parquet", 500)
    for name, pkg in (("jax", jst), ("port", tst)):
        sim = _quiet_sim(pkg)
        original = pkg.read_table(path, source=sim)
        cache_dir = tmp_path / name
        store = pkg.TieredStore(hot_bytes=0, disk=pkg.DiskTier(
            max_bytes=1 << 20, cache_dir=str(cache_dir)), source=sim)
        try:
            assert store.warm(path)
            assert store.get(path).equals(original)
            [entry] = glob.glob(str(cache_dir / "*.arrow"))
            _flip_a_byte(entry)
            read0 = sim.bytes_read
            assert store.get(path) is None  # the CRC caught it
            assert not glob.glob(str(cache_dir / "*.arrow"))
            assert pkg.read_table(path, source=sim).equals(original)
            assert sim.bytes_read > read0
            if pkg is tst:
                assert store.disk.corrupt == 1
        finally:
            store.close()


def test_a_corrupt_entry_under_a_tiered_shuffle_keeps_the_stream(
        files, tmp_path):
    want = _stream(jsh.shuffle, files, executor_backend="thread",
                   file_cache=None)
    cache_dir = tmp_path / "tier"
    store = tst.TieredStore(hot_bytes=0, disk=tst.DiskTier(
        max_bytes=1 << 30, cache_dir=str(cache_dir)))
    try:
        first = _stream(tsh.shuffle, files, file_cache=store,
                        max_concurrent_epochs=1)
        entries = sorted(glob.glob(str(cache_dir / "*.arrow")))
        assert len(entries) == len(files) and store.disk.hits == len(files)
        _flip_a_byte(entries[0])
        again = _stream(tsh.shuffle, files, file_cache=store,
                        max_concurrent_epochs=1)
        assert store.disk.corrupt == 1
    finally:
        store.close()
    assert_same(first, want, "tiered")
    assert_same(again, want, "after a corrupt entry")


def test_storage_sites_fire_once_per_key_and_keep_the_stream(files):
    spec = "storage_read:file1,storage_stall:file0:delay20"
    clean = _stream(tsh.shuffle, files, file_cache=None)
    fired = {}
    streams = {}
    for name, pkg_faults, run in (("jax", jfaults, jsh.shuffle),
                                  ("port", tfaults, tsh.shuffle)):
        injector = pkg_faults.install(spec, seed=0)
        try:
            streams[name] = _stream(run, files, executor_backend="thread",
                                    file_cache=None)
        finally:
            pkg_faults.clear()
        fired[name] = sorted((f["site"], f["epoch"], f["task"])
                             for f in injector.fired())
    before = tstats.fault_stats().snapshot()
    tfaults.install(spec, seed=0)
    try:
        _stream(tsh.shuffle, files, file_cache=None)
    finally:
        tfaults.clear()
    after = tstats.fault_stats().snapshot()
    want_fired = sorted([("storage_read", e, 1) for e in range(NUM_EPOCHS)]
                        + [("storage_stall", e, 0)
                           for e in range(NUM_EPOCHS)])
    assert fired["port"] == fired["jax"] == want_fired
    assert after["injected"] - before["injected"] == NUM_EPOCHS
    assert (after["recomputes_by_component"].get("lineage", 0)
            - before["recomputes_by_component"].get("lineage", 0)
            == NUM_EPOCHS)
    assert_same(streams["port"], clean, "port under chaos")
    assert_same(streams["port"], streams["jax"], "JAX under chaos")


def test_prefetch_accounting(tmp_path):
    f0 = _write(tmp_path, "f0.parquet", 300)
    f1 = _write(tmp_path, "f1.parquet", 300, offset=300)
    paths = {}
    for name, pkg in (("jax", jst), ("port", tst)):
        store = pkg.TieredStore(hot_bytes=1 << 20, source=pkg.LocalSource())
        mgr = pkg.PrefetchManager(store, [f0, f1])
        try:
            t0 = mgr.next()
            assert t0.run() and store.resident(f0)
            t1 = mgr.next()
            t1.cancel()
            assert not t1.run()
            assert mgr.next() is None
            assert pkg.PrefetchManager(store, [f0]).next() is None
            assert store.get(f0) is not None and store.get(f0) is not None
            paths[name] = [t0.path, t1.path]
            if pkg is tst:
                assert store.prefetch_hits == 1  # once, not per get
                stats = mgr.stats()
                assert stats == {"issued": 1, "canceled": 1, "hits": 1,
                                 "efficiency": 1.0}
        finally:
            store.close()
    assert paths["port"] == paths["jax"] == [f0, f1]


def test_the_tenant_quotas_raise_naming_the_roadmap(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.TieredStore(1 << 20, tenant_quotas={"a": 1})
    store = tst.TieredStore(1 << 20)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.PrefetchManager(store, [], tenant="a")


def test_a_get_joins_a_warm_in_flight_without_a_second_fetch(tmp_path):
    path = _write(tmp_path, "slow.parquet", 200)
    gate, started, reads = threading.Event(), threading.Event(), []

    class GatedSource(tst.LocalSource):
        def read_table(self, p):
            reads.append(p)
            started.set()
            assert gate.wait(30)
            return super().read_table(p)

    store = tst.TieredStore(hot_bytes=1 << 20, source=GatedSource())
    try:
        warmer = threading.Thread(target=store.warm, args=(path,))
        warmer.start()
        assert started.wait(10)
        results = []
        getter = threading.Thread(
            target=lambda: results.append(store.get(path)))
        getter.start()
        getter.join(timeout=0.3)
        assert getter.is_alive()  # blocked on the warm in flight
        gate.set()
        getter.join(timeout=30)
        warmer.join(timeout=30)
        assert results[0].equals(pq.read_table(path))
        assert len(reads) == 1
    finally:
        gate.set()
        store.close()


def test_the_simulated_store_replays_jax_draws_under_a_seed(tmp_path):
    path = _write(tmp_path, "obj.parquet", 400)

    def sequence(pkg, seed, rounds=8):
        delays = []
        sim = pkg.SimulatedObjectStore(
            inner=pkg.LocalSource(), first_byte_ms=5.0, mb_per_s=100.0,
            jitter_pct=50.0, error_rate=0.4, seed=seed, sleep=delays.append)
        seq = []
        for _ in range(rounds):
            n = len(delays)
            try:
                data = sim.read_bytes(path)
            except OSError:
                seq.append("err")
            else:
                seq.append(("ok", delays[n], len(data)))
        return seq, sim

    port, sim = sequence(tst, 7)
    assert port == sequence(tst, 7)[0] == sequence(jst, 7)[0]
    assert "err" in port and any(isinstance(s, tuple) for s in port)
    assert sequence(tst, 8)[0] != port
    replay = []
    sim._sleep = replay.append
    sim.reset()
    assert sim.bytes_read == 0
    again = []
    for _ in range(8):
        n = len(replay)
        try:
            data = sim.read_bytes(path)
        except OSError:
            again.append("err")
        else:
            again.append(("ok", replay[n], len(data)))
    assert again == port


class _RangeHandler(http.server.SimpleHTTPRequestHandler):
    """Static files with ``Range: bytes=a-b`` (the stdlib handler has
    none)."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        path = self.translate_path(self.path)
        if not os.path.isfile(path):
            self.send_error(404)
            return
        with open(path, "rb") as f:
            data = f.read()
        header = self.headers.get("Range")
        status = 200
        if header:
            lo, hi = header.split("=", 1)[1].split("-")
            data = data[int(lo):int(hi) + 1 if hi else None]
            status = 206
        self.send_response(status)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_http_range_source_over_loopback(files):
    root = os.path.dirname(files[0])

    def handler(*args, **kwargs):
        return _RangeHandler(*args, directory=root, **kwargs)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}/"
        port_src, jax_src = tst.HTTPRangeSource(base), jst.HTTPRangeSource(
            base)
        name = os.path.basename(files[0])
        table = port_src.read_table(name)
        assert table.equals(pq.read_table(files[0]))
        assert table.equals(jax_src.read_table(name))
        raw = open(files[0], "rb").read()
        assert port_src.read_bytes(name, 4, 100) == raw[4:104]
        assert port_src.read_bytes(name, 10) == raw[10:]
        assert port_src.size(name) == jax_src.size(name) == len(raw)
        assert port_src.open_parquet(name).metadata.num_rows == \
            table.num_rows
        assert port_src.bytes_read > 0
        assert port_src.size("missing.parquet") == 0
        with pytest.raises(FileNotFoundError):
            port_src.read_bytes("missing.parquet")
        with pytest.raises(ValueError):
            tst.HTTPRangeSource("ftp://x")
    finally:
        server.shutdown()
        server.server_close()


def test_fileio_memory_round_trip_and_paths(tmp_path):
    assert tfileio.parse_uri("/a/b.parquet") == (None, "/a/b.parquet")
    assert tfileio.parse_uri("file:///a/b") == (None, "/a/b")
    assert tfileio.join("/a", "b") == os.path.join("/a", "b")
    assert (tfileio.join("memory://bucket/", "x", "y.parquet")
            == jfileio.join("memory://bucket/", "x", "y.parquet"))
    table = pa.table({"x": np.arange(100, dtype=np.int64)})
    base = "memory://port-storage-test"
    tfileio.makedirs(base)
    uri = tfileio.join(base, "t.parquet")
    tfileio.write_parquet(table, uri)
    assert tfileio.read_parquet(uri).equals(table)
    assert jfileio.read_parquet(uri).equals(table)
    assert tfileio.file_size(uri) == jfileio.file_size(uri) > 0
    assert tst.LocalSource().read_table(uri).equals(table)
    local = str(tmp_path / "d" / "t.parquet")
    tfileio.makedirs(os.path.dirname(local))
    tfileio.write_parquet(table, local)
    assert tfileio.read_parquet("file://" + local).equals(table)


def test_a_tiered_shuffle_over_the_simulated_store_prefetches(files):
    want = _stream(jsh.shuffle, files, executor_backend="thread",
                   file_cache=None)
    sim = _quiet_sim(tst, first_byte_ms=1.0)
    tst.set_source(sim)
    before = tst.storage_totals()
    # Both epochs in flight: epoch 1's maps (and the warms) wait for
    # epoch 0's loads of the same files.
    got = _stream(tsh.shuffle, files, file_cache="tiered")
    totals = {k: v - before[k] for k, v in tst.storage_totals().items()}
    assert_same(got, want, "tiered over the simulated store")
    assert sim.fetches == len(files)  # each file fetched once
    assert totals["hot_hits"] >= len(files)
    assert totals["remote_misses"] + totals["prefetch_issued"] >= len(files)


def test_a_get_waits_for_the_load_of_its_key(tmp_path):
    store = tst.TieredStore(hot_bytes=1 << 20)
    table = _table(10)
    try:
        assert store.get("k") is None  # this caller loads "k"
        got = []
        waiter = threading.Thread(target=lambda: got.append(store.get("k")))
        waiter.start()
        waiter.join(timeout=0.2)
        assert waiter.is_alive()  # waiting for the load in flight
        store.put("k", table)
        store.release("k")
        waiter.join(timeout=30)
        assert got[0].equals(table) and store.remote_misses == 1
        # A failed load wakes its waiters, and one of them loads.
        assert store.get("j") is None
        waiter = threading.Thread(target=lambda: got.append(store.get("j")))
        waiter.start()
        store.release("j")
        waiter.join(timeout=30)
        assert got[1] is None
        store.release("j")
    finally:
        store.close()
