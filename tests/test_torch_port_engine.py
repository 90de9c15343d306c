"""The port's shuffle engine (``shuffle.py`` over ``plan/``,
``executor.py``, the native library and ``stats.py``) against the JAX
package's, run on the thread backend: the same seeded files (4 files of
4,000 rows in all, from the JAX package's generator), seed, reducer and
trainer counts and engine arguments must give equal reducer tables
(``pa.Table.equals``) for every ``(rank, epoch)``, in order. Every stream
is also held against the plain shuffle the port ran before the engine
(the NumPy plan, the seeded permutation, Arrow's ``take``).

Configurations: the file cache on and off, the streaming map on and off,
a quarantined corrupt file and a lost map recomputed from its lineage;
plus the epoch plan's JSON, the scheduler's speculation, ``TrialStats``,
the executor, the process backend and the disk and tiered caches
against the JAX stream, and ``"auto"``'s choice against the JAX rule
(the process pool's own tests are ``test_torch_port_procpool.py``).
"""

import importlib
import os
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import executor as jex
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import executor as tex
from ray_shuffling_data_loader_tpu_torch import partition as tpart
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    make_cast_transform)
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.plan import scheduler as tsched
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)


# The JAX package's name ``shuffle`` is its function; this is the module.
jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

NUM_ROWS = 4000
NUM_FILES = 3  # the generator writes 4 files for these rows
NUM_EPOCHS = 2
NUM_REDUCERS = 4
NUM_TRAINERS = 2
SEED = 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_engine"))
    filenames, _ = jdg.generate_data_local(NUM_ROWS, NUM_FILES, 2, 0.0, d,
                                           seed=3)
    return filenames


def _casts():
    spec = jwl.dlrm_spec()
    args = (spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"])
    return jjd.make_cast_transform(*args), make_cast_transform(*args)


def _collect(run, filenames, **kw):
    """``{(rank, epoch): [table, ...]}`` and the driver's return value."""
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    result = run(filenames, consumer, NUM_EPOCHS, NUM_REDUCERS,
                 NUM_TRAINERS, seed=SEED, num_workers=2, **kw)
    return {k: [r.result() for r in v] for k, v in refs.items()}, result


def jax_stream(filenames, **kw):
    return _collect(jsh.shuffle, filenames, executor_backend="thread", **kw)


def port_stream(filenames, **kw):
    return _collect(tsh.shuffle, filenames, **kw)


def plain_stream(filenames, map_transform=None, skip=()):
    """The shuffle without the engine: every file read and transformed,
    planned with the NumPy plan, each reducer's rows concatenated in file
    order and permuted with its seeded stream."""
    out = {}
    spans = tpart.contiguous_splits(list(range(NUM_REDUCERS)), NUM_TRAINERS)
    for epoch in range(NUM_EPOCHS):
        parts = {r: [] for r in range(NUM_REDUCERS)}
        for i, f in enumerate(filenames):
            if i in skip:
                continue
            table = pq.read_table(f)
            if map_transform is not None:
                table = map_transform(table)
            flat, offsets = tpart.plan_partition_flat(
                table.num_rows, NUM_REDUCERS, SEED, epoch, i)
            for r in range(NUM_REDUCERS):
                parts[r].append(table.take(flat[offsets[r]:offsets[r + 1]]))
        for rank, reducers in enumerate(spans):
            tables = []
            for r in reducers:
                concat = pa.concat_tables(parts[r],
                                          promote_options="permissive")
                perm = tpart.permutation(
                    concat.num_rows, tpart.reduce_rng(SEED, epoch, r))
                tables.append(concat.take(perm))
            out[(rank, epoch)] = tables
    return out


def assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert len(got[k]) == len(want[k]), (what, k)
        for a, b in zip(got[k], want[k]):
            assert a.equals(b), f"{what}: rank/epoch {k} differs"


@pytest.fixture
def fused(monkeypatch, request):
    """``RSDL_SHUFFLE_FUSED_PIPELINE`` for both packages."""
    monkeypatch.setenv("RSDL_SHUFFLE_FUSED_PIPELINE",
                       "1" if request.param else "0")
    return request.param


@pytest.mark.parametrize("fused", [True, False], indirect=True)
@pytest.mark.parametrize("cache", ["auto", None])
def test_reducer_tables_equal_jax_and_the_plain_shuffle(files, fused,
                                                        cache):
    jcast, tcast = _casts()
    want, _ = jax_stream(files, map_transform=jcast, file_cache=cache)
    got, _ = port_stream(files, map_transform=tcast, file_cache=cache)
    assert_same(got, want, f"cache={cache} fused={fused}")
    assert_same(got, plain_stream(files, tcast), "plain")
    keys = np.concatenate([t.column("key").to_numpy()
                           for (rank, epoch), ts in got.items()
                           if epoch == 1 for t in ts])
    np.testing.assert_array_equal(np.sort(keys), np.arange(NUM_ROWS))


def test_the_streaming_map_groups_rows_as_the_read_then_plan_map(files):
    _, tcast = _casts()
    fused = tsh._fused_stream_map(files[0], NUM_REDUCERS, SEED, 1, 0, tcast)
    assert isinstance(fused, tsh.FusedMapShard)
    table = tcast(pq.read_table(files[0]))
    shard = tsh.MapShard(table, *tpart.plan_partition_flat(
        table.num_rows, NUM_REDUCERS, SEED, 1, 0))
    for r in range(NUM_REDUCERS):
        assert fused[r].materialize().equals(shard[r].materialize())
    # A transform that is not per row is outside the streaming contract.
    assert tsh._fused_stream_map(files[0], 2, SEED, 0, 0,
                                 lambda t: t) is None


def test_a_cache_hit_is_not_transformed_again(files):
    calls = []

    def transform(table):
        calls.append(table.num_rows)
        return table

    cache = tsh.FileTableCache(1 << 30)
    before = tsh.file_cache_totals()
    # One epoch at a time: epoch 1's maps start after epoch 0's are cached.
    got, _ = port_stream(files, map_transform=transform, file_cache=cache,
                         max_concurrent_epochs=1)
    n = len(files)
    assert len(calls) == n  # epoch 1 hits the cache
    assert (cache.hits, cache.misses) == (n, n)
    after = tsh.file_cache_totals()
    assert after["hits"] - before["hits"] == n
    assert after["bytes_put"] - before["bytes_put"] == cache.bytes_cached
    assert_same(got, plain_stream(files), "cached")


def test_a_file_is_loaded_once_while_two_epochs_map_it(files):
    # Eight workers for four files and two epochs in flight: every map
    # starts at once, and epoch 1's wait for epoch 0's loads.
    calls = []

    def transform(table):
        calls.append(table.num_rows)
        return table

    cache = tsh.FileTableCache(1 << 30)
    refs = []
    tsh.shuffle(files, lambda r, e, b: refs.extend(b or []), NUM_EPOCHS,
                NUM_REDUCERS, NUM_TRAINERS, seed=SEED, num_workers=8,
                map_transform=transform, file_cache=cache)
    assert len(calls) == len(files)
    assert (cache.hits, cache.misses) == (len(files), len(files))
    assert cache._loads._flights == {}


def test_a_failed_load_wakes_the_maps_waiting_for_it(files, tmp_path):
    cache = tsh.FileTableCache(1 << 30)
    assert cache.get("f") is None  # this caller loads "f"
    got = []
    waiter = threading.Thread(target=lambda: got.append(cache.get("f")))
    waiter.start()
    time.sleep(0.1)
    assert waiter.is_alive()  # waiting for the load in flight
    cache.release("f")  # the load failed: nothing was put
    waiter.join(timeout=10)
    assert got == [None]  # the waiter became the loader
    cache.put("f", pa.table({"x": [1]}))
    cache.release("f")
    assert cache.get("f").num_rows == 1


def test_the_cache_is_keyed_by_file_name_not_index(files):
    cache = tsh.FileTableCache(1 << 30)
    port_stream(files, file_cache=cache, max_concurrent_epochs=1)
    reordered = list(reversed(files))
    got, _ = port_stream(reordered, file_cache=cache)
    assert cache.hits == 3 * len(files)  # every map after the first epoch
    want, _ = port_stream(reordered, file_cache=None)
    assert_same(got, want, "reordered files through a warm cache")


def test_a_corrupt_file_is_quarantined_as_in_jax(files, tmp_path):
    bad = str(tmp_path / "corrupt.parquet")
    with open(bad, "wb") as f:
        f.write(b"PAR1 this is not a parquet file")
    with_bad = [files[0], bad, files[2], files[3]]
    jfaults_before = len(jsh.stats_mod.fault_stats().snapshot()
                         ["recent_quarantines"])
    want, _ = jax_stream(with_bad, on_bad_file="skip", file_cache=None)
    before = tstats.fault_stats().snapshot()["quarantines"]
    got, _ = port_stream(with_bad, on_bad_file="skip", file_cache=None)
    assert_same(got, want, "quarantine")
    assert_same(got, plain_stream(with_bad, skip=(1,)), "plain")
    snap = tstats.fault_stats().snapshot()
    assert snap["quarantines"] - before == NUM_EPOCHS
    jreports = jsh.stats_mod.fault_stats().snapshot()[
        "recent_quarantines"][jfaults_before:]
    treports = snap["recent_quarantines"][-NUM_EPOCHS:]
    fields = ("filename", "epoch", "file_index", "error")

    def by_epoch(reports):
        # Both epochs are in flight at once, so their reports land in
        # either order.
        return sorted(({k: r[k] for k in fields} for r in reports),
                      key=lambda r: (r["epoch"], r["file_index"]))

    assert by_epoch(treports) == by_epoch(jreports[-NUM_EPOCHS:])
    assert [r["epoch"] for r in by_epoch(treports)] == list(
        range(NUM_EPOCHS))
    with pytest.raises(pa.ArrowInvalid):
        port_stream(with_bad, file_cache=None)


@pytest.mark.parametrize("cache", ["auto", None])
def test_a_lost_map_is_recomputed_from_its_lineage(files, cache):
    spec = "map_read:file1:x2"  # both executor attempts of map 1 fail
    # One epoch at a time, so that with the cache epoch 1 surely hits it.
    kw = dict(task_retries=1, file_cache=cache, max_concurrent_epochs=1)
    jfaults.install(spec)
    try:
        want, _ = jax_stream(files, **kw)
    finally:
        jfaults.clear()
    before = tstats.fault_stats().snapshot()
    tfaults.install(spec)
    try:
        got, _ = port_stream(files, **kw)
    finally:
        tfaults.clear()
    after = tstats.fault_stats().snapshot()
    assert_same(got, want, "lineage")
    assert_same(got, plain_stream(files), "plain")
    lineage = (after["recomputes_by_component"].get("lineage", 0)
               - before["recomputes_by_component"].get("lineage", 0))
    # With the cache, epoch 1 serves file 1 from it and never reads it.
    assert lineage == (1 if cache else NUM_EPOCHS)
    assert after["injected"] - before["injected"] == 2 * lineage


def test_trial_stats_count_the_stages_as_jax(files):
    _, jtrial = jax_stream(files, collect_stats=True)
    _, ttrial = port_stream(files, collect_stats=True)
    assert isinstance(ttrial, tstats.TrialStats)
    assert len(ttrial.epoch_stats) == len(jtrial.epoch_stats) == NUM_EPOCHS
    for t, j in zip(ttrial.epoch_stats, jtrial.epoch_stats):
        for stage in ("map_stats", "reduce_stats", "consume_stats"):
            assert (len(getattr(t, stage).task_durations)
                    == len(getattr(j, stage).task_durations))
        assert len(t.map_stats.read_durations) == len(files)
        assert t.duration > 0 and t.reduce_stats.stage_duration > 0
    rows = tstats.trial_summary(ttrial)
    assert [r["map_tasks"] for r in rows] == [len(files)] * NUM_EPOCHS
    assert [r["reduce_tasks"] for r in rows] == [NUM_REDUCERS] * NUM_EPOCHS
    assert [r["consumes"] for r in rows] == [NUM_TRAINERS] * NUM_EPOCHS
    with pytest.raises(ValueError, match="collect_stats"):
        port_stream(files, collect_stats=True, start_epoch=1)


@pytest.mark.parametrize("what", ["process", "disk", "tiered"])
def test_backend_and_caches_match_jax_stream(files, what):
    """The process pool and the disk and tiered caches give the JAX
    package's stream (its thread backend's: both of its backends give
    the same one)."""
    kw = ({"executor_backend": what} if what == "process"
          else {"file_cache": what})
    want, _ = jax_stream(files)
    got, _ = port_stream(files, max_concurrent_epochs=1, **kw)
    assert_same(got, want, what)
    assert tex.last_worker_pool()["backend"] == (
        "process" if what == "process" else "thread")


def test_auto_backend_resolves_as_in_jax(files, monkeypatch):
    monkeypatch.delenv("RSDL_EXECUTOR_BACKEND", raising=False)
    jpool = importlib.import_module("ray_shuffling_data_loader_tpu.procpool")
    for workers in (None, 1, 2):
        assert (tex.resolve_backend("auto", num_workers=workers)
                == jpool.resolve_backend("auto", num_workers=workers))
    assert tex.resolve_backend(num_workers=1) == "thread"
    want = "process" if (os.cpu_count() or 1) > 1 else "thread"
    assert tex.resolve_backend(num_workers=2) == want
    monkeypatch.setenv("RSDL_EXECUTOR_BACKEND", "thread")
    assert tex.resolve_backend(num_workers=2) == "thread"
    monkeypatch.setenv("RSDL_EXECUTOR_BACKEND", "bogus")
    with pytest.raises(ValueError, match="executor_backend"):
        tex.resolve_backend()


@pytest.mark.parametrize("args", [
    (["a.parquet", "b.parquet", "c.parquet"], 4, 2, 3, 1),
    (["only.parquet"], 1, 1, 0, 0),
    (["x", "y"], 5, 3, 9, 2)])
def test_epoch_plan_and_its_json_equal_jax(args):
    plan = tir.build_epoch_plan(*args)
    text = plan.to_json()
    assert text == jir.build_epoch_plan(*args).to_json()
    assert tir.from_json(text).to_json() == text
    assert [n.meta["reducers"] for n in plan.routes()] == [
        n.meta["reducers"] for n in jir.build_epoch_plan(*args).routes()]
    broken = tir.from_json(text)
    broken.nodes[tir.node_id("reduce", args[4], 0)].deps = ()
    with pytest.raises(tir.PlanError):
        broken.validate()


def test_epoch_specs_and_queue_queries_equal_jax():
    assert (list(tir.static_epoch_specs(["a", "b"], 4, 1))
            == [tir.EpochSpec(e, ("a", "b")) for e in (1, 2, 3)])
    assert ([s.epoch for s in tir.static_epoch_specs(["a"], 4, 1)]
            == [s.epoch for s in jir.static_epoch_specs(["a"], 4, 1)])
    for q in range(12):
        assert tir.queue_epoch(q, 3) == jir.queue_epoch(q, 3)
        assert tir.queue_rank(q, 3) == jir.queue_rank(q, 3)
    assert tir.route_slices(7, 3) == jir.route_slices(7, 3)
    assert list(tir.epoch_range(2, 5)) == [2, 3, 4]


def test_speculation_backs_up_a_straggling_reduce(files, monkeypatch):
    for name, value in (("RSDL_PLAN_SPECULATION", "1"),
                        ("RSDL_PLAN_SPECULATION_MIN_S", "0.2"),
                        ("RSDL_PLAN_SPECULATION_MULTIPLIER", "2.0")):
        monkeypatch.setenv(name, value)
    want = plain_stream(files)
    before = tsched.speculation_totals()
    tfaults.install("reduce_gather:epoch0:task2:delay900")
    try:
        got, _ = port_stream(files, file_cache=None)
    finally:
        tfaults.clear()
    after = tsched.speculation_totals()
    assert_same(got, want, "speculation")
    assert after["speculative_launched"] > before["speculative_launched"]
    assert after["speculative_won"] > before["speculative_won"]


def test_executor_wait_get_and_retries():
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) == 1:
            raise RuntimeError("first attempt")
        return x * 2

    with tex.Executor(num_workers=2, task_retries=1) as pool:
        assert pool.submit(flaky, 4).result(timeout=30) == 8
        with pytest.raises(RuntimeError):
            calls.clear()
            pool.submit_once(flaky, 1).result(timeout=30)
        refs = pool.map(lambda x: x + 1, [1, 2, 3])
        done, not_done = tex.wait(refs, num_returns=3, timeout=30)
        assert done == refs and not_done == []
        assert tex.get(refs) == [2, 3, 4]
        with pytest.raises(ValueError):
            tex.wait(refs, num_returns=4)
    with pytest.raises(ValueError):
        tex.Executor(task_retries=-1)


@pytest.mark.parametrize("reduces,workers,share", [(16, 8, 1), (4, 64, 1),
                                                    (8, 8, 2), (1, 1, 1)])
def test_derive_gather_threads_equals_jax(reduces, workers, share):
    assert (tsh.derive_gather_threads(reduces, workers, host_share=share)
            == jsh.derive_gather_threads(reduces, workers,
                                         host_share=share))


def test_executor_pools_agree_with_jax_on_wait_order():
    with tex.Executor(num_workers=3) as tpool, \
            jex.Executor(num_workers=3) as jpool:
        t = [tpool.submit(lambda v=v: v) for v in range(5)]
        j = [jpool.submit(lambda v=v: v) for v in range(5)]
        tdone, _ = tex.wait(t, num_returns=2, timeout=30)
        jdone, _ = jex.wait(j, num_returns=2, timeout=30)
        assert len(tdone) == len(jdone) == 2
        assert [r.result() for r in t] == [r.result() for r in j]


def test_start_epoch_skips_epochs_through_the_engine(files):
    got, _ = port_stream(files, start_epoch=1)
    want = plain_stream(files)
    assert sorted(got) == [(r, 1) for r in range(NUM_TRAINERS)]
    for k in got:
        for a, b in zip(got[k], want[k]):
            assert a.equals(b)
    assert os.path.exists(files[0])
