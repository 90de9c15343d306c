"""The port's memory budget and spill tier (``spill.py`` and the budget
wait of ``shuffle.py``) and the engine's pieces in the distributed
shuffle, against the JAX package's.

Files come from the JAX package's generator (4,000 rows, seed 3). A
spilled reducer output must come back (CRC-checked, memory-mapped) equal
to the table it replaced; a corrupt spill is recomputed from its
lineage; the budget's wait is woken by releases; and a world of two
threads standing in for hosts, with the file cache, a spill tier, map
retries and ``collect_stats``, must give the JAX package's
``shuffle_distributed`` tables, table for table. Worlds join with a time
limit and give ``recv`` a timeout of seconds, so a hang fails one test.
"""

import gc
import importlib
import os
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu import spill as jspill
from ray_shuffling_data_loader_tpu.parallel import distributed as jdist
from ray_shuffling_data_loader_tpu.parallel import transport as jtp
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import native as tnative
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import spill as tspill
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.parallel import distributed as tdist
from ray_shuffling_data_loader_tpu_torch.parallel import transport as ttp
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo as twl

jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

NUM_EPOCHS = 2
NUM_REDUCERS = 4
SEED = 5
RECV_TIMEOUT_S = 20.0
JOIN_S = 60.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_spill"))
    filenames, _ = jdg.generate_data_local(4000, 3, 2, 0.0, d, seed=3)
    return filenames


@pytest.fixture
def no_collections():
    """No cyclic collection while a test reads the process-wide ledger
    (another test's garbage would release its bytes in the middle)."""
    gc.collect()
    gc.disable()
    yield
    gc.enable()


def _table(n=1000):
    rng = np.random.default_rng(0)
    return pa.table({"a": rng.integers(0, 9, n), "b": rng.random(n)})


def _always_over():
    return True


def test_a_spilled_table_comes_back_equal_and_accounted(tmp_path):
    manager = tspill.SpillManager(str(tmp_path), _always_over)
    table = _table()
    before = tspill.process_spill_totals()
    handle = manager.maybe_spill(table, epoch=0, task=1)
    assert isinstance(handle, tspill.SpilledTable)
    assert handle.num_rows == table.num_rows
    assert manager.spill_count == 1 and manager.spilled_bytes > 0
    back = tspill.unwrap(handle)
    assert back.equals(table)
    assert tspill.unwrap(handle) is back  # loaded once
    after = tspill.process_spill_totals()
    assert after["spills"] - before["spills"] == 1
    assert after["loads"] - before["loads"] == 1
    assert after["load_s"] > before["load_s"]
    assert tspill.unwrap(table) is table
    # Not over budget, or an empty table: kept in memory.
    quiet = tspill.SpillManager(str(tmp_path), lambda: False)
    assert quiet.maybe_spill(table) is table
    assert manager.maybe_spill(table.slice(0, 0)).num_rows == 0


def test_a_spill_file_that_jax_wrote_has_the_same_crc(tmp_path):
    handle = tspill.SpillManager(str(tmp_path), _always_over).maybe_spill(
        _table())
    jhandle = jspill.SpillManager(str(tmp_path), _always_over).maybe_spill(
        _table())
    assert tspill._file_crc(jhandle._path) == jspill._file_crc(
        jhandle._path)
    assert handle._crc == tspill._file_crc(handle._path)


def test_a_corrupt_spill_is_recomputed_from_lineage(tmp_path):
    table = _table()
    manager = tspill.SpillManager(str(tmp_path), _always_over)
    handle = manager.maybe_spill(table, recompute=lambda: table, epoch=1,
                                 task=2)
    with open(handle._path, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xfe")
    before = tstats.fault_stats().snapshot()
    assert handle.load().equals(table)
    after = tstats.fault_stats().snapshot()
    assert after["quarantines"] == before["quarantines"] + 1
    assert after["recomputes_by_component"]["spill"] >= 1
    assert after["recent_quarantines"][-1]["file_index"] == 2


def test_a_corrupt_spill_without_lineage_is_a_loud_failure(tmp_path):
    handle = tspill.SpillManager(str(tmp_path), _always_over).maybe_spill(
        _table())
    with open(handle._path, "r+b") as f:
        f.seek(50)
        f.write(b"\x00\x01\x02")
    with pytest.raises(tspill.SpillCorruption):
        handle.load()


def test_fault_sites_spill_write_and_spill_read(tmp_path):
    table = _table()
    manager = tspill.SpillManager(str(tmp_path), _always_over)
    tfaults.install("spill_write:task0,spill_read")
    try:
        assert manager.maybe_spill(table) is table  # kept in memory
        handle = manager.maybe_spill(table, recompute=lambda: table,
                                     epoch=0, task=5)
        assert isinstance(handle, tspill.SpilledTable)
        assert handle.load().equals(table)  # read fault -> recomputed
    finally:
        tfaults.clear()
    assert not os.listdir(manager._dir)


def test_the_budget_reads_the_ledger_growth_beyond_the_cache(
        no_collections):
    cache = tsh.FileTableCache(1 << 30)
    over, manager = tspill.make_budget_state(cache, 1 << 20, None)
    assert manager is None and not over()
    ledger = tnative.buffer_ledger()
    held = ledger.register(2 << 20)
    assert over()
    cache._bytes += 2 << 20  # growth of the cache is not transient
    assert not over()
    cache._bytes -= 2 << 20
    ledger.decref(held)
    assert not over()
    never, _ = tspill.make_budget_state(None, None, None)
    assert not never()


def test_free_list_bytes_held_at_start_do_not_hide_growth(no_collections):
    ledger = tnative.buffer_ledger()
    ledger.decref(ledger.alloc(4 << 20))  # 4 MiB kept in the free list
    assert ledger.freelist_bytes() >= 4 << 20
    over, _ = tspill.make_budget_state(None, 1 << 20, None)
    held = ledger.register(2 << 20)
    try:
        # The probe trims the free list; the 2 MiB of growth stays over
        # the 1 MiB budget.
        assert over()
        assert ledger.freelist_bytes() == 0
        assert over()
    finally:
        ledger.decref(held)
    assert not over()


def _collect(run, filenames, unwrap, **kw):
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    result = run(filenames, consumer, NUM_EPOCHS, NUM_REDUCERS, 2,
                 seed=SEED, num_workers=2, **kw)
    return {k: [unwrap(r.result()) for r in v] for k, v in refs.items()}, \
        result


def _same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert len(got[k]) == len(want[k]), (what, k)
        for a, b in zip(got[k], want[k]):
            assert a.equals(b), f"{what}: {k} differs"


def test_reducer_tables_under_a_spilling_budget_equal_jax(files, tmp_path):
    want, _ = _collect(jsh.shuffle, files, jspill.unwrap,
                       executor_backend="thread", max_inflight_bytes=1,
                       spill_dir=str(tmp_path / "jax"))
    before = tspill.process_spill_totals()
    got, _ = _collect(tsh.shuffle, files, tspill.unwrap,
                      max_inflight_bytes=1, spill_dir=str(tmp_path / "port"))
    after = tspill.process_spill_totals()
    _same(got, want, "spill")
    assert after["spills"] - before["spills"] == NUM_EPOCHS * NUM_REDUCERS
    assert after["loads"] - before["loads"] == NUM_EPOCHS * NUM_REDUCERS


def test_the_budget_wait_is_woken_by_the_consumers_releases(files,
                                                            monkeypatch):
    # No spill tier: epoch 1's launch waits until the consumer drops epoch
    # 0's tables; the release wakes it long before the 30 s timeout.
    monkeypatch.setenv("RSDL_SHUFFLE_RELEASE_HEARTBEAT_S", "10")
    held = {}
    launched = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            launched.setdefault(epoch, time.monotonic())
            held.setdefault(epoch, []).extend(refs)

    def release_epoch0():
        while 0 not in held or not all(r.done() for r in held[0]):
            time.sleep(0.01)
        time.sleep(0.3)
        released_at.append(time.monotonic())
        held.pop(0)

    released_at = []
    t = threading.Thread(target=release_epoch0)
    t.start()
    tsh.shuffle(files, consumer, NUM_EPOCHS, NUM_REDUCERS, 1, seed=SEED,
                num_workers=2, max_concurrent_epochs=1, file_cache=None,
                max_inflight_bytes=1)
    t.join(timeout=30)
    assert launched[1] >= released_at[0]
    assert launched[1] - released_at[0] < 1.0


def test_device_stream_with_cache_and_spill_equals_jax(files, tmp_path):
    spec = twl.dlrm_spec()
    jspec = jwl.dlrm_spec()
    jset = jjd.JaxShufflingDataset(
        files, NUM_EPOCHS, 1, 500, 0, num_reducers=NUM_REDUCERS, seed=SEED,
        num_workers=1, queue_name="torch-port-spill", device_rebatch=False,
        **jspec)
    # The budget's baseline is the process-wide ledger now: collect what
    # earlier tests left in reference cycles, or its release during this
    # run would read as negative growth.
    gc.collect()
    before = tspill.process_spill_totals()
    port = DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, 500, 0, num_reducers=NUM_REDUCERS, seed=SEED,
        device="cpu", device_rebatch=True, max_inflight_bytes=1,
        spill_dir=str(tmp_path), collect_stats=True, **spec)
    for epoch in range(NUM_EPOCHS):
        jset.set_epoch(epoch)
        port.set_epoch(epoch)
        want = [(np.asarray(f), np.asarray(label)) for f, label in jset]
        got = list(port)
        assert len(got) == len(want) == 8
        for (pf, pl), (jf, jl) in zip(got, want):
            for a, b in zip(pf, jf):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(pl.numpy(), jl)
    trial = port.shuffle_result.result()
    assert isinstance(trial, tstats.TrialStats)
    after = tspill.process_spill_totals()
    assert after["spills"] > before["spills"]
    assert after["loads"] - before["loads"] == after["spills"] - \
        before["spills"]
    port.close()


def test_engine_arguments_with_an_external_queue_are_refused(files,
                                                             tmp_path):
    queue, result = tds.create_batch_queue_and_shuffle(
        files, 1, 1, num_reducers=2, file_cache=None)
    with pytest.raises(ValueError, match="batch_queue"):
        DeviceShufflingDataset(files, 1, 1, 10, 0, batch_queue=queue,
                               shuffle_result=result, device="cpu",
                               spill_dir=str(tmp_path), **twl.dlrm_spec())
    result.result(timeout=60)


def _world(pkg, tmod, spill_mod, filenames, tmp, **kw):
    """``({(trainer, epoch): [table, ...]}, [TrialStats per host])`` from
    ``pkg.shuffle_distributed`` over two threads as hosts."""
    transports = tmod.create_local_transports(2,
                                              recv_timeout_s=RECV_TIMEOUT_S)
    stream, trials, errors = {}, {}, []

    def host_main(h):
        refs = {}

        def consumer(local_rank, epoch, batch_refs):
            if batch_refs is not None:
                refs.setdefault((local_rank, epoch), []).extend(batch_refs)

        try:
            trials[h] = pkg.shuffle_distributed(
                filenames, consumer, NUM_EPOCHS, NUM_REDUCERS,
                transports[h], max_concurrent_epochs=2, seed=SEED,
                num_workers=3, spill_dir=os.path.join(tmp, f"h{h}"), **kw)
            for (_, epoch), rs in refs.items():
                stream[(h, epoch)] = [spill_mod.unwrap(r.result())
                                      for r in rs]
        except BaseException as e:  # noqa: BLE001 - surfaced to the test
            errors.append(e)

    threads = [threading.Thread(target=host_main, args=(h,), daemon=True)
               for h in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive(), "a host hung"
    finally:
        for t in transports:
            t.close()
    if errors:
        raise errors[0]
    return stream, [trials[h] for h in range(2)]


def test_distributed_world_with_cache_spill_retries_and_stats_equals_jax(
        files, tmp_path):
    kw = dict(file_cache="auto", max_inflight_bytes=1, task_retries=1,
              collect_stats=True)
    spec = "map_read:epoch0:file3:x1"  # host 1's map retried once
    jfaults.install(spec)
    try:
        want, jtrials = _world(jdist, jtp, jspill, files,
                               str(tmp_path / "jax"), **kw)
    finally:
        jfaults.clear()
    spills = tspill.process_spill_totals()["spills"]
    retries = tstats.fault_stats().snapshot()["retries"]
    tfaults.install(spec)
    try:
        got, trials = _world(tdist, ttp, tspill, files,
                             str(tmp_path / "port"), **kw)
    finally:
        tfaults.clear()
    _same(got, want, "distributed")
    assert tspill.process_spill_totals()["spills"] - spills \
        == NUM_EPOCHS * NUM_REDUCERS
    assert tstats.fault_stats().snapshot()["retries"] > retries
    for trial, jtrial in zip(trials, jtrials):
        assert isinstance(trial, tstats.TrialStats)
        for t, j in zip(trial.epoch_stats, jtrial.epoch_stats):
            assert (len(t.reduce_stats.task_durations)
                    == len(j.reduce_stats.task_durations) == 2)
            assert (len(t.map_stats.task_durations)
                    == len(j.map_stats.task_durations))
    keys = np.sort(np.concatenate([t.column("key").to_numpy()
                                   for (h, e), ts in got.items() if e == 0
                                   for t in ts]))
    np.testing.assert_array_equal(keys, np.arange(4000))


def test_a_resend_after_its_message_was_consumed_is_dropped():
    # A retried map on another host sends its chunks again, possibly after
    # the reducer here consumed the first copy: it must not be taken
    # twice (the JAX transport drops only resends still in the inbox).
    world = ttp.create_local_transports(2, recv_timeout_s=RECV_TIMEOUT_S)
    try:
        world[1].send(0, (0, 1, 2), b"chunk")
        assert world[0].recv(1, (0, 1, 2)) == b"chunk"
        world[1].send(0, (0, 1, 2), b"chunk")  # the retried map's resend
        world[1].send(0, (0, 1, 3), b"next")
        assert world[0].recv(1, (0, 1, 3)) == b"next"  # after the resend
        with pytest.raises(ttp.TransportTimeout):
            world[0].recv(1, (0, 1, 2), timeout_s=0.3)
    finally:
        for t in world:
            t.close()
