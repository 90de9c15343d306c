"""The port's bulk device binding (``device_rebatch``) and its persistent
cross-epoch producer against the JAX package's (the port's versions of
``tests/test_jax_dataset.py``'s persistent-producer and device-rebatch
tests).

Both packages read the same Parquet files with the same seed, reducer
count and spec. The port runs on the CPU with ``device_rebatch=True``
forced (``"auto"`` resolves per-batch there, as in the JAX package); its
stream is held against ``JaxShufflingDataset`` with ``device_rebatch=True``
and with ``False``, and against its own per-batch binding, batch for
batch and exactly.
"""

import gc
import itertools
import threading

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)

_queue_ids = itertools.count()


def _write_files(directory, num_files, rows_per_file):
    """The JAX tests' files (key, two index columns, a 4-wide list
    column, float labels), the list column of fixed size as the port's
    shuffle takes it."""
    filenames = []
    for i in range(num_files):
        start = i * rows_per_file
        n = rows_per_file
        rng = np.random.default_rng(i)
        table = pa.table({
            "key": pa.array(range(start, start + n), type=pa.int64()),
            "emb_1": pa.array(rng.integers(0, 100, n), type=pa.int64()),
            "emb_2": pa.array(rng.integers(0, 50, n), type=pa.int64()),
            "vec": pa.array([list(map(float, row))
                             for row in rng.random((n, 4))],
                            type=pa.list_(pa.float64(), 4)),
            "labels": pa.array(rng.random(n), type=pa.float64()),
        })
        path = str(directory / f"input_{i}.parquet")
        pq.write_table(table, path)
        filenames.append(path)
    return filenames


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """3 files of 128 rows."""
    return _write_files(tmp_path_factory.mktemp("rebatch3"), 3, 128)


@pytest.fixture(scope="module")
def files2(tmp_path_factory):
    """2 files of 128 rows."""
    return _write_files(tmp_path_factory.mktemp("rebatch2"), 2, 128)


def _spec(stack):
    if stack:
        return {"feature_columns": ["emb_1", "emb_2"],
                "feature_types": [np.int32, np.int32],
                "label_column": "labels"}
    # A shaped list column too, so the carve covers ndim > 2.
    return {"feature_columns": ["emb_1", "emb_2", "vec"],
            "feature_shapes": [None, None, (4,)],
            "feature_types": [np.int32, np.int32, np.float32],
            "label_column": "labels"}


def _batch(features, label, stack):
    if stack:
        return (np.asarray(features),), np.asarray(label)
    return tuple(np.asarray(f) for f in features), np.asarray(label)


def _drain(ds, num_epochs, skips, stack=False):
    out = []
    for epoch in range(num_epochs):
        ds.set_epoch(epoch, skip_batches=skips.get(epoch, 0))
        out.extend(_batch(f, lb, stack) for f, lb in ds)
    return out


def _jax(files, device_rebatch, *, skips=None, **kw):
    stack = kw.get("stack_features", False)
    num_epochs = kw.pop("num_epochs", 2)
    kw.pop("max_device_table_bytes", None)
    kw.setdefault("num_reducers", 3)
    kw.setdefault("seed", 7)
    kw.setdefault("batch_size", 48)
    ds = jjd.JaxShufflingDataset(
        files, num_epochs=num_epochs, num_trainers=1, rank=0,
        queue_name=f"torch-port-rebatch-{next(_queue_ids)}", num_workers=1,
        device_rebatch=device_rebatch,
        **{**_spec(stack), **kw})
    try:
        return _drain(ds, num_epochs, skips or {}, stack)
    finally:
        ds.close()


def _port_ds(files, device_rebatch, **kw):
    kw.setdefault("num_reducers", 3)
    kw.setdefault("seed", 7)
    kw.setdefault("batch_size", 48)
    kw.setdefault("num_epochs", 2)
    kw.setdefault("prefetch_size", 2)
    spec = _spec(kw.get("stack_features", False))
    return DeviceShufflingDataset(
        files, num_trainers=1, rank=0, device="cpu",
        device_rebatch=device_rebatch, **{**spec, **kw})


def _port(files, device_rebatch, *, skips=None, **kw):
    ds = _port_ds(files, device_rebatch, **kw)
    try:
        return _drain(ds, ds.num_epochs, skips or {},
                      kw.get("stack_features", False)), ds.transfer_stats()
    finally:
        ds.close()


def _assert_equal(got, want):
    assert len(got) == len(want)
    for (gf, gl), (wf, wl) in zip(got, want):
        assert len(gf) == len(wf)
        for a, b in zip(gf, wf):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert gl.dtype == wl.dtype
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("case,kw", [
    ("grid", {}),
    ("ragged_tail", {"drop_last": False, "batch_size": 50}),
    ("skips", {"skips": {0: 2, 1: 3}}),
    ("skips_ragged_tail", {"drop_last": False, "batch_size": 50,
                           "skips": {0: 1, 1: 4}}),
    ("fat_table", {"max_device_table_bytes": 64}),
    ("stack_features", {"stack_features": True}),
])
def test_bulk_stream_equals_jax(files, case, kw):
    bulk, stats = _port(files, True, **kw)
    per_batch, per_batch_stats = _port(files, False, **kw)
    want = _jax(files, False, **kw)
    assert len(want) > 4
    _assert_equal(bulk, _jax(files, True, **kw))
    _assert_equal(bulk, want)
    _assert_equal(per_batch, want)
    assert stats["binding"] == "bulk"
    assert per_batch_stats["binding"] == "per_batch"
    copies = stats["copies_by_epoch"]
    assert sorted(copies) == [0, 1]
    bulk_copies = sum(c["bulk"] for c in copies.values())
    if case == "fat_table":
        # One batch exceeds the 64-byte cap: every copy is per batch.
        assert bulk_copies == 0
    else:
        assert bulk_copies > 0
        assert stats["peak_chunk_bytes"] > 0
    if case == "ragged_tail":
        assert want[-1][1].shape[0] != 50


def test_consumer_side_skip_drops_the_head_of_a_bulk_chunk(files2):
    """A skip set after the producer entered the epoch drops the first
    batches of a bulk chunk on the consumer's side (epoch 1's first
    reducer table holds 3 whole batches of 32, so skip 2 lands inside its
    chunk)."""

    def run_port():
        ds = _port_ds(files2, True, batch_size=32, num_reducers=2, seed=3,
                      prefetch_size=1, feature_columns=["emb_1"],
                      feature_types=[np.int32], feature_shapes=None)
        ds.set_epoch(0)
        out = [np.asarray(lb) for _, lb in ds]
        entered = threading.Event()
        for _ in range(1000):  # the producer rolls into epoch 1 by itself
            if 1 in ds._started_epochs:
                break
            entered.wait(0.01)
        assert 1 in ds._started_epochs
        ds.set_epoch(1, skip_batches=2)
        assert ds._consumer_skip == 2
        out += [np.asarray(lb) for _, lb in ds]
        chunks = ds.transfer_stats()["copies_by_epoch"][1]["chunk_batches"]
        ds.close()
        return out, chunks

    got, chunks = run_port()
    assert list(chunks.items()) == [(3, 1), (4, 1)]
    want = _jax(files2, False, batch_size=32, num_reducers=2, seed=3,
                feature_columns=["emb_1"], feature_types=[np.int32],
                feature_shapes=None, skips={1: 2})
    assert len(got) == len(want) == 8 + 6
    for g, (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_repeated_set_epoch_skips_once_and_a_big_skip_spares_the_next_epoch(
        files2):
    kw = {"batch_size": 16, "num_reducers": 2, "seed": 0,
          "feature_columns": ["emb_1"], "feature_types": [np.int32],
          "feature_shapes": None}
    ds = _port_ds(files2, True, num_epochs=1, **kw)
    ds.set_epoch(0, skip_batches=4)
    ds.set_epoch(0, skip_batches=4)  # same epoch, same skip: no double drop
    assert len(list(ds)) == 256 // 16 - 4
    ds.close()

    ds = _port_ds(files2, True, num_epochs=2, **kw)
    ds.set_epoch(0)
    it = iter(ds)
    next(it)  # the producer has entered epoch 0
    it.close()
    ds.set_epoch(1, skip_batches=10_000)
    assert list(ds) == []
    assert ds._consumer_skip == 0  # nothing leaks into a later iteration
    ds.close()


def test_producer_rolls_into_the_next_epoch_and_epochs_go_in_order(files2):
    ds = _port_ds(files2, True, batch_size=16, num_reducers=2, seed=0,
                  prefetch_size=4, feature_columns=["emb_1"],
                  feature_types=[np.int32], feature_shapes=None,
                  num_epochs=3)
    ds.set_epoch(0)
    assert len(list(ds)) == 256 // 16
    with pytest.raises(ValueError, match="sequential"):
        ds.set_epoch(2)
    ready = threading.Event()
    for _ in range(1000):
        if ds._out.qsize():
            break
        ready.wait(0.01)
    assert ds._out.qsize() > 0, "no prefetch across the epoch boundary"
    ds.set_epoch(1)
    it = iter(ds)
    next(it)
    it.close()  # left mid-way: the epoch counts as consumed
    ds.set_epoch(2)
    assert len(list(ds)) == 256 // 16
    ds.close()


@pytest.mark.parametrize("explicit", [True, False])
def test_repacking_spec_rejected_when_explicit_and_per_batch_when_auto(
        files2, explicit):
    """A flat column reshaped to (2,) repacks the sample dimension: an
    explicit device_rebatch=True fails, an "auto" one (marked so on the
    converter, as "auto" is per-batch on the CPU) falls back to per-batch
    copies and the JAX package's stream."""
    kw = {"batch_size": 16, "num_reducers": 2, "seed": 0, "num_epochs": 1,
          "feature_columns": ["emb_1"], "feature_shapes": [(2,)],
          "feature_types": [np.int32]}
    ds = _port_ds(files2[:1], True, **kw)
    ds.set_epoch(0)
    if explicit:
        with pytest.raises(ValueError, match="sample"):
            list(ds)
        ds.close()
        return
    ds._converter.device_rebatch_auto = True
    got = [_batch(f, lb, False) for f, lb in ds]
    assert ds._converter.device_rebatch is False
    ds.close()
    want = _jax(files2[:1], False, **kw)
    assert len(got) == len(want) == 8
    _assert_equal(got, want)


def test_empty_reducer_tables(tmp_path):
    """16 reducers over 6 rows: most reducer tables are empty."""
    small = _write_files(tmp_path, 1, 6)
    kw = {"batch_size": 2, "num_reducers": 16, "seed": 0, "num_epochs": 1,
          "drop_last": False, "feature_columns": ["emb_1"],
          "feature_types": [np.int32], "feature_shapes": None}
    got, _ = _port(small, True, **kw)
    assert sum(lb.shape[0] for _, lb in got) == 6
    _assert_equal(got, _jax(small, True, **kw))


def test_close_wakes_a_blocked_consumer_and_a_dropped_dataset_stops(files2):
    kw = {"batch_size": 16, "num_reducers": 2, "seed": 0, "prefetch_size": 1,
          "feature_columns": ["emb_1"], "feature_types": [np.int32],
          "feature_shapes": None}
    ds = _port_ds(files2, True, num_epochs=1, **kw)
    ds.set_epoch(0)
    it = iter(ds)
    next(it)
    errors = []
    resumed = threading.Event()
    release = threading.Event()

    def consume_rest():
        try:
            for _ in it:
                resumed.set()
                release.wait(10)  # a slow consumer
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=consume_rest)
    t.start()
    assert resumed.wait(10)
    ds.close()
    release.set()
    t.join(timeout=10)
    assert not t.is_alive(), "consumer hung after close()"
    assert errors and "closed" in str(errors[0])

    ds = _port_ds(files2, True, num_epochs=3, **kw)
    ds.set_epoch(0)
    it = iter(ds)
    next(it)
    producer = ds._thread  # holds no reference to the dataset
    assert producer.is_alive()
    del it, ds  # no close() anywhere
    gc.collect()
    producer.join(timeout=10)
    assert not producer.is_alive()
