"""The PyTorch port's data path against the JAX package's: same Parquet
files, seed and reducer count must give the same batch stream, exactly.

Files come from the JAX package's generator (20k rows, 4 files). The JAX
side is ``JaxShufflingDataset(**dlrm_spec(), device_rebatch=False)``; the
port side is ``DeviceShufflingDataset(device="cpu")``. Two ranks run in
one process off one shared queue. The port widens int8/int16 index columns
to int32 on the device, so values are compared exactly and the widened
dtype is checked separately.
"""

import itertools

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import dataset as jds
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu import native as jnative
from ray_shuffling_data_loader_tpu.ops import partition as jpart
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import data_generation as tdg
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import partition as tpart
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset, make_cast_transform)
from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo as twl

NUM_ROWS = 20_000
NUM_FILES = 4
NUM_TRAINERS = 2
NUM_EPOCHS = 2
NUM_REDUCERS = 4
BATCH = 1000
SEED = 7

_queue_ids = itertools.count()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_shuffle"))
    filenames, _ = jdg.generate_data_local(NUM_ROWS, NUM_FILES, 1, 0.0, d)
    return filenames


def _jax_stream(files, num_trainers, skips=None):
    """{(epoch, rank): [(features, label) numpy]} from the JAX package."""
    spec = jwl.dlrm_spec()
    queue, result = jds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, num_trainers, BATCH, 2,
        num_reducers=NUM_REDUCERS, seed=SEED, num_workers=1,
        queue_name=f"torch-port-parity-{next(_queue_ids)}",
        map_transform=jjd.make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"]))
    sets = [jjd.JaxShufflingDataset(
        files, NUM_EPOCHS, num_trainers, BATCH, rank, batch_queue=queue,
        shuffle_result=result, num_reducers=NUM_REDUCERS, seed=SEED,
        device_rebatch=False, **spec) for rank in range(num_trainers)]
    try:
        return _drain(sets, num_trainers, skips)
    finally:
        queue.shutdown()


def _port_stream(files, num_trainers, skips=None):
    spec = twl.dlrm_spec()
    queue, result = tds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, num_trainers, 2, num_reducers=NUM_REDUCERS,
        seed=SEED, map_transform=make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"]))
    sets = [DeviceShufflingDataset(
        files, NUM_EPOCHS, num_trainers, BATCH, rank, batch_queue=queue,
        shuffle_result=result, num_reducers=NUM_REDUCERS, seed=SEED,
        device="cpu", **spec) for rank in range(num_trainers)]
    return _drain(sets, num_trainers, skips)


def _drain(sets, num_trainers, skips):
    out = {}
    for epoch in range(NUM_EPOCHS):
        for rank in range(num_trainers):
            skip = (skips or {}).get((epoch, rank), 0)
            sets[rank].set_epoch(epoch, skip_batches=skip)
            out[(epoch, rank)] = [
                ([np.asarray(f) for f in feats], np.asarray(label))
                for feats, label in sets[rank]]
    return out


def _assert_streams_equal(port, ref):
    assert port.keys() == ref.keys()
    for key in ref:
        assert len(port[key]) == len(ref[key]), key
        for (pf, pl), (rf, rl) in zip(port[key], ref[key]):
            assert len(pf) == len(rf)
            for a, b in zip(pf, rf):
                assert a.shape == b.shape == (BATCH, 1)
                np.testing.assert_array_equal(a, b)
            assert pl.dtype == rl.dtype == np.float32
            np.testing.assert_array_equal(pl, rl)


@pytest.fixture(scope="module")
def jax_stream(files):
    return _jax_stream(files, NUM_TRAINERS)


def test_stream_equals_jax_two_trainers_two_epochs(files, jax_stream):
    port = _port_stream(files, NUM_TRAINERS)
    _assert_streams_equal(port, jax_stream)
    # drop_last: each rank gets its reducers' rows in whole batches.
    assert sum(len(v) for v in port.values()) == 38


def test_stream_dtypes_are_widened_on_device(files):
    port = _port_stream(files, 1)
    features, label = port[(0, 0)][0]
    # DLRM index columns arrive int8/int16/int32 and are widened to int32.
    assert all(f.dtype == np.int32 for f in features)
    assert label.dtype == np.float32


def test_skip_batches_resume_equals_jax(files, jax_stream):
    skips = {(0, 0): 3, (1, 1): 9, (1, 0): 20}
    port = _port_stream(files, NUM_TRAINERS, skips)
    ref = _jax_stream(files, NUM_TRAINERS, skips)
    _assert_streams_equal(port, ref)
    # The resumed stream is the uninterrupted stream minus its head.
    for key, skip in skips.items():
        _assert_streams_equal({key: port[key]},
                              {key: jax_stream[key][skip:]})


def test_every_row_once_per_epoch(files):
    queue, result = tds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, 1, num_reducers=3, seed=1)
    ds = tds.ShufflingDataset(files, NUM_EPOCHS, 1, 777, 0,
                              batch_queue=queue, shuffle_result=result)
    orders = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        batches = list(ds)
        assert all(b.num_rows == 777 for b in batches[:-1])
        keys = np.concatenate([b.column("key").to_numpy() for b in batches])
        np.testing.assert_array_equal(np.sort(keys), np.arange(NUM_ROWS))
        orders.append(keys)
    assert not np.array_equal(orders[0], orders[1])


@pytest.mark.parametrize("seed,epoch,file_index",
                         [(0, 0, 0), (7, 1, 3), (2**40 + 5, 12, 999)])
def test_partition_key_and_hash_match_jax(seed, epoch, file_index):
    key = tpart.partition_key(seed, epoch, file_index)
    assert key == jpart.partition_key(seed, epoch, file_index)
    for num_reducers, row0 in [(1, 0), (7, 0), (16, 12345)]:
        np.testing.assert_array_equal(
            tpart.hash_assign(5000, num_reducers, key, row0=row0),
            jnative.hash_assign(5000, num_reducers, key, row0=row0))


@pytest.mark.parametrize("num_rows,num_reducers", [(1, 1), (1000, 3),
                                                   (9999, 16)])
def test_plan_partition_flat_matches_jax(num_rows, num_reducers):
    flat, offsets = tpart.plan_partition_flat(num_rows, num_reducers, 5, 2,
                                              1)
    jflat, joffsets = jpart.plan_partition_flat(num_rows, num_reducers, 5,
                                                2, 1)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(offsets, joffsets)


def test_reduce_permutation_and_splits_match_jax():
    for r in range(3):
        np.testing.assert_array_equal(
            tpart.permutation(1234, tpart.reduce_rng(9, 1, r)),
            jpart.permutation(1234, jpart.reduce_rng(9, 1, r)))
    for total, parts in [(8, 1), (8, 3), (3, 5), (19, 4)]:
        assert tpart.split_sizes(total, parts) == jpart.split_sizes(total,
                                                                    parts)
        assert tpart.contiguous_splits(list(range(total)), parts) == \
            jpart.contiguous_splits(list(range(total)), parts)


def test_shuffle_failure_reaches_consumer(tmp_path):
    bad = str(tmp_path / "missing.parquet")
    queue, result = tds.create_batch_queue_and_shuffle([bad], 1, 1,
                                                       num_reducers=2)
    ds = tds.ShufflingDataset([bad], 1, 1, 10, 0, batch_queue=queue,
                              shuffle_result=result)
    ds.set_epoch(0)
    with pytest.raises((RuntimeError, OSError)):
        list(ds)


def test_port_generator_schema_and_determinism(tmp_path):
    files, _ = tdg.generate_data(1000, 3, str(tmp_path / "a"), seed=4)
    again, _ = tdg.generate_data(1000, 3, str(tmp_path / "b"), seed=4)
    import pyarrow.parquet as pq
    tables = [pq.read_table(f) for f in files]
    assert sum(t.num_rows for t in tables) == 1000
    assert tables[0].column_names == ["key"] + list(jdg.DATA_SPEC)
    for f, g in zip(files, again):
        assert pq.read_table(f).equals(pq.read_table(g))
    for name, (low, high, _) in tdg.DATA_SPEC.items():
        col = np.concatenate([t.column(name).to_numpy() for t in tables])
        assert col.min() >= low and col.max() < high


def test_map_reduce_rows_are_a_permutation(tmp_path):
    files, _ = tdg.generate_data(3000, 2, str(tmp_path), seed=1)
    outs = [tsh.shuffle_map(f, 4, 3, 0, i) for i, f in enumerate(files)]
    keys = np.concatenate([
        tsh.shuffle_reduce(r, 3, 0, outs).column("key").to_numpy()
        for r in range(4)])
    np.testing.assert_array_equal(np.sort(keys), np.arange(3000))


def test_device_none_without_cuda_raises(files):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceShufflingDataset(files, 1, 1, 100, 0, **twl.dlrm_spec())
