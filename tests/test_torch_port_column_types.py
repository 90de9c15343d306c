"""Columns beyond the null-free primitives, against the JAX package: the
port's re-batcher and reducer concatenate with permissive promotion, its
shuffle takes nested and nullable columns (Arrow's concat + take, where
the JAX package falls back too) and its Arrow -> NumPy conversion has the
JAX package's arms.

Each file holds a ``key`` column and one (``list``, ``nullable_int``,
``nullable_binary``) or all of the columns that are not numpy rows; the
port's map outputs, reducer outputs and re-batched streams equal the JAX
package's bit for bit (``pa.Table.equals``) for the same files, seed and
epoch.
"""

import importlib
import itertools

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import dataset as jds
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu import spill as jspill
from ray_shuffling_data_loader_tpu.native import image as jni
from ray_shuffling_data_loader_tpu.workloads import imagenet as jim
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import device_dataset as tdd
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import spill as tspill
from ray_shuffling_data_loader_tpu_torch.workloads import imagenet as tim

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

# The package's ``shuffle`` name is its function; the module by path.
jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

ROWS_PER_FILE, NUM_FILES = 60, 2
NUM_REDUCERS, NUM_EPOCHS, NUM_TRAINERS, BATCH, SEED = 4, 2, 1, 7, 3
KINDS = ("list", "nullable_int", "nullable_binary", "all")
_queue_ids = itertools.count()


def _columns(kind, rng, n):
    out = {}
    if kind in ("list", "all"):
        lengths = rng.integers(0, 4, n)
        out["tokens"] = pa.array(
            [list(rng.integers(0, 100, k)) for k in lengths],
            type=pa.list_(pa.int64()))
    if kind in ("nullable_int", "all"):
        values = rng.integers(-50, 50, n)
        out["count"] = pa.array(
            [None if v % 5 == 0 else int(v) for v in values], pa.int64())
    if kind in ("nullable_binary", "all"):
        out["image"] = pa.array(
            [None if i % 7 == 3 else bytes([i % 251]) * (i % 5)
             for i in range(n)], pa.binary())
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``{kind: [path, ...]}``."""
    root = tmp_path_factory.mktemp("column_types")
    rng = np.random.default_rng(SEED)
    out = {}
    for kind in KINDS:
        paths = []
        for f in range(NUM_FILES):
            n = ROWS_PER_FILE
            table = pa.table(dict(
                key=np.arange(f * n, (f + 1) * n, dtype=np.int64),
                **_columns(kind, rng, n)))
            path = str(root / f"{kind}_{f}.parquet")
            pq.write_table(table, path)
            paths.append(path)
        out[kind] = paths
    return out


def _same_tables(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.schema.equals(w.schema), (what, i, g.schema, w.schema)
        assert g.equals(w), f"{what}: table {i} differs"


# ---------------------------------------------------------------------------
# Permissive promotion in the re-batcher and the reducer concat
# ---------------------------------------------------------------------------


def _offset_width_tables():
    narrow = pa.table({"b": pa.array([b"a", b"bb", b"ccc"], pa.binary()),
                       "k": pa.array([0, 1, 2], pa.int64())})
    wide = pa.table({"b": pa.array([b"dddd", b"", b"f"], pa.large_binary()),
                     "k": pa.array([3, 4, 5], pa.int64())})
    return narrow, wide


@pytest.mark.parametrize("drop_last", [False, True])
def test_slice_batches_spans_binary_and_large_binary_as_jax(drop_last):
    narrow, wide = _offset_width_tables()
    # Batches of 4 over 3 + 3 rows: the first spans both tables.
    got = list(tds.slice_batches(iter([narrow, wide]), 4, drop_last))
    want = list(jds.slice_batches(iter([narrow, wide]), 4, drop_last))
    _same_tables(got, want, "slice_batches")
    assert got[0].schema.field("b").type == pa.large_binary()


def test_reducer_concat_over_offset_widths_equals_jax():
    narrow, wide = _offset_width_tables()
    for reduce_index in range(3):
        got = tsh.shuffle_reduce(reduce_index, SEED, 0, [narrow, wide])
        want = jsh.shuffle_reduce(reduce_index, SEED, 0, [narrow, wide])
        _same_tables([got], [want], f"reducer {reduce_index}")


# ---------------------------------------------------------------------------
# Nested and nullable columns through the shuffle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_map_outputs_equal_jax(files, kind):
    for epoch in range(NUM_EPOCHS):
        for file_index, path in enumerate(files[kind]):
            got = tsh.shuffle_map(path, NUM_REDUCERS, SEED, epoch,
                                  file_index)
            want = jsh.shuffle_map(path, NUM_REDUCERS, SEED, epoch,
                                   file_index)
            _same_tables([c.materialize() for c in got],
                         [c.materialize() for c in want],
                         f"{kind} e{epoch} f{file_index}")


def test_nullable_binary_column_reduces_as_jax(tmp_path):
    # The file the port's map used to refuse (ValueError on "image").
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({"image": pa.array([b"a", None], pa.binary()),
                             "key": np.arange(2, dtype=np.int64)}), path)
    got_map = tsh.shuffle_map(path, 2, SEED, 0, 0)
    want_map = jsh.shuffle_map(path, 2, SEED, 0, 0)
    _same_tables([c.materialize() for c in got_map],
                 [c.materialize() for c in want_map], "map")
    got = [tsh.shuffle_reduce(r, SEED, 0, [got_map]) for r in range(2)]
    want = [jsh.recompute_reducer_output([path], 2, SEED, 0, r)
            for r in range(2)]
    _same_tables(got, want, "reduce")


def _collect(run, paths, unwrap, **kw):
    """``{(rank, epoch): [reducer table, ...]}`` of one shuffle."""
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    run(paths, consumer, NUM_EPOCHS, NUM_REDUCERS, NUM_TRAINERS, seed=SEED,
        num_workers=2, **kw)
    return {k: [unwrap(r.result()) for r in v] for k, v in refs.items()}


@pytest.fixture(scope="module")
def jax_reducers(files):
    return {kind: _collect(jsh.shuffle, files[kind], jspill.unwrap,
                           executor_backend="thread", file_cache=None)
            for kind in KINDS}


# (kind, executor backend, file cache, spilling budget).
_REDUCE_CASES = ([(kind, "thread", None, False) for kind in KINDS]
                 + [(kind, "thread", "auto", False) for kind in KINDS]
                 + [(kind, "thread", None, True) for kind in KINDS]
                 + [("all", "process", "auto", False)])


@pytest.mark.parametrize("kind,backend,cache,spilling", _REDUCE_CASES)
def test_reducer_outputs_equal_jax(files, jax_reducers, tmp_path, kind,
                                   backend, cache, spilling):
    kw = dict(executor_backend=backend, file_cache=cache)
    if spilling:
        kw.update(max_inflight_bytes=1, spill_dir=str(tmp_path / "spill"))
    before = tspill.process_spill_totals()["spills"]
    got = _collect(tsh.shuffle, files[kind], tspill.unwrap, **kw)
    want = jax_reducers[kind]
    assert sorted(got) == sorted(want)
    for key in want:
        _same_tables(got[key], want[key], f"{kind} {key}")
    if spilling:
        spilled = tspill.process_spill_totals()["spills"] - before
        assert spilled == NUM_EPOCHS * NUM_REDUCERS


def _batches(ds):
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        out.append(list(ds))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_rebatched_stream_equals_jax(files, kind):
    got = _batches(tds.ShufflingDataset(
        files[kind], NUM_EPOCHS, NUM_TRAINERS, BATCH, 0,
        num_reducers=NUM_REDUCERS, seed=SEED, num_workers=2))
    want = _batches(jds.ShufflingDataset(
        files[kind], NUM_EPOCHS, NUM_TRAINERS, BATCH, 0,
        num_reducers=NUM_REDUCERS, seed=SEED, num_workers=2,
        queue_name=f"torch-port-column-types-{next(_queue_ids)}"))
    for epoch, (g, w) in enumerate(zip(got, want)):
        _same_tables(g, w, f"{kind} epoch {epoch}")
    assert sum(t.num_rows for t in got[0]) == ROWS_PER_FILE * NUM_FILES


def _outcome(fn, *args):
    """``("ok", value)`` or ``("raised", exception type)``."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # the type is what is compared
        return "raised", type(e)


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_decode_transform_meets_a_null_as_jax(decoder):
    # The JAX package decodes with PIL where it resizes, and with its
    # native decoder otherwise (where this host builds it).
    if decoder == "native" and not jni.available():
        pytest.skip("the JAX package's native decoder does not build here")
    resize = decoder == "pil"
    table = pa.table({"image": pa.array([b"", None], pa.binary()),
                      "label": pa.array([1, 2], pa.int32())})
    for rows in (table.slice(1), table):
        got = _outcome(tim.decode_transform(8, 8, resize=resize,
                                            decoder=decoder), rows)
        want = _outcome(jim.decode_transform(8, 8, resize=resize), rows)
        assert got == want, (decoder, got, want)


# ---------------------------------------------------------------------------
# Arrow -> NumPy, every arm of the JAX package's conversion
# ---------------------------------------------------------------------------


def _chunked(*arrays):
    return pa.chunked_array(list(arrays))


_FSL = pa.list_(pa.int32(), 3)
_CONVERT_CASES = {
    "primitive_one_chunk": (_chunked(pa.array([1, 2, 3], pa.int64())),
                            np.float32),
    "primitive_two_chunks": (_chunked(pa.array([1, 2], pa.int64()),
                                      pa.array([3], pa.int64())), np.int32),
    "nullable_int": (_chunked(pa.array([1, None, 3], pa.int64())),
                     np.float64),
    "empty": (pa.chunked_array([], pa.float32()), np.float32),
    "fixed_size_list": (_chunked(pa.array([[1, 2, 3], [4, 5, 6]], _FSL)),
                        np.float32),
    "fixed_size_list_sliced": (
        _chunked(pa.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], _FSL)
                 .slice(1)), np.int64),
    "fixed_size_list_two_chunks": (
        _chunked(pa.array([[1, 2, 3]], _FSL), pa.array([[4, 5, 6]], _FSL)),
        np.int32),
    "fixed_size_list_null_value": (
        _chunked(pa.array([[1, None, 3], [4, 5, 6]], _FSL)), np.float64),
    "list": (_chunked(pa.array([[1, 2], [3, 4]], pa.list_(pa.int64()))),
             np.int32),
    "large_list": (_chunked(pa.array([[1.5], [2.5]],
                                     pa.large_list(pa.float64()))),
                   np.float32),
    "ragged_list": (_chunked(pa.array([[1, 2], [3]],
                                      pa.list_(pa.int64()))), np.int64),
    "list_view_ndarray_cells": (
        _chunked(pa.array([[1, 2], [3, 4]], pa.list_view(pa.int64()))),
        np.int64),
    "map_list_cells": (
        _chunked(pa.array([[(1, 2)], [(3, 4)]],
                          pa.map_(pa.int64(), pa.int64()))), np.int64),
    "binary_cells": (_chunked(pa.array([b"a", b"b"], pa.binary())),
                     np.uint8),
    "string_cells": (_chunked(pa.array(["a", "b"])), np.float32),
    "struct_cells": (_chunked(pa.array([{"x": 1}, {"x": 2}])), np.int64),
}


@pytest.mark.parametrize("case", sorted(_CONVERT_CASES))
def test_column_to_numpy_arms_equal_jax(case):
    column, dtype = _CONVERT_CASES[case]
    got = _outcome(tdd._column_to_numpy, column, "col", np.dtype(dtype))
    want = _outcome(jjd._column_to_numpy, column, np.dtype(dtype))
    assert got[0] == want[0], (case, got, want)
    if got[0] == "raised":
        assert got[1] is want[1], (case, got, want)
        return
    g, w = got[1], want[1]
    assert g.dtype == w.dtype and g.shape == w.shape, (case, g, w)
    assert g.flags.c_contiguous
    np.testing.assert_array_equal(g, w)


def test_column_to_numpy_takes_one_chunk_without_a_copy():
    column = _chunked(pa.array(np.arange(6, dtype=np.int64)))
    arr = tdd._column_to_numpy(column, "col", np.dtype(np.int64))
    buf = column.chunk(0).buffers()[1]
    assert arr.__array_interface__["data"][0] == buf.address
    assert not arr.flags.writeable
