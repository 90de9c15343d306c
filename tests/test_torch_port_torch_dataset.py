"""The port's Torch binding (``torch_dataset.py``) against the JAX
package's: the column-spec rules and their exception types, the Arrow ->
tensor conversion (list and object columns included), and the tensor
stream of ``TorchShufflingDataset`` over the same files and seed (two
epochs, two ranks of one process through a named queue, a bounded
queue, a ``skip_batches`` resume), tensor for tensor.
"""

import itertools

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ray_shuffling_data_loader_tpu import torch_dataset as jtd
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import torch_dataset as ttd

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

SEED, NUM_EPOCHS, NUM_REDUCERS, BATCH = 5, 2, 3, 16
ROWS_PER_FILE, NUM_FILES = 70, 3
_names = itertools.count()


def _queue_name():
    return f"torch-port-torch-dataset-{next(_names)}"


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raised", exception type)``."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as e:  # the type is what is compared
        return "raised", type(e)


# ---------------------------------------------------------------------------
# The column spec
# ---------------------------------------------------------------------------

_SPEC_CASES = {
    # The JAX package's own cases.
    "scalars": dict(feature_columns="a", label_column="y"),
    "shape_count_mismatch": dict(feature_columns=["a", "b"],
                                 feature_shapes=[1], label_column="y"),
    "numpy_type": dict(feature_columns=["a"], feature_types=[np.float32],
                       label_column="y"),
    "bfloat16_feature": dict(feature_columns=["a"],
                             feature_types=[torch.bfloat16],
                             label_column="y"),
    # More.
    "shapes_mixed": dict(feature_columns=["a", "b", "c"],
                         feature_shapes=[2, (2, 3), None],
                         label_column="y", label_shape=2),
    "shape_list": dict(feature_columns=["a"], feature_shapes=[[4, 1]],
                       label_column="y"),
    "shape_scalar": dict(feature_columns="a", feature_shapes=3,
                         label_column="y"),
    "empty_shapes": dict(feature_columns=["a"], feature_shapes=[],
                         label_column="y"),
    "type_scalar": dict(feature_columns="a", feature_types=torch.int32,
                        label_column="y"),
    "type_count_mismatch": dict(feature_columns=["a", "b"],
                                feature_types=[torch.int64],
                                label_column="y"),
    "every_type": dict(feature_columns=[str(i) for i in range(9)],
                       feature_types=list(ttd._TORCH_TO_NUMPY),
                       label_column="y", label_type=torch.int64),
    "string_type": dict(feature_columns=["a"], feature_types=["float32"],
                        label_column="y"),
    "complex_feature": dict(feature_columns=["a"],
                            feature_types=[torch.complex64],
                            label_column="y"),
    "bfloat16_label": dict(feature_columns=["a"], label_column="y",
                           label_type=torch.bfloat16),
    "numpy_label": dict(feature_columns=["a"], label_column="y",
                        label_type=np.float32),
    "no_columns": dict(),
}


@pytest.mark.parametrize("case", sorted(_SPEC_CASES))
def test_spec_normalization_equals_jax(case):
    kwargs = _SPEC_CASES[case]
    got = _outcome(ttd._normalize_torch_data_spec, **kwargs)
    want = _outcome(jtd._normalize_torch_data_spec, **kwargs)
    assert got == want, (case, got, want)


def test_numpy_dtypes_equal_jax():
    assert ttd._TORCH_TO_NUMPY == jtd._TORCH_TO_NUMPY


# ---------------------------------------------------------------------------
# Arrow -> tensors
# ---------------------------------------------------------------------------

_FSL4 = pa.list_(pa.int64(), 4)
_CONVERT_TABLE = pa.table({
    "a": pa.array([1, 2, 3, 4], pa.int64()),
    "pix": pa.array([[i, i + 1, i + 2, i + 3] for i in range(4)], _FSL4),
    "ragged_free": pa.array([[1, 2], [3, 4], [5, 6], [7, 8]],
                            pa.list_(pa.int32())),
    "cells": pa.array([[1, 2], [3, 4], [5, 6], [7, 8]],
                      pa.list_view(pa.int64())),
    "pairs": pa.array([[(1, 2)], [(3, 4)], [(5, 6)], [(7, 8)]],
                      pa.map_(pa.int64(), pa.int64())),
    "blob": pa.array([b"a", b"b", b"c", b"d"], pa.binary()),
    "y": pa.array([0.0, 1.0, 0.0, 1.0], pa.float64()),
    "y2": pa.array([[0.5, 1.5]] * 4, pa.list_(pa.float32(), 2)),
})

_CONVERT_CASES = {
    "primitive": dict(feature_columns=["a"], feature_types=[torch.int32],
                      label_column="y"),
    "fixed_size_list_shaped": dict(feature_columns=["pix", "a"],
                                   feature_shapes=[(2, 2), None],
                                   feature_types=[torch.uint8, torch.int64],
                                   label_column="y2", label_shape=2,
                                   label_type=torch.float64),
    "list_stacked": dict(feature_columns=["ragged_free"],
                         feature_shapes=[2], feature_types=[torch.int64],
                         label_column="y", label_type=torch.bool),
    "object_ndarray_cells": dict(feature_columns=["cells"],
                                 feature_shapes=[(2,)],
                                 feature_types=[torch.int16],
                                 label_column="y"),
    "object_list_cells": dict(feature_columns=["pairs"],
                              feature_shapes=[(1, 2)],
                              feature_types=[torch.int64],
                              label_column="y"),
    "default_types": dict(feature_columns=["a", "pix"], label_column="y"),
    "unsupported_cells": dict(feature_columns=["blob"],
                              feature_types=[torch.int64], label_column="y"),
}


def _same_batch(got, want, what):
    gf, gl = got
    wf, wl = want
    assert len(gf) == len(wf), what
    for g, w in zip(gf + [gl], wf + [wl]):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g, w)
        assert torch.equal(g, w), what


@pytest.mark.parametrize("case", sorted(_CONVERT_CASES))
def test_convert_to_tensor_equals_jax(case):
    kwargs = _CONVERT_CASES[case]
    two_chunks = pa.concat_tables(
        [_CONVERT_TABLE.slice(0, 1), _CONVERT_TABLE.slice(1)],
        promote_options="permissive")
    for table in (_CONVERT_TABLE, two_chunks):
        got = _outcome(ttd.convert_to_tensor, table,
                       *ttd._normalize_torch_data_spec(**kwargs))
        want = _outcome(jtd.convert_to_tensor, table,
                        *jtd._normalize_torch_data_spec(**kwargs))
        assert got[0] == want[0], (case, got, want)
        if got[0] == "raised":
            assert got[1] is want[1], (case, got, want)
        else:
            _same_batch(got[1], want[1], case)


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_binding")
    rng = np.random.default_rng(SEED)
    paths = []
    for f in range(NUM_FILES):
        n = ROWS_PER_FILE
        path = str(root / f"in_{f}.parquet")
        pq.write_table(pa.table({
            "key": pa.array(np.arange(f * n, (f + 1) * n), pa.int64()),
            "emb": pa.array(rng.integers(0, 50, n), pa.int64()),
            "tokens": pa.array(rng.integers(0, 9, (n, 3)).tolist(),
                               pa.list_(pa.int64(), 3)),
            "labels": pa.array(rng.random(n), pa.float64()),
        }), path)
        paths.append(path)
    return paths


_SPEC = dict(feature_columns=["emb", "tokens", "key"],
             feature_shapes=[None, (3,), None],
             feature_types=[torch.int32, torch.int64, torch.int64],
             label_column="labels", label_type=torch.float32)


def _stream(module, files, epochs=range(NUM_EPOCHS), skips=None, **kw):
    kw.setdefault("queue_name", _queue_name())
    ds = module.TorchShufflingDataset(
        files, NUM_EPOCHS, kw.pop("num_trainers", 1), BATCH,
        kw.pop("rank", 0), num_reducers=NUM_REDUCERS, seed=SEED,
        num_workers=2, **_SPEC, **kw)
    out = []
    for epoch in epochs:
        ds.set_epoch(epoch, skip_batches=(skips or {}).get(epoch, 0))
        out.append(list(ds))
    return out


def _same_stream(got, want, what):
    assert len(got) == len(want), what
    for epoch, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (what, epoch)
        for i, (gb, wb) in enumerate(zip(g, w)):
            _same_batch(gb, wb, f"{what}: epoch {epoch} batch {i}")


def test_two_epoch_stream_equals_jax(files):
    got = _stream(ttd, files)
    _same_stream(got, _stream(jtd, files), "stream")
    for epoch in got:
        keys = torch.cat([f[2].reshape(-1) for f, _ in epoch])
        assert sorted(keys.tolist()) == list(range(ROWS_PER_FILE
                                                   * NUM_FILES))


@pytest.mark.parametrize("drop_last", [False, True])
def test_bounded_queue_stream_equals_jax(files, drop_last):
    got = _stream(ttd, files, max_batch_queue_size=1, drop_last=drop_last)
    want = _stream(jtd, files, max_batch_queue_size=1, drop_last=drop_last)
    _same_stream(got, want, "bounded")


def _two_ranks(module, files):
    """Rank 0 shuffles for both ranks into its named queue; rank 1 (built
    after it) reads its queue from there by name."""
    name = _queue_name()
    rank0 = module.TorchShufflingDataset(
        files, NUM_EPOCHS, 2, BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, num_workers=2, queue_name=name, **_SPEC)
    rank1 = module.TorchShufflingDataset(
        files, NUM_EPOCHS, 2, BATCH, 1, num_reducers=NUM_REDUCERS,
        seed=SEED, queue_name=name, **_SPEC)
    out = {0: [], 1: []}
    for epoch in range(NUM_EPOCHS):
        for rank, ds in ((1, rank1), (0, rank0)):
            ds.set_epoch(epoch)
            out[rank].append(list(ds))
    return out


def test_two_ranks_through_a_named_queue_equal_jax(files):
    got = _two_ranks(ttd, files)
    want = _two_ranks(jtd, files)
    for rank in (0, 1):
        _same_stream(got[rank], want[rank], f"rank {rank}")
    for epoch in range(NUM_EPOCHS):
        keys = torch.cat([f[2].reshape(-1) for rank in (0, 1)
                          for f, _ in got[rank][epoch]])
        assert sorted(keys.tolist()) == list(range(ROWS_PER_FILE
                                                   * NUM_FILES))


def test_skip_batches_resume_equals_the_tail(files):
    full = _stream(ttd, files)
    resumed = _stream(ttd, files, epochs=[1], skips={1: 3})
    _same_stream(resumed, [full[1][3:]], "resume")
    _same_stream(resumed, _stream(jtd, files, epochs=[1], skips={1: 3}),
                 "resume vs JAX")


def test_bad_spec_raises_before_a_shuffle_starts(files):
    name = _queue_name()
    with pytest.raises(TypeError):
        ttd.TorchShufflingDataset(
            files, NUM_EPOCHS, 1, BATCH, 0, feature_columns=["emb"],
            feature_types=[np.int64], label_column="labels",
            queue_name=name)
    with pytest.raises(TimeoutError):
        tmq.connect_queue(name, retries=0)
