"""The port's ImageNet-on-Parquet path against the JAX package's: the
same seeded shards, the same decoded pixels, the same binary-column
shuffle (reducer outputs equal, 0-row reducers included) and the same
uint8 image batch stream, exactly.

The JAX side's decode uses its native decoder where this host can build
it, and PIL otherwise; the port names its decoder and is held against it
with both. PNG is lossless, so every decoder gives the same pixels.
"""

import ast
import fnmatch
import importlib
import itertools
import os

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu.workloads import imagenet as jim
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.native import image as tnative
from ray_shuffling_data_loader_tpu_torch.workloads import imagenet as tim

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)


H = W = 32
NUM_IMAGES, NUM_FILES, NUM_CLASSES = 96, 3, 10
NUM_REDUCERS, BATCH, NUM_EPOCHS, SEED = 4, 16, 2, 0

# The package's ``shuffle`` name is its function; the module by path.
jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")
_queue_ids = itertools.count()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """``(jax_files, port_files)``, each generated by its own package."""
    jdir = str(tmp_path_factory.mktemp("jax_images"))
    tdir = str(tmp_path_factory.mktemp("port_images"))
    jfiles, jbytes = jim.generate_imagenet_parquet(
        NUM_IMAGES, NUM_FILES, jdir, height=H, width=W,
        num_classes=NUM_CLASSES, seed=SEED)
    tfiles, tbytes = tim.generate_imagenet_parquet(
        NUM_IMAGES, NUM_FILES, tdir, height=H, width=W,
        num_classes=NUM_CLASSES, seed=SEED)
    assert jbytes == tbytes
    return jfiles, tfiles


def _payload_table(files):
    return pq.read_table(files[0])


def test_shards_are_byte_identical_to_jax(shards):
    jfiles, tfiles = shards
    assert [os.path.basename(f) for f in jfiles] == [
        os.path.basename(f) for f in tfiles]
    for jf, tf in zip(jfiles, tfiles):
        with open(jf, "rb") as a, open(tf, "rb") as b:
            assert a.read() == b.read(), tf


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_decode_transform_gives_jax_pixels(shards, decoder):
    table = _payload_table(shards[1])
    got = tim.decode_transform(H, W, decoder=decoder)(table)
    want = jim.decode_transform(H, W)(table)
    assert got.schema.equals(want.schema)
    assert got.schema.field("image").type == pa.list_(pa.uint8(), H * W * 3)
    assert got.equals(want)
    # The pixels are the generator's images, decoded losslessly.
    first = np.asarray(got.column("image")[0].values, np.uint8)
    assert first.reshape(H, W, 3).dtype == np.uint8


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_decode_rejects_a_wrong_shape_as_loudly_as_jax(shards, decoder):
    table = _payload_table(shards[1]).slice(0, 4)
    with pytest.raises(ValueError):
        jim.decode_transform(H + 1, W)(table)
    with pytest.raises(ValueError):
        tim.decode_transform(H + 1, W, decoder=decoder)(table)


def test_resize_of_ragged_sources_equals_jax():
    rng = np.random.default_rng(3)
    payloads = [tim._encode(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                            "png")
                for h, w in [(40, 30), (32, 32), (17, 64), (33, 31)]]
    table = pa.table({"image": pa.array(payloads, type=pa.binary()),
                      "label": np.arange(4, dtype=np.int64)})
    got = tim.decode_transform(H, W, resize=True, decoder="pil")(table)
    want = jim.decode_transform(H, W, resize=True)(table)
    assert got.equals(want)
    with pytest.raises(ValueError, match="native decoder"):
        tim.decode_transform(H, W, resize=True, decoder="native")
    with pytest.raises(ValueError, match="decoder"):
        tim.decode_transform(H, W, decoder="turbo")


def test_native_decoder_raises_on_a_failed_build(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "LIBS", ["-lno_such_codec_library"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.decode_batch([b"x"], H, W)
    assert tnative.missing_prerequisites() == []


def _port_reducers(files, num_reducers, epoch, reduce_transform):
    maps = [tsh.shuffle_map(f, num_reducers, SEED, epoch, i)
            for i, f in enumerate(files)]
    return [tsh.shuffle_reduce(r, SEED, epoch, maps, reduce_transform)
            for r in range(num_reducers)]


@pytest.mark.parametrize("decoder", [None, "native", "pil"])
def test_binary_column_reducers_equal_jax(tmp_path, shards, decoder):
    # Two small files and 8 reducers: several reducers get 0 rows.
    small = []
    for i, f in enumerate(shards[1][:2]):
        path = str(tmp_path / f"small_{i}.parquet")
        pq.write_table(pq.read_table(f).slice(0, 3), path)
        small.append(path)
    for files, num_reducers in [(shards[1], NUM_REDUCERS), (small, 8)]:
        for epoch in range(2):
            port_rt = (None if decoder is None else
                       tim.decode_transform(H, W, decoder=decoder))
            jax_rt = None if decoder is None else jim.decode_transform(H, W)
            got = _port_reducers(files, num_reducers, epoch, port_rt)
            want = [jsh.recompute_reducer_output(files, num_reducers, SEED,
                                                 epoch, r,
                                                 reduce_transform=jax_rt)
                    for r in range(num_reducers)]
            for r, (g, w) in enumerate(zip(got, want)):
                assert g.schema.equals(w.schema), (epoch, r)
                assert g.equals(w), (epoch, r)
            if num_reducers == 8:
                assert any(g.num_rows == 0 for g in got)
                assert sum(g.num_rows for g in got) == 6


def test_large_binary_column_reduces_and_promotion_widens_offsets(tmp_path):
    # Arrow's take overflows 32-bit offsets only past 2 GiB in one
    # reducer output; the promotion it then retries with is checked here.
    path = str(tmp_path / "large.parquet")
    payloads = [bytes([i]) * (i + 1) for i in range(40)]
    pq.write_table(pa.table({
        "image": pa.array(payloads, type=pa.large_binary()),
        "key": np.arange(40, dtype=np.int64)}), path)
    got = _port_reducers([path], 3, 0, None)
    want = [jsh.recompute_reducer_output([path], 3, SEED, 0, r)
            for r in range(3)]
    for g, w in zip(got, want):
        assert g.equals(w)
    table = pa.table({"b": pa.array([b"ab", b""], pa.binary()),
                      "k": pa.array([1, 2], pa.int64())})
    promoted = tsh._promote_large_offsets(table)
    assert promoted.schema.equals(jsh._promote_large_offsets(table).schema)
    assert promoted.schema.field("b").type == pa.large_binary()
    assert promoted.equals(jsh._promote_large_offsets(table))


def _jax_stream(files, skips):
    queue_name = f"torch-port-imagenet-{next(_queue_ids)}"
    spec = jim.imagenet_spec(H, W)
    ds = jjd.JaxShufflingDataset(
        files, NUM_EPOCHS, 1, BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, num_workers=1, queue_name=queue_name,
        device_rebatch=False, **spec)
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch, skip_batches=skips.get(epoch, 0))
        out.append([(np.asarray(f[0]), np.asarray(y)) for f, y in ds])
    return out


def _port_stream(files, skips, decoder):
    ds = DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, device="cpu", **tim.imagenet_spec(H, W, decoder=decoder))
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch, skip_batches=skips.get(epoch, 0))
        out.append([(f[0], y) for f, y in ds])
    return out


@pytest.mark.parametrize("decoder,skips", [("native", {}),
                                           ("pil", {0: 2, 1: 5})])
def test_image_stream_equals_jax(shards, decoder, skips):
    files = shards[1]
    want = _jax_stream(files, skips)
    got = _port_stream(files, skips, decoder)
    assert [len(e) for e in got] == [len(e) for e in want]
    assert len(got[0]) == NUM_IMAGES // BATCH - skips.get(0, 0)
    for epoch_got, epoch_want in zip(got, want):
        for (images, labels), (jimages, jlabels) in zip(epoch_got,
                                                        epoch_want):
            assert images.dtype == torch.uint8
            assert tuple(images.shape) == (BATCH, H, W, 3)
            assert labels.dtype == torch.int32
            assert jimages.dtype == np.uint8 and jlabels.dtype == np.int32
            np.testing.assert_array_equal(images.numpy(), jimages)
            np.testing.assert_array_equal(labels.numpy(), jlabels)
    # The two epochs are shuffled differently.
    assert not np.array_equal(got[0][0][1].numpy(), got[1][0][1].numpy())


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_image_batches_stay_uint8_on_the_device(shards):
    ds = DeviceShufflingDataset(
        shards[1], 1, 1, BATCH, 0, num_reducers=NUM_REDUCERS, seed=SEED,
        **tim.imagenet_spec(H, W, decoder="pil"))
    ds.set_epoch(0)
    host = _port_stream(shards[1], {}, "pil")[0]
    for ((images,), labels), (himages, hlabels) in zip(ds, host):
        assert images.is_cuda and images.dtype == torch.uint8
        assert torch.equal(images.cpu(), himages)
        assert torch.equal(labels.cpu(), hlabels)


def test_package_data_ships_the_decoder_source():
    setup_py = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "setup.py")
    with open(setup_py) as f:
        tree = ast.parse(f.read())
    package_data = next(
        ast.literal_eval(k.value) for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None)
        == "setup" for k in node.keywords if k.arg == "package_data")
    globs = package_data["ray_shuffling_data_loader_tpu_torch.native"]
    rel = os.path.relpath(tnative.SOURCE, tnative.NATIVE_DIR)
    assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
