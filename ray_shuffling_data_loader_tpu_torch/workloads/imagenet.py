"""ImageNet-on-Parquet workload: the image decode inside the shuffle's
reducers (BASELINE config 3, "ResNet-50 on ImageNet Parquet shards").

Counterpart of the JAX package's ``workloads/imagenet.py``:

- Parquet rows hold **encoded** image bytes (PNG or JPEG), an int label
  and a unique ``key``. The map, partition and permute stages move the
  small encoded payloads; each reducer decodes its shuffled rows once per
  epoch on the shuffle's thread pool, overlapping training.
- :func:`decode_transform` is a ``shuffle.ReduceTransform`` that replaces
  the encoded column with a ``FixedSizeList<uint8>`` of ``H*W*C`` pixels.
  ``DeviceShufflingDataset`` reshapes it to ``(B, H, W, C)`` and copies it
  to the device as uint8, a quarter of f32's bytes; the train step casts
  it there (``train.make_resnet_micro_step``).
- The decoder is named, never chosen quietly: ``"native"`` is the threaded
  libjpeg/libpng decoder (``native/image.py``), which raises where it
  cannot be built; ``"pil"`` decodes image by image with PIL, and is the
  one that can resize ragged sources (``resize=True``).
- Passing :func:`decode_transform` as ``map_transform`` instead decodes
  once per file read, at the cost of shuffling ``H*W*3`` bytes per row
  rather than the compressed payload.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ray_shuffling_data_loader_tpu_torch import workloads
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

IMAGE_COLUMN = "image"
LABEL_COLUMN = "label"
KEY_COLUMN = "key"
DECODERS = ("native", "pil")


def _synthetic_image(rng: np.random.Generator, height: int, width: int,
                     label: int, num_classes: int) -> np.ndarray:
    """A learnable synthetic image: a class-dependent mean colour plus
    noise."""
    hue = np.array([
        128 + 127 * np.sin(2 * np.pi * label / max(1, num_classes)),
        128 + 127 * np.cos(2 * np.pi * label / max(1, num_classes)),
        255 * label / max(1, num_classes - 1) if num_classes > 1 else 128,
    ])
    noise = rng.integers(-40, 40, size=(height, width, 3))
    return np.clip(hue[None, None, :] + noise, 0, 255).astype(np.uint8)


def _encode(image: np.ndarray, image_format: str) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format=image_format)
    return buf.getvalue()


def generate_file(file_index: int, global_row_index: int, num_rows: int,
                  data_dir: str, height: int, width: int, num_classes: int,
                  seed: int, image_format: str) -> Tuple[str, int]:
    """Write one Parquet shard of encoded images; returns (path, nbytes)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, file_index]))
    labels = rng.integers(0, num_classes, size=num_rows, dtype=np.int64)
    payloads = [
        _encode(_synthetic_image(rng, height, width, int(lbl), num_classes),
                image_format) for lbl in labels]
    table = pa.table({
        IMAGE_COLUMN: pa.array(payloads, type=pa.binary()),
        LABEL_COLUMN: labels,
        KEY_COLUMN: np.arange(global_row_index, global_row_index + num_rows,
                              dtype=np.int64),
    })
    filename = os.path.join(data_dir,
                            f"imagenet_shard_{file_index}.parquet.snappy")
    pq.write_table(table, filename, compression="snappy")
    return filename, table.nbytes


def generate_imagenet_parquet(num_images: int, num_files: int, data_dir: str,
                              height: int = 64, width: int = 64,
                              num_classes: int = 1000, seed: int = 0,
                              image_format: str = "png"
                              ) -> Tuple[List[str], int]:
    """Seeded synthetic ImageNet-style Parquet shards, written in parallel
    (one thread per file, up to the host's cores); returns the paths and
    the total bytes."""
    os.makedirs(data_dir, exist_ok=True)

    def write_file(file_index: int, start: int, n: int) -> Tuple[str, int]:
        return generate_file(file_index, start, n, data_dir, height, width,
                             num_classes, seed, image_format)

    filenames, total_bytes = workloads.generate_shards(
        write_file, num_images, num_files)
    logger.info("generated %d image shards, %d images, %.1f MB",
                len(filenames), num_images, total_bytes / 1e6)
    return filenames, total_bytes


def decode_transform(height: int, width: int, channels: int = 3,
                     image_column: str = IMAGE_COLUMN, resize: bool = False,
                     decoder: str = "native"):
    """``ReduceTransform``: encoded-bytes column -> ``FixedSizeList<uint8>``
    pixels, ``height * width * channels`` per row.

    Without ``resize`` every source must decode to exactly ``(height,
    width, channels)``, or the transform raises (fixed shapes all the way
    to the device). ``resize=True`` (ragged sources) resizes each image
    bilinearly with PIL, so it needs ``decoder="pil"``. ``decoder="native"``
    decodes RGB (``channels=3``) only.
    """
    if decoder not in DECODERS:
        raise ValueError(f"decoder {decoder!r} is not one of {DECODERS}")
    if decoder == "native" and (resize or channels != 3):
        raise ValueError("the native decoder neither resizes nor decodes "
                         "other than 3 channels; pass decoder='pil'")
    expected_shape = (height, width, channels)
    flat_len = height * width * channels

    def decode_pil(payloads) -> np.ndarray:
        from PIL import Image
        out = np.empty((len(payloads), flat_len), dtype=np.uint8)
        for i, payload in enumerate(payloads):
            image = Image.open(io.BytesIO(payload))
            if channels == 3:
                image = image.convert("RGB")
            if resize and image.size != (width, height):
                image = image.resize((width, height), Image.BILINEAR)
            arr = np.asarray(image, dtype=np.uint8)
            if arr.shape != expected_shape:
                raise ValueError(
                    f"decoded image shape {arr.shape} != expected "
                    f"{expected_shape}; resize at generation time or pass "
                    "resize=True: the pipeline needs fixed shapes")
            out[i] = arr.reshape(-1)
        return out

    def transform(table: pa.Table) -> pa.Table:
        payloads = table.column(image_column).to_pylist()
        if decoder == "native":
            from ray_shuffling_data_loader_tpu_torch.native import image
            out = image.decode_batch(payloads, height, width)
        else:
            out = decode_pil(payloads)
        decoded = pa.FixedSizeListArray.from_arrays(
            pa.array(out.reshape(-1)), flat_len)
        index = table.schema.get_field_index(image_column)
        return table.set_column(index, image_column, decoded)

    return transform


def imagenet_spec(height: int, width: int, channels: int = 3,
                  resize: bool = False, decoder: str = "native"
                  ) -> Dict[str, Any]:
    """``DeviceShufflingDataset`` kwargs for the decoded-image layout:
    uint8 ``(B, H, W, C)`` images and int32 labels, decoded in the
    reducers."""
    return {
        "feature_columns": [IMAGE_COLUMN],
        "feature_shapes": [(height, width, channels)],
        "feature_types": [np.uint8],
        "label_column": LABEL_COLUMN,
        "label_type": np.int32,
        "reduce_transform": decode_transform(height, width, channels,
                                             resize=resize, decoder=decoder),
    }
