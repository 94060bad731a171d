"""Dataset creation API.

Reference: python/ray/data/read_api.py — `ray.data.range/from_items/
from_numpy/from_pandas/from_arrow/read_parquet/read_csv/read_json/
read_images/read_text/read_binary_files`. Reads are lazy (one ReadTask per
file/fragment); from_* put blocks into the object store eagerly.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data._internal.logical_plan import InputData, LogicalPlan, Read
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset, _dataset_from_bundles
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TextDatasource,
    _expand_paths,
)

DEFAULT_PARALLELISM = 16


def read_datasource(
    datasource: Datasource, *, parallelism: int = DEFAULT_PARALLELISM, **_
) -> Dataset:
    tasks = datasource.get_read_tasks(parallelism)
    input_files = getattr(datasource, "_paths", [])
    return Dataset(
        LogicalPlan([Read(read_tasks=tasks, input_files=list(input_files))])
    )


def range(n: int, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def range_tensor(
    n: int, *, shape: tuple = (1,), parallelism: int = DEFAULT_PARALLELISM
) -> Dataset:
    return read_datasource(
        RangeDatasource(n, tensor_shape=tuple(shape)), parallelism=parallelism
    )


def read_csv(paths, *, parallelism: int = DEFAULT_PARALLELISM, **kw) -> Dataset:
    return read_datasource(CSVDatasource(paths, **kw), parallelism=parallelism)


def read_parquet(
    paths, *, columns: Optional[list] = None, parallelism: int = DEFAULT_PARALLELISM
) -> Dataset:
    return read_datasource(
        ParquetDatasource(paths, columns=columns), parallelism=parallelism
    )


def read_json(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(JSONDatasource(paths), parallelism=parallelism)


def read_text(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(TextDatasource(paths), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(NumpyDatasource(paths), parallelism=parallelism)


def read_binary_files(
    paths, *, parallelism: int = DEFAULT_PARALLELISM
) -> Dataset:
    return read_datasource(BinaryDatasource(paths), parallelism=parallelism)


def read_tfrecords(
    paths,
    *,
    batch_rows: int = 1024,
    verify_crc: bool = True,
    parallelism: int = DEFAULT_PARALLELISM,
) -> Dataset:
    """tf.train.Example TFRecord files → column blocks (reference
    data/datasource/tfrecords_datasource.py — but TF-free: the record
    framing and Example wire format are decoded natively,
    ray_tpu/data/tfrecords.py)."""
    from ray_tpu_torch.data.datasource import Datasource, _expand_paths

    class TFRecordsDatasource(Datasource):
        def __init__(self, paths):
            self._paths = _expand_paths(paths)

        def get_read_tasks(self, parallelism: int):
            def make(path):
                def read():
                    from ray_tpu_torch.data.tfrecords import (
                        decode_example,
                        examples_to_columns,
                        read_records,
                    )

                    pending = []
                    for payload in read_records(path, verify=verify_crc):
                        pending.append(decode_example(payload))
                        if len(pending) >= batch_rows:
                            yield examples_to_columns(pending)
                            pending = []
                    if pending:
                        yield examples_to_columns(pending)

                return read

            return [make(p) for p in self._paths]

    return read_datasource(TFRecordsDatasource(paths), parallelism=parallelism)


def read_images(
    paths,
    *,
    size: Optional[tuple] = None,
    mode: str = "RGB",
    parallelism: int = DEFAULT_PARALLELISM,
) -> Dataset:
    """Decode images into {'image': uint8 HWC} blocks (reference
    data/datasource/image_datasource.py)."""

    class ImageDatasource(Datasource):
        def __init__(self, paths):
            self._paths = _expand_paths(paths)

        def get_read_tasks(self, parallelism: int):
            def make(path):
                def read():
                    from PIL import Image

                    img = Image.open(path).convert(mode)
                    if size is not None:
                        img = img.resize(size)
                    yield {
                        "image": np.asarray(img)[None, ...],
                        "path": np.asarray([path]),
                    }

                return read

            return [make(p) for p in self._paths]

    return read_datasource(ImageDatasource(paths), parallelism=parallelism)


# -- eager from_* -------------------------------------------------------------


def from_items(items: List[Any], *, parallelism: int = 4) -> MaterializedDataset:
    import builtins

    items = list(items)
    parallelism = max(1, min(parallelism, len(items) or 1))
    bundles = []
    for i in builtins.range(parallelism):
        start = (len(items) * i) // parallelism
        end = (len(items) * (i + 1)) // parallelism
        block = items[start:end]
        bundles.append(
            (ray_tpu_torch.put(block), BlockAccessor.for_block(block).metadata())
        )
    return _dataset_from_bundles(bundles)


def from_numpy(arr, column: str = "data") -> MaterializedDataset:
    if isinstance(arr, list):
        bundles = []
        for a in arr:
            block = {column: np.asarray(a)}
            bundles.append(
                (ray_tpu_torch.put(block), BlockAccessor.for_block(block).metadata())
            )
        return _dataset_from_bundles(bundles)
    block = {column: np.asarray(arr)}
    return _dataset_from_bundles(
        [(ray_tpu_torch.put(block), BlockAccessor.for_block(block).metadata())]
    )


def from_arrow(tables) -> MaterializedDataset:
    if not isinstance(tables, list):
        tables = [tables]
    bundles = [
        (ray_tpu_torch.put(t), BlockAccessor.for_block(t).metadata()) for t in tables
    ]
    return _dataset_from_bundles(bundles)


def from_pandas(dfs) -> MaterializedDataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    bundles = [
        (ray_tpu_torch.put(df), BlockAccessor.for_block(df).metadata()) for df in dfs
    ]
    return _dataset_from_bundles(bundles)


def from_huggingface(hf_dataset) -> MaterializedDataset:
    """Convert a `datasets.Dataset` (Arrow-backed) without row copies."""
    table = hf_dataset.data.table
    return from_arrow(table)
