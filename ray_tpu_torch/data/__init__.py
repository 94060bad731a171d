"""ray_tpu_torch.data — lazy distributed datasets on object-store blocks.

Reference: python/ray/data/ (§2.3 of SURVEY.md). Pure library on the public
task/actor/object API, like every ML library here.
"""

from ray_tpu_torch.data.aggregate import (
    AbsMax,
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset
from ray_tpu_torch.data.datasource import Datasource
from ray_tpu_torch.data.grouped_data import GroupedData
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
)

__all__ = [
    "AbsMax",
    "AggregateFn",
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "Count",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "MaterializedDataset",
    "Max",
    "Mean",
    "Min",
    "Std",
    "Sum",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
    "read_tfrecords",
]
