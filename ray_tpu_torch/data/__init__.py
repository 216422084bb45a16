"""ray_tpu_torch.data: distributed datasets for training ingest on CUDA.

Reference: python/ray/data — lazy logical plans over distributed blocks,
streaming execution, and Train ingest via streaming_split; this is the
port's copy of ray_tpu/data. Its blocks are numpy blocks (``block.py``),
so the path from a dataset to the card needs neither pyarrow nor pandas.
The consumption edge is `iter_torch_batches` / `to_device`: numpy
batches placed on the card as torch tensors through pinned host memory,
optionally cut to this rank's block of a device mesh.
"""
from .block import Block, BlockAccessor, BlockMetadata, Schema
from .dataset import (
    Dataset,
    MaterializedDataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_json,
    read_lance,
    read_mongo,
    read_numpy,
    read_images,
    read_parquet,
    read_sql,
    read_tfrecords,
    read_webdataset,
)
from .datasource import Datasource, ReadTask
from .iterator import DataIterator

__all__ = [
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "DataIterator",
    "Dataset",
    "Datasource",
    "MaterializedDataset",
    "ReadTask",
    "Schema",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_json",
    "read_lance",
    "read_mongo",
    "read_numpy",
    "read_images",
    "read_parquet",
    "read_sql",
    "read_webdataset",
    "read_tfrecords",
]

from ray_tpu_torch._private import usage_stats as _usage

_usage.record_library_usage("data")
