"""Dataset: lazy, distributed data over blocks in the object store.

Reference: python/ray/data/dataset.py — a ``Dataset`` wraps a logical
plan; transforms append operators; execution is streaming
(`_executor.StreamingExecutor`) and only happens on consumption
(iter/take/count/write/materialize), as in the reference's lazy
execution model.

The port's copy of ray_tpu/data/dataset.py, over numpy blocks
(``block.py``). ``iter_torch_batches`` takes the place of the
reference's ``iter_jax_batches``; sort, groupby and shuffle run on numpy
columns, and column selection, dropping and renaming on numpy batches, so
none of them needs pyarrow.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from .block import Block, BlockAccessor, Schema, VALUE_COL, _require, build_block
from .datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TFRecordsDatasource,
    ImageDatasource,
    SQLDatasource,
    WebDatasetDatasource,
)
from ._executor import Bundle, StreamingExecutor

# The module exposes a `range` factory (mirroring ray.data.range), which
# shadows the builtin at module scope — keep a handle to the builtin.
_py_range = range
from ._plan import AllToAll, InputData, Limit, LogicalPlan, MapLike, Read, optimize


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan

    # ------------------------------------------------------- transforms

    def _append(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._append(MapLike("map_rows", {"fn": fn}))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        fn_kwargs: Optional[Dict[str, Any]] = None,
        concurrency: Optional[int] = None,
        **_ignored,
    ) -> "Dataset":
        return self._append(
            MapLike(
                "map_batches",
                {
                    "fn": fn,
                    "batch_size": batch_size,
                    "batch_format": batch_format,
                    "fn_kwargs": fn_kwargs,
                },
            )
        )

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return self._append(MapLike("filter", {"fn": fn}))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return self._append(MapLike("flat_map", {"fn": fn}))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch: Dict[str, np.ndarray], _name=name, _fn=fn):
            batch[_name] = _fn(batch)
            return batch

        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch: Dict[str, np.ndarray], _cols=tuple(cols)):
            missing = [c for c in _cols if c not in batch]
            if missing:
                raise KeyError(f"drop_columns: no columns {missing}")
            return {k: v for k, v in batch.items() if k not in _cols}

        return self.map_batches(drop)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch: Dict[str, np.ndarray], _cols=tuple(cols)):
            return {c: batch[c] for c in _cols}

        # The projection tag lets ColumnPruningPushdown move this into a
        # pruning-capable source read (parquet/lance/mongo).
        return self._append(
            MapLike(
                "map_batches",
                {
                    "fn": select,
                    "batch_size": None,
                    "batch_format": "numpy",
                    "fn_kwargs": None,
                    "projection": tuple(cols),
                },
            )
        )

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(batch: Dict[str, np.ndarray], _m=dict(mapping)):
            return {_m.get(c, c): v for c, v in batch.items()}

        return self.map_batches(rename)

    def limit(self, n: int) -> "Dataset":
        return self._append(Limit(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(AllToAll("repartition", {"num_blocks": num_blocks}))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._append(AllToAll("random_shuffle", {"seed": seed}))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._append(AllToAll("sort", {"key": key, "descending": descending}))

    def union(self, *others: "Dataset") -> "Dataset":
        other_bundles = [list(o._execute()) for o in others]
        return self._append(AllToAll("union", {"others": other_bundles}))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._append(AllToAll("zip", {"other": list(other._execute())}))

    def groupby(self, key: str):
        from .grouped import GroupedData

        return GroupedData(self, key)

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        def sample(batch: Dict[str, np.ndarray], _task_index=0, _f=fraction,
                   _seed=seed):
            n = len(next(iter(batch.values()))) if batch else 0
            # Salt by task index so each block draws independently.
            rng = np.random.RandomState(
                None if _seed is None else _seed + _task_index
            )
            mask = rng.random_sample(n) < _f
            return {k: v[mask] for k, v in batch.items()}

        return self._append(
            MapLike(
                "map_batches",
                {"fn": sample, "batch_size": None, "batch_format": "numpy",
                 "fn_kwargs": None, "pass_task_index": True},
            )
        )

    # ------------------------------------------------------ consumption

    def _execute(self) -> Iterator[Bundle]:
        # Executor per execution: construction probes cluster resources,
        # which must not happen on (lazy) transform chaining.
        return StreamingExecutor().execute(optimize(self._plan))

    def iter_internal_ref_bundles(self) -> Iterator[Bundle]:
        return self._execute()

    def materialize(self) -> "MaterializedDataset":
        return MaterializedDataset(list(self._execute()))

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block_ref, _ in self._execute():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(block_ref)).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     prefetch_batches: int = 1):
        from .iterator import iter_batches_over_bundles

        return iter_batches_over_bundles(
            self._execute(), batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last, prefetch_blocks=max(1, prefetch_batches),
        )

    def iter_torch_batches(self, *, batch_size: int = 256, drop_last: bool = True,
                           device=None, dtypes=None, sharding=None):
        """Numpy batches as torch tensors on `device` (the reference's
        iter_jax_batches; upstream's iter_torch_batches,
        data/iterator.py:261). See `iterator.to_device`."""
        from .iterator import to_device

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            yield to_device(batch, device=device, dtypes=dtypes,
                            sharding=sharding)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def take_batch(self, n: int = 20, *, batch_format: str = "numpy"):
        block = build_block(self.take(n))
        return BlockAccessor.for_block(block).to_batch(batch_format)

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        return sum(meta.num_rows for _, meta in self._execute())

    def sum(self, column: str) -> Any:
        total = 0
        for batch in self.iter_batches(batch_size=None, batch_format="numpy"):
            if column in batch and len(batch[column]):
                total += batch[column].sum()
        return total

    def min(self, column: str) -> Any:
        vals = [b[column].min() for b in
                self.iter_batches(batch_size=None, batch_format="numpy")
                if len(b.get(column, ()))]
        return min(vals) if vals else None

    def max(self, column: str) -> Any:
        vals = [b[column].max() for b in
                self.iter_batches(batch_size=None, batch_format="numpy")
                if len(b.get(column, ()))]
        return max(vals) if vals else None

    def mean(self, column: str) -> Any:
        total, count = 0.0, 0
        for b in self.iter_batches(batch_size=None, batch_format="numpy"):
            if column in b and len(b[column]):
                total += float(b[column].sum())
                count += len(b[column])
        return total / count if count else None

    def unique(self, column: str) -> List[Any]:
        seen: Dict[Any, None] = {}
        for row in self.iter_rows():
            seen.setdefault(row[column])
        return list(seen)

    def schema(self) -> Optional[Schema]:
        for block_ref, meta in self._execute():
            if meta.schema is not None and len(meta.schema.names):
                return meta.schema
            block = ray_tpu_torch.get(block_ref)
            return BlockAccessor.for_block(block).schema()
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return s.names if s else []

    def num_blocks(self) -> int:
        return sum(1 for _ in self._execute())

    def size_bytes(self) -> int:
        return sum(meta.size_bytes for _, meta in self._execute())

    def stats(self) -> str:
        bundles = list(self._execute())
        rows = sum(m.num_rows for _, m in bundles)
        size = sum(m.size_bytes for _, m in bundles)
        return (f"Dataset stats: {len(bundles)} blocks, {rows} rows, "
                f"{size} bytes")

    # ----------------------------------------------------------- splits

    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        ds = self.repartition(n) if equal else self
        bundles = list(ds._execute())
        if equal and len(bundles) != n:
            raise RuntimeError("repartition failed to produce n blocks")
        out: List[List[Bundle]] = [[] for _ in _py_range(n)]
        for i, b in enumerate(bundles):
            out[i % n].append(b)
        return [MaterializedDataset(bs) for bs in out]

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> List["DataIteratorHandle"]:
        from .stream_split import make_streaming_splits

        return make_streaming_splits(self, n, equal=equal)

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        rows = ds.take_all()
        k = int(len(rows) * (1 - test_size))
        return from_items(rows[:k]), from_items(rows[k:])

    # ----------------------------------------------------------- writes

    def _write(self, path_template: str, fmt: str, **kw) -> List[str]:
        ds = self._append(
            MapLike("write", {"path_template": path_template, "fmt": fmt, "kw": kw})
        )
        return [r["path"] for r in ds.take_all()]

    def write_parquet(self, path: str, **kw) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        return self._write(os.path.join(path, "part-{i:05d}.parquet"), "parquet", **kw)

    def write_csv(self, path: str, **kw) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        return self._write(os.path.join(path, "part-{i:05d}.csv"), "csv", **kw)

    def write_json(self, path: str, **kw) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        return self._write(os.path.join(path, "part-{i:05d}.json"), "json", **kw)

    def write_numpy(self, path: str, **kw) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        return self._write(os.path.join(path, "part-{i:05d}.npy"), "numpy", **kw)

    def write_tfrecords(self, path: str, **kw) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        return self._write(
            os.path.join(path, "part-{i:05d}.tfrecords"), "tfrecords", **kw
        )

    # --------------------------------------------------------- converts

    def to_pandas(self):
        pd = _require("pandas", "to_pandas")

        frames = [BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_pandas()
                  for ref, _ in self._execute()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow_refs(self) -> List[Any]:
        """Refs of the dataset's blocks, which in the port are numpy blocks,
        not arrow tables (``BlockAccessor.for_block(...).to_arrow()``
        converts one)."""
        return [ref for ref, _ in self._execute()]

    def __repr__(self):
        names = [op.name for op in self._plan.ops]
        return f"Dataset(plan={' -> '.join(names)})"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already in the object store
    (reference: MaterializedDataset)."""

    def __init__(self, bundles: List[Bundle]):
        super().__init__(LogicalPlan([InputData(bundles)]))
        self._bundles = bundles

    def num_blocks(self) -> int:
        return len(self._bundles)


# ------------------------------------------------------------ factories

def read_datasource(datasource: Datasource, *, parallelism: int = -1,
                    override_num_blocks: Optional[int] = None) -> Dataset:
    p = override_num_blocks or parallelism
    return Dataset(LogicalPlan([Read(datasource, p)]))


def range(n: int, *, parallelism: int = -1,
          override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    return read_datasource(RangeDatasource(n), parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1,
                 override_num_blocks: Optional[int] = None) -> Dataset:
    return read_datasource(RangeDatasource(n, tensor_shape=shape),
                           parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def _bundles_from_blocks(blocks: List[Block]) -> List[Bundle]:
    out = []
    for b in blocks:
        acc = BlockAccessor.for_block(b)
        out.append((ray_tpu_torch.put(acc.to_numpy_batch()), acc.metadata()))
    return out


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return MaterializedDataset(_bundles_from_blocks(dfs))


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return MaterializedDataset(_bundles_from_blocks(tables))


def from_numpy(arrays) -> Dataset:
    if not isinstance(arrays, list):
        arrays = [arrays]
    return MaterializedDataset(_bundles_from_blocks(
        [build_block({VALUE_COL: a}) for a in arrays]
    ))


def read_parquet(paths, *, columns=None, parallelism: int = -1,
                 override_num_blocks=None, **kw) -> Dataset:
    return read_datasource(ParquetDatasource(paths, columns=columns, **kw),
                           parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def read_csv(paths, *, parallelism: int = -1, override_num_blocks=None,
             **kw) -> Dataset:
    return read_datasource(CSVDatasource(paths, **kw), parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def read_json(paths, *, parallelism: int = -1, override_num_blocks=None,
              **kw) -> Dataset:
    return read_datasource(JSONDatasource(paths, **kw), parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def read_binary_files(paths, *, parallelism: int = -1,
                      override_num_blocks=None, **kw) -> Dataset:
    return read_datasource(BinaryDatasource(paths, **kw),
                           parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def read_numpy(paths, *, parallelism: int = -1, override_num_blocks=None,
               **kw) -> Dataset:
    return read_datasource(NumpyDatasource(paths, **kw),
                           parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def read_tfrecords(paths, *, parallelism: int = -1, override_num_blocks=None,
                   **kw) -> Dataset:
    return read_datasource(TFRecordsDatasource(paths, **kw),
                           parallelism=parallelism,
                           override_num_blocks=override_num_blocks)


def read_images(paths, *, size=None, mode=None, parallelism: int = -1,
                override_num_blocks=None, **kw) -> Dataset:
    """Decoded images ({"image", "path"} rows; reference:
    read_api.py read_images)."""
    return read_datasource(
        ImageDatasource(paths, size=size, mode=mode, **kw),
        parallelism=parallelism, override_num_blocks=override_num_blocks,
    )


def read_lance(uri: str, *, columns=None, version=None,
               parallelism: int = -1, override_num_blocks=None) -> Dataset:
    """Fragment-parallel scan of a lance-style versioned columnar
    dataset (reference: read_api.py read_lance); ``version=`` time
    travels to an earlier committed snapshot."""
    from .datasource import LanceDatasource

    return read_datasource(
        LanceDatasource(uri, columns=columns, version=version),
        parallelism=parallelism, override_num_blocks=override_num_blocks,
    )


def read_mongo(collection_factory, *, filter=None, projection=None,
               parallelism: int = -1, override_num_blocks=None) -> Dataset:
    """_id-range-partitioned reads from a MongoDB-shaped collection
    (reference: read_api.py read_mongo)."""
    from .datasource import MongoDatasource

    return read_datasource(
        MongoDatasource(collection_factory, filter=filter,
                        projection=projection),
        parallelism=parallelism, override_num_blocks=override_num_blocks,
    )


def read_sql(sql: str, connection_factory, *, shard_rows: int = 0,
             parallelism: int = -1, override_num_blocks=None) -> Dataset:
    """Rows from any DB-API connection (reference: read_api.py
    read_sql). ``shard_rows`` > 0 shards via LIMIT/OFFSET."""
    return read_datasource(
        SQLDatasource(sql, connection_factory, shard_rows=shard_rows),
        parallelism=parallelism, override_num_blocks=override_num_blocks,
    )


def read_webdataset(paths, *, parallelism: int = -1,
                    override_num_blocks=None, **kw) -> Dataset:
    """WebDataset tar shards as {"__key__", <ext>: bytes} samples
    (reference: read_api.py read_webdataset)."""
    return read_datasource(
        WebDatasetDatasource(paths, **kw),
        parallelism=parallelism, override_num_blocks=override_num_blocks,
    )
