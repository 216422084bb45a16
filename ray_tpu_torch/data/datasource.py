"""Datasources: pluggable readers producing parallel ReadTasks.

Reference: python/ray/data/datasource/datasource.py (``Datasource``,
``ReadTask``) and the per-format sources under data/_internal/datasource/
(parquet, csv, json, range, binary…). A ReadTask is a zero-arg callable
returning an iterator of blocks plus advance metadata; the Read logical
operator schedules them as remote tasks.

The port's copy of ray_tpu/data/datasource.py. Its blocks are numpy
blocks (``block.py``): numpy, binary, tfrecords, images, webdataset, sql,
mongo and the in-memory sources need neither pyarrow nor pandas; parquet,
csv, json and lance import pyarrow where they read or write, and raise an
``ImportError`` naming it where it is absent.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from .block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    VALUE_COL,
    _object_array,
    _require,
    build_block,
)


class ReadTask:
    def __init__(self, read_fn: Callable[[], Iterable[Block]],
                 metadata: BlockMetadata):
        self._read_fn = read_fn
        self.metadata = metadata  # estimate; real stats come post-read

    def __call__(self) -> Iterable[Block]:
        return self._read_fn()


class Datasource:
    """Subclass and implement get_read_tasks (reference: Datasource)."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Datasource", "")


class RangeDatasource(Datasource):
    """ray_tpu_torch.data.range — deterministic integer range (reference:
    data/_internal/datasource/range_datasource.py)."""

    def __init__(self, n: int, use_tensor: bool = False, tensor_shape=None):
        self._n = n
        self._tensor_shape = tensor_shape

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self._n or 1))
        tasks = []
        per = self._n // parallelism
        rem = self._n % parallelism
        start = 0
        shape = self._tensor_shape
        for i in range(parallelism):
            cnt = per + (1 if i < rem else 0)
            lo, hi = start, start + cnt
            start = hi

            def read(lo=lo, hi=hi) -> Iterable[Block]:
                arr = np.arange(lo, hi)
                if shape:
                    data = np.broadcast_to(
                        arr.reshape((-1,) + (1,) * len(shape)),
                        (hi - lo,) + tuple(shape),
                    ).copy()
                    yield build_block({VALUE_COL: data})
                else:
                    yield {"id": arr}

            meta = BlockMetadata(num_rows=cnt, size_bytes=cnt * 8)
            tasks.append(ReadTask(read, meta))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self._items = items

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self._items)
        parallelism = max(1, min(parallelism, n or 1))
        tasks = []
        per, rem, start = n // parallelism, n % parallelism, 0
        for i in range(parallelism):
            cnt = per + (1 if i < rem else 0)
            chunk = self._items[start:start + cnt]
            start += cnt

            def read(chunk=chunk) -> Iterable[Block]:
                yield build_block(chunk)

            tasks.append(ReadTask(read, BlockMetadata(num_rows=cnt, size_bytes=0)))
        return tasks


class _FileDatasource(Datasource):
    """Shared path-expansion + per-file read tasks for file formats
    (reference: file_based_datasource.py)."""

    def __init__(self, paths, file_extensions: Optional[List[str]] = None,
                 **read_kwargs):
        if isinstance(paths, str):
            paths = [paths]
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                for f in sorted(glob.glob(os.path.join(p, "**", "*"),
                                          recursive=True)):
                    if os.path.isfile(f):
                        files.append(f)
            elif any(ch in p for ch in "*?["):
                files.extend(sorted(glob.glob(p)))
            else:
                files.append(p)
        if file_extensions:
            exts = tuple(e.lower() for e in file_extensions)
            files = [f for f in files if f.lower().endswith(exts)]
        if not files:
            raise ValueError(f"No input files found for {paths}")
        self._files = files
        self._read_kwargs = read_kwargs

    def _read_file(self, path: str) -> Iterator[Block]:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        # one task per file group; group to reach ~parallelism tasks
        n = len(self._files)
        groups: List[List[str]] = []
        parallelism = max(1, min(parallelism, n))
        per, rem, start = n // parallelism, n % parallelism, 0
        for i in range(parallelism):
            cnt = per + (1 if i < rem else 0)
            groups.append(self._files[start:start + cnt])
            start += cnt
        tasks = []
        for grp in groups:
            def read(grp=grp) -> Iterable[Block]:
                for path in grp:
                    yield from self._read_file(path)

            size = sum(os.path.getsize(f) for f in grp)
            tasks.append(ReadTask(
                read,
                BlockMetadata(num_rows=0, size_bytes=size, input_files=grp),
            ))
        return tasks

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return sum(os.path.getsize(f) for f in self._files)


class ParquetDatasource(_FileDatasource):
    def __init__(self, paths, columns: Optional[List[str]] = None, **kw):
        super().__init__(paths, file_extensions=[".parquet"], **kw)
        self._columns = columns

    def prune_columns(self, cols: List[str]) -> bool:
        """Accept a projection pushed down by the ColumnPruningPushdown
        rule: parquet reads only the requested column chunks."""
        if self._columns is not None and not set(cols) <= set(self._columns):
            return False  # would widen the user's explicit projection
        self._columns = list(cols)
        return True

    def _read_file(self, path: str) -> Iterator[Block]:
        pq = _require("pyarrow.parquet", "read_parquet")
        yield build_block(pq.read_table(path, columns=self._columns))


class CSVDatasource(_FileDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        pa_csv = _require("pyarrow.csv", "read_csv")
        yield build_block(pa_csv.read_csv(path, **self._read_kwargs))


class JSONDatasource(_FileDatasource):
    """Newline-delimited JSON (reference: json_datasource.py)."""

    def _read_file(self, path: str) -> Iterator[Block]:
        pa_json = _require("pyarrow.json", "read_json")
        yield build_block(pa_json.read_json(path, **self._read_kwargs))


class BinaryDatasource(_FileDatasource):
    """Whole files as bytes rows with their paths (reference:
    binary_datasource.py)."""

    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path, "rb") as f:
            data = f.read()
        yield {"bytes": _object_array([data]), "path": _object_array([path])}


class NumpyDatasource(_FileDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        arr = np.load(path)
        yield build_block({VALUE_COL: arr})


class TFRecordsDatasource(_FileDatasource):
    """Uncompressed TFRecord files of tf.train.Example records, parsed
    without a tensorflow dependency (reference: tfrecords_datasource.py)."""

    def _read_file(self, path: str) -> Iterator[Block]:
        from . import _tfrecord

        rows = list(_tfrecord.read_examples(path))
        cols: Dict[str, list] = {}
        for row in rows:
            for k, v in row.items():
                cols.setdefault(k, []).append(v)
        yield build_block(cols)


class ImageDatasource(_FileDatasource):
    """Decoded images as fixed-shape arrays with their paths
    (reference: image_datasource.py). Rows: {"image": HxWxC uint8,
    "path": str}; ``size=(h, w)`` resizes at read time, ``mode``
    converts (e.g. "RGB", "L")."""

    _EXTS = [".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"]

    def __init__(self, paths, size=None, mode: Optional[str] = None, **kw):
        super().__init__(paths, file_extensions=self._EXTS, **kw)
        self._size = size
        self._mode = mode

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        # One file per task: differently-sized images produce
        # fixed-shape tensor columns that cannot concatenate within a
        # grouped task (pass ``size=`` to normalize shapes).
        return super().get_read_tasks(len(self._files))

    def _read_file(self, path: str) -> Iterator[Block]:
        from PIL import Image

        with Image.open(path) as im:
            if self._mode:
                im = im.convert(self._mode)
            if self._size:
                im = im.resize((self._size[1], self._size[0]))
            arr = np.asarray(im)
        yield {"image": arr[None], "path": _object_array([path])}


class SQLDatasource(Datasource):
    """Rows from any DB-API 2.0 connection (reference:
    sql_datasource.py: read_sql(sql, connection_factory)). Parallelism
    comes from sharding the query by row number when the dialect
    supports LIMIT/OFFSET; otherwise one task."""

    def __init__(self, sql: str, connection_factory, shard_rows: int = 0):
        self._sql = sql
        self._factory = connection_factory
        self._shard_rows = shard_rows

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, sql = self._factory, self._sql
        page = self._shard_rows
        n_shards = parallelism if (page and parallelism > 1) else 1

        def make(shard_index: int):
            def read() -> Iterable[Block]:
                conn = factory()
                try:
                    cur = conn.cursor()
                    if not page:
                        cur.execute(sql)
                        names = [d[0] for d in cur.description]
                        rows = cur.fetchall()
                        yield build_block(
                            {n: [r[i] for r in rows]
                             for i, n in enumerate(names)}
                        )
                        return
                    # Strided paging: shard i reads pages i, i+n, i+2n,
                    # ... until a page comes back short — table size
                    # never caps coverage.
                    offset = shard_index * page
                    while True:
                        cur.execute(f"{sql} LIMIT {page} OFFSET {offset}")
                        names = [d[0] for d in cur.description]
                        rows = cur.fetchall()
                        if rows:
                            yield build_block(
                                {n: [r[i] for r in rows]
                                 for i, n in enumerate(names)}
                            )
                        if len(rows) < page:
                            return
                        offset += n_shards * page
                finally:
                    conn.close()

            return read

        return [
            ReadTask(make(i), BlockMetadata(num_rows=0, size_bytes=0))
            for i in range(n_shards)
        ]


class WebDatasetDatasource(_FileDatasource):
    """WebDataset-style tar shards: files grouped by basename stem into
    samples, keyed by extension (reference: webdataset_datasource.py).
    A shard member ``0001.jpg`` + ``0001.cls`` becomes one row
    {"__key__": "0001", "jpg": <bytes>, "cls": <bytes>}; decoding
    stays in user map() calls, as in the reference's default."""

    def __init__(self, paths, **kw):
        super().__init__(paths, file_extensions=[".tar"], **kw)

    def _read_file(self, path: str) -> Iterator[Block]:
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                stem, _, ext = name.partition(".")
                data = tf.extractfile(member).read()
                if stem not in samples:
                    samples[stem] = {"__key__": stem}
                    order.append(stem)
                samples[stem][ext] = data
        all_keys: List[str] = ["__key__"]
        for s in samples.values():
            for k in s:
                if k not in all_keys:
                    all_keys.append(k)
        rows = [
            {k: samples[stem].get(k) for k in all_keys} for stem in order
        ]
        if rows:
            yield build_block(rows)


class LanceDatasource(Datasource):
    """Lance-style versioned columnar dataset (reference:
    data/_internal/datasource/lance_datasource.py — fragment-parallel
    scans with column projection and version time travel). The `lance`
    wheel is unavailable offline, so this reads the same *shape* of
    format natively: a dataset directory holds immutable fragment files
    with ONE file per column per fragment plus versioned JSON manifests
    (`_versions/<n>.manifest.json`). Column pruning therefore skips
    whole files on disk, appends commit a new manifest version, and
    `version=` reads any historical snapshot.

    Fixtures come from :func:`write_lance_dataset` below.
    """

    def __init__(self, uri: str, columns: Optional[List[str]] = None,
                 version: Optional[int] = None):
        import json

        vdir = os.path.join(uri, "_versions")
        if not os.path.isdir(vdir):
            raise ValueError(f"Not a lance-style dataset: {uri}")
        versions = sorted(
            int(f.split(".")[0]) for f in os.listdir(vdir)
            if f.endswith(".manifest.json")
        )
        if not versions:
            raise ValueError(f"No manifest versions in {uri}")
        self.version = versions[-1] if version is None else version
        if self.version not in versions:
            raise ValueError(
                f"version {version} not in {versions} for {uri}"
            )
        with open(os.path.join(
            vdir, f"{self.version}.manifest.json"
        )) as f:
            self._manifest = json.load(f)
        self._uri = uri
        self._columns = columns
        schema_cols = list(self._manifest["schema"])
        want = schema_cols if columns is None else columns
        missing = [c for c in want if c not in schema_cols]
        if missing:
            raise ValueError(f"unknown columns {missing}; have {schema_cols}")

    def prune_columns(self, cols: List[str]) -> bool:
        if self._columns is not None and not set(cols) <= set(self._columns):
            return False
        self._columns = list(cols)
        return True

    def estimate_inmemory_data_size(self) -> Optional[int]:
        cols = self._columns or list(self._manifest["schema"])
        return sum(
            os.path.getsize(os.path.join(self._uri, frag["files"][c]))
            for frag in self._manifest["fragments"]
            for c in cols
        )

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        pq = _require("pyarrow.parquet", "read_lance")
        uri = self._uri
        cols = self._columns or list(self._manifest["schema"])
        tasks = []
        for frag in self._manifest["fragments"]:
            files = {c: frag["files"][c] for c in cols}

            def read(files=files) -> Iterable[Block]:
                # One file per column: projection never touches the
                # bytes of unselected columns.
                yield {
                    c: build_block(pq.read_table(os.path.join(uri, f)))[c]
                    for c, f in files.items()
                }

            size = sum(
                os.path.getsize(os.path.join(uri, f))
                for f in files.values()
            )
            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=frag["num_rows"], size_bytes=size,
                input_files=sorted(files.values()),
            )))
        return tasks


def write_lance_dataset(uri: str, table, *,
                        max_rows_per_fragment: int = 1 << 20) -> int:
    """Write/append an arrow table (or column dict) as a new version of
    a lance-style dataset; returns the committed version number. An
    append keeps every existing fragment immutable and commits a new
    manifest listing old + new fragments — historical versions stay
    readable (``LanceDatasource(uri, version=n)``)."""
    import json

    pa = _require("pyarrow", "write_lance_dataset")
    pq = _require("pyarrow.parquet", "write_lance_dataset")
    if isinstance(table, dict):
        table = pa.table(table)
    vdir = os.path.join(uri, "_versions")
    ddir = os.path.join(uri, "data")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(ddir, exist_ok=True)
    versions = sorted(
        int(f.split(".")[0]) for f in os.listdir(vdir)
        if f.endswith(".manifest.json")
    )
    if versions:
        with open(os.path.join(
            vdir, f"{versions[-1]}.manifest.json"
        )) as f:
            prev = json.load(f)
        new_schema = {
            c: str(table.schema.field(c).type) for c in table.column_names
        }
        if prev["schema"] != new_schema:
            raise ValueError(
                f"append schema {new_schema} != {prev['schema']}"
            )
        fragments = list(prev["fragments"])
    else:
        fragments = []
    next_frag = max((f["id"] for f in fragments), default=-1) + 1
    for start in range(0, max(table.num_rows, 1), max_rows_per_fragment):
        piece = table.slice(start, max_rows_per_fragment)
        files = {}
        for c in table.column_names:
            rel = os.path.join("data", f"frag-{next_frag}-{c}.parquet")
            pq.write_table(
                pa.table({c: piece.column(c)}),
                os.path.join(uri, rel),
            )
            files[c] = rel
        fragments.append({
            "id": next_frag, "num_rows": piece.num_rows, "files": files,
        })
        next_frag += 1
    version = (versions[-1] + 1) if versions else 1
    manifest = {
        "version": version,
        "schema": {
            c: str(table.schema.field(c).type) for c in table.column_names
        },
        "fragments": fragments,
    }
    tmp = os.path.join(vdir, f".{version}.manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(vdir, f"{version}.manifest.json"))
    return version


class MongoDatasource(Datasource):
    """Cursor-paged reads from a MongoDB-shaped collection (reference:
    data/_internal/datasource/mongo_datasource.py — partitions a
    collection into _id ranges and reads each range in its own task).
    Takes a ``collection_factory`` (a pymongo ``Collection`` or any
    object with ``count_documents``/``find``-with-sort/skip/limit) so
    tests run against local fixtures in this zero-egress environment.
    ``projection`` prunes fields server-side; the ColumnPruningPushdown
    rule feeds it from a following ``select_columns``."""

    def __init__(self, collection_factory, filter: Optional[Dict] = None,
                 projection: Optional[List[str]] = None):
        self._factory = collection_factory
        self._filter = filter or {}
        self._projection = projection

    def prune_columns(self, cols: List[str]) -> bool:
        if self._projection is not None and not set(cols) <= set(
            self._projection
        ):
            return False
        self._projection = list(cols)
        return True

    def _proj_doc(self) -> Optional[Dict[str, int]]:
        if self._projection is None:
            return None
        doc = {c: 1 for c in self._projection}
        # mongo returns _id unless excluded explicitly
        if "_id" not in doc:
            doc["_id"] = 0
        return doc

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, base_filter = self._factory, self._filter
        proj = self._proj_doc()
        coll = factory() if callable(factory) else factory
        total = coll.count_documents(base_filter)
        n_parts = max(1, min(parallelism, total or 1))
        # Split points: the _id at each boundary rank (reference uses
        # the connector's $bucketAuto-style partitioner; skip+limit on
        # the _id index is the portable equivalent).
        bounds: List[Any] = []
        for i in range(1, n_parts):
            rank = (total * i) // n_parts
            doc = next(iter(
                coll.find(base_filter, {"_id": 1})
                .sort("_id").skip(rank).limit(1)
            ), None)
            if doc is None:
                # collection shrank since count_documents: fewer
                # partitions, still full coverage (last range unbounded)
                break
            bounds.append(doc["_id"])
        n_parts = len(bounds) + 1

        def make(lo, hi):
            def read() -> Iterable[Block]:
                c = factory() if callable(factory) else factory
                f = dict(base_filter)
                id_range = dict(f.get("_id", {})) if isinstance(
                    f.get("_id"), dict
                ) else {}
                if lo is not None:
                    id_range["$gte"] = lo
                if hi is not None:
                    id_range["$lt"] = hi
                if id_range:
                    f["_id"] = id_range
                # No sort: rows within one _id range need no order, and
                # a projection may have excluded _id entirely.
                rows = list(c.find(f, proj))
                if rows:
                    yield build_block(rows)

            return read

        edges = [None] + bounds + [None]
        return [
            ReadTask(
                make(edges[i], edges[i + 1]),
                BlockMetadata(num_rows=0, size_bytes=0),
            )
            for i in range(n_parts)
        ]


# ------------------------------------------------------------------ writes

def write_block_file(block: Block, path: str, fmt: str, **kw) -> str:
    acc = BlockAccessor.for_block(block)
    if fmt == "parquet":
        pq = _require("pyarrow.parquet", "write_parquet")
        pq.write_table(acc.to_arrow(), path, **kw)
    elif fmt == "csv":
        pa_csv = _require("pyarrow.csv", "write_csv")
        pa_csv.write_csv(acc.to_arrow(), path, **kw)
    elif fmt == "json":
        acc.to_pandas().to_json(path, orient="records", lines=True)
    elif fmt == "numpy":
        np.save(path, acc.to_numpy_batch()[VALUE_COL])
    elif fmt == "tfrecords":
        from . import _tfrecord

        _tfrecord.write_examples(path, acc.iter_rows())
    else:
        raise ValueError(f"unknown write format {fmt}")
    return path
