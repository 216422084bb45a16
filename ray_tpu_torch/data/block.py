"""Blocks: the unit of distributed data.

Reference: python/ray/data/block.py — ``Block``, ``BlockAccessor``,
``BlockMetadata``; and this repo's ray_tpu/data/block.py, whose block is
a ``pyarrow.Table``. The port's block is a "numpy block": an ordered
``dict[str, np.ndarray]`` of equal-length columns. A tensor column keeps
its extra dims ([N, d1, ...]); strings, bytes and Python objects are
object arrays, one element per row. Nothing on the training path needs
pyarrow or pandas: a numpy batch goes to ``torch.from_numpy`` as it is.
``to_arrow``, ``to_pandas`` and the "pyarrow" and "pandas" batch formats
import their package when called, and raise an ``ImportError`` naming it
where it is absent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

Block = Dict[str, np.ndarray]
# A "batch" handed to user fns: dict of numpy arrays, pandas DataFrame,
# or a pyarrow Table, per batch_format.
DataBatch = Union[Dict[str, np.ndarray], Any]

#: column name used for datasets of plain (non-dict) python/numpy items,
#: mirroring the reference's TENSOR_COLUMN_NAME convention.
VALUE_COL = "item"


def _require(module: str, what: str):
    """Import `module` for `what`, or raise an ImportError naming it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = module.split(".")[0]
        raise ImportError(
            f"{what} needs {package}, which is not installed; the numpy "
            "batch format needs neither pyarrow nor pandas"
        ) from e


class Schema:
    """Column names, numpy dtypes and per-row shapes (the reference wraps
    a ``pa.Schema``)."""

    def __init__(self, names: List[str], types: List[np.dtype],
                 shapes: List[Tuple[int, ...]]):
        self._names = list(names)
        self._types = list(types)
        self._shapes = [tuple(s) for s in shapes]

    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def types(self) -> List[np.dtype]:
        return list(self._types)

    @property
    def shapes(self) -> List[Tuple[int, ...]]:
        return list(self._shapes)

    def __repr__(self):
        cols = ", ".join(
            f"{n}: {t}{list(s) if s else ''}"
            for n, t, s in zip(self._names, self._types, self._shapes)
        )
        return f"Schema({cols})"

    def __eq__(self, other):
        return isinstance(other, Schema) and (
            self._names, self._types, self._shapes
        ) == (other._names, other._types, other._shapes)


@dataclass
class BlockMetadata:
    """Stats the executor and optimizer need without fetching the block
    (reference: data/block.py BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Schema] = None
    input_files: List[str] = field(default_factory=list)
    exec_time_s: float = 0.0


def _object_array(vals) -> np.ndarray:
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):  # a slice assignment would broadcast lists
        out[i] = v
    return out


def _to_column(col: Any) -> np.ndarray:
    """One column as a numpy array: tensor columns keep their dims,
    strings and bytes become object arrays (numpy's fixed-width "U" and
    "S" would pad, and "S" drops trailing NUL bytes)."""
    if isinstance(col, np.ndarray):
        if col.dtype.kind in "US":
            return _object_array(col.tolist())
        return col
    vals = list(col)
    if any(isinstance(v, (str, bytes, bytearray)) or v is None for v in vals):
        return _object_array(vals)
    try:
        arr = np.asarray(vals)
    except ValueError:  # ragged rows
        return _object_array(vals)
    if arr.dtype.kind in "US":
        return _object_array(vals)
    if arr.dtype == object and arr.ndim != 1:
        return _object_array(vals)
    return arr


def _from_arrow(table) -> Block:
    """A pyarrow table as a numpy block; nested FixedSizeList columns
    (the reference's tensor columns) become [N, d1, ...] arrays."""
    import pyarrow as pa

    out: Block = {}
    for name in table.column_names:
        c = table.column(name).combine_chunks()
        if pa.types.is_fixed_size_list(c.type):
            shape, n = [], len(c)
            while pa.types.is_fixed_size_list(c.type):
                shape.append(c.type.list_size)
                c = c.flatten()  # flatten() respects slice offsets
            out[name] = c.to_numpy(zero_copy_only=False).reshape((n, *shape))
            continue
        try:
            arr = c.to_numpy(zero_copy_only=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            arr = _object_array(c.to_pylist())
        out[name] = _to_column(arr)
    return out


def _is_instance_of(data: Any, module: str, name: str) -> bool:
    """isinstance against a class of a package that may not be installed,
    without importing it."""
    return any(
        t.__module__.split(".")[0] == module and t.__name__ == name
        for t in type(data).__mro__
    )


def build_block(data: Any) -> Block:
    """Coerce rows/batch-like data into the canonical numpy block."""
    if data is None:
        return {}
    if isinstance(data, dict):
        return {k: _to_column(v) for k, v in data.items()}
    if isinstance(data, list):
        if not data:
            return {}
        if isinstance(data[0], dict):
            cols: Dict[str, list] = {k: [] for k in data[0]}
            for row in data:
                for k in cols:
                    cols[k].append(row.get(k))
            return {k: _to_column(v) for k, v in cols.items()}
        return {VALUE_COL: _to_column(data)}
    if isinstance(data, np.ndarray):
        return {VALUE_COL: _to_column(data)}
    if _is_instance_of(data, "pyarrow", "Table"):
        return _from_arrow(data)
    if _is_instance_of(data, "pandas", "DataFrame"):
        return {str(k): _to_column(data[k].to_numpy()) for k in data.columns}
    raise TypeError(f"cannot build a block from {type(data)}")


def _column_bytes(col: np.ndarray) -> int:
    if col.dtype != object:
        return col.nbytes
    # Pointers, plus the payload of the str/bytes a row holds (arrow's
    # nbytes counts the values' bytes too).
    return col.nbytes + sum(
        len(v) for v in col if isinstance(v, (str, bytes, bytearray))
    )


def _arrow_array(col: np.ndarray):
    import pyarrow as pa

    if col.ndim > 1:
        # Nested FixedSizeList: the reference's tensor column layout.
        inner = pa.array(np.ascontiguousarray(col).reshape(-1))
        for dim in reversed(col.shape[1:]):
            inner = pa.FixedSizeListArray.from_arrays(inner, dim)
        return inner
    if col.dtype == object:
        return pa.array(col.tolist())
    return pa.array(col)


class BlockAccessor:
    """Format-generic view over one block (reference: BlockAccessor.for_block)."""

    def __init__(self, block: Block):
        self._b = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(build_block(block))

    def num_rows(self) -> int:
        for col in self._b.values():
            return len(col)
        return 0

    def size_bytes(self) -> int:
        return sum(_column_bytes(c) for c in self._b.values())

    def schema(self) -> Schema:
        return Schema(
            list(self._b), [c.dtype for c in self._b.values()],
            [c.shape[1:] for c in self._b.values()],
        )

    def to_arrow(self):
        pa = _require("pyarrow", "to_arrow")
        return pa.table({k: _arrow_array(v) for k, v in self._b.items()})

    def to_pandas(self):
        pd = _require("pandas", "to_pandas")
        return pd.DataFrame({
            k: list(v) if v.ndim > 1 else v for k, v in self._b.items()
        })

    def to_numpy_batch(self) -> Dict[str, np.ndarray]:
        return dict(self._b)

    def to_batch(self, batch_format: str) -> DataBatch:
        if batch_format in ("numpy", "default", None):
            return self.to_numpy_batch()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        """Rows as dicts: Python scalars for scalar columns (as arrow's
        to_pylist gives), an [d1, ...] array for a tensor column, and
        the stored object for an object column."""
        names = list(self._b)
        cols = [
            c if (c.ndim > 1 or c.dtype == object) else c.tolist()
            for c in self._b.values()
        ]
        for i in range(self.num_rows()):
            yield {n: c[i] for n, c in zip(names, cols)}

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}

    def take_indices(self, idx: np.ndarray) -> Block:
        idx = np.asarray(idx, dtype=np.int64)
        return {k: v[idx] for k, v in self._b.items()}

    def sample_rows(self, n: int, seed: Optional[int] = None) -> Block:
        rng = np.random.RandomState(seed)
        n = min(n, self.num_rows())
        idx = rng.choice(self.num_rows(), size=n, replace=False)
        return self.take_indices(idx)

    def metadata(self, input_files: Optional[List[str]] = None,
                 exec_time_s: float = 0.0) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=input_files or [],
            exec_time_s=exec_time_s,
        )


def _concat_column(parts: List[np.ndarray]) -> np.ndarray:
    try:
        return np.concatenate(parts)
    except ValueError:
        # Tensor columns of different row shapes: one array per row.
        return _object_array([row for p in parts for row in p])


def concat_blocks(blocks: List[Block]) -> Block:
    """Rows of every non-empty block, in order. A column some blocks lack
    is None in their rows (the reference's promote_options="default")."""
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    names: List[str] = []
    for b in blocks:
        names.extend(k for k in b if k not in names)
    out: Block = {}
    for name in names:
        parts = [
            b[name] if name in b
            else _object_array([None] * BlockAccessor(b).num_rows())
            for b in blocks
        ]
        out[name] = _concat_column(parts)
    return out


def batch_to_block(batch: DataBatch) -> Block:
    return build_block(batch)
