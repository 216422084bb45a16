"""GroupedData: hash-partitioned groupby + aggregations.

Reference: python/ray/data/grouped_data.py (GroupedData.aggregate,
map_groups) over the hash-shuffle all-to-all. Each aggregation runs as
a two-stage job: hash-partition blocks by key, then per-partition
group-aggregate tasks.

The port's copy of ray_tpu/data/grouped.py: the groups are found on
numpy columns.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from .block import BlockAccessor, build_block
from ._plan import AllToAll, MapLike

_AGGS = {
    "count": lambda v: len(v),
    "sum": lambda v: np.sum(v),
    "min": lambda v: np.min(v),
    "max": lambda v: np.max(v),
    "mean": lambda v: float(np.mean(v)),
    "std": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else 0.0,
}


def _group_rows(batch: Dict[str, np.ndarray], key: str):
    keys = batch[key]
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    bounds = list(starts) + [len(sorted_keys)]
    for i, k in enumerate(uniq):
        idx = order[bounds[i]:bounds[i + 1]]
        yield k, {c: v[idx] for c, v in batch.items()}


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    def _partitioned(self, num_partitions: Optional[int] = None):
        n = num_partitions or max(
            1, int(ray_tpu_torch.cluster_resources().get("CPU", 4))
        )
        return self._ds._append(
            AllToAll("hash_partition",
                     {"key": self._key, "num_partitions": n})
        )

    def _agg(self, kinds: Dict[str, str]):
        """kinds: output_col -> "fn:source_col"."""
        key = self._key

        def agg_batch(batch: Dict[str, np.ndarray], _kinds=dict(kinds)):
            if key not in batch:  # empty hash partition: no schema
                return {}
            out: Dict[str, List[Any]] = {key: []}
            for col in _kinds:
                out[col] = []
            for k, grp in _group_rows(batch, key):
                out[key].append(k)
                for col, spec in _kinds.items():
                    fn_name, src = spec.split(":")
                    out[col].append(_AGGS[fn_name](grp[src]))
            return {c: np.asarray(v) for c, v in out.items()}

        return self._partitioned().map_batches(agg_batch, batch_size=None)

    def count(self):
        return self._agg({"count()": f"count:{self._key}"})

    def sum(self, col: str):
        return self._agg({f"sum({col})": f"sum:{col}"})

    def min(self, col: str):
        return self._agg({f"min({col})": f"min:{col}"})

    def max(self, col: str):
        return self._agg({f"max({col})": f"max:{col}"})

    def mean(self, col: str):
        return self._agg({f"mean({col})": f"mean:{col}"})

    def std(self, col: str):
        return self._agg({f"std({col})": f"std:{col}"})

    def aggregate(self, **named: str):
        """aggregate(total="sum:value", n="count:value")"""
        return self._agg(named)

    def map_groups(self, fn: Callable[[Dict[str, np.ndarray]], Any]):
        key = self._key

        def apply_groups(batch: Dict[str, np.ndarray], _fn=fn):
            if key not in batch:  # empty hash partition: no schema
                return {}
            rows: List[Any] = []
            for _, grp in _group_rows(batch, key):
                res = _fn(grp)
                if isinstance(res, dict):
                    acc = BlockAccessor.for_block(build_block(res))
                    rows.extend(acc.iter_rows())
                elif isinstance(res, list):
                    rows.extend(res)
                else:
                    rows.append(res)
            return build_block(rows)

        return self._partitioned().map_batches(apply_groups, batch_size=None)
