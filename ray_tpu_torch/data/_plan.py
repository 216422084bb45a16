"""Logical plan + optimizer for Datasets.

Reference: python/ray/data/_internal/logical_operators/ (Read, MapBatches,
Filter…), optimizer rules data/_internal/logical/rules/operator_fusion.py
(fuse consecutive map-likes into one task) and limit_pushdown.py. Plans
here are linear chains of operators from one source; n-ary ops (union,
zip) materialize their extra inputs first, as the reference's all-to-all
operators do.

The port's copy of ray_tpu/data/_plan.py, over numpy blocks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    batch_to_block,
    build_block,
    concat_blocks,
)
from .datasource import Datasource, write_block_file

# A transform is one fused step applied to a block inside a single task.
# kinds: map_batches / map_rows / filter / flat_map / limit / write
Transform = Tuple[str, Dict[str, Any]]


@dataclass
class MapSpec:
    """The fused chain of transforms one task applies (reference:
    MapTransformer in data/_internal/execution/operators/map_transformer.py)."""

    transforms: List[Transform] = field(default_factory=list)

    def apply(self, block: Block, task_index: int = 0) -> Block:
        for kind, kw in self.transforms:
            acc = BlockAccessor.for_block(block)
            if kind == "map_batches":
                fn = kw["fn"]
                size = kw.get("batch_size")
                fmt = kw.get("batch_format", "numpy")
                fn_kwargs = dict(kw.get("fn_kwargs") or {})
                if kw.get("pass_task_index"):
                    fn_kwargs["_task_index"] = task_index
                out: List[Block] = []
                n = acc.num_rows()
                step = size or max(n, 1)
                # Never call the fn on an empty (schema-less) block — an
                # upstream filter may have emptied it.
                for start in range(0, n, step):
                    piece = BlockAccessor.for_block(acc.slice(start, min(start + step, n)))
                    res = fn(piece.to_batch(fmt), **fn_kwargs)
                    out.append(batch_to_block(res))
                block = concat_blocks(out) if out else build_block({})
            elif kind == "map_rows":
                fn = kw["fn"]
                block = build_block([fn(r) for r in acc.iter_rows()])
            elif kind == "filter":
                fn = kw["fn"]
                block = build_block([r for r in acc.iter_rows() if fn(r)])
            elif kind == "flat_map":
                fn = kw["fn"]
                rows: List[Any] = []
                for r in acc.iter_rows():
                    rows.extend(fn(r))
                block = build_block(rows)
            elif kind == "limit":
                block = acc.slice(0, min(kw["n"], acc.num_rows()))
            elif kind == "write":
                path = kw["path_template"].format(i=task_index)
                write_block_file(block, path, kw["fmt"], **(kw.get("kw") or {}))
                block = build_block([{"path": path}])
            else:
                raise ValueError(f"unknown transform {kind}")
        return block


# ----------------------------------------------------------- logical ops

class LogicalOp:
    name = "Op"

    def is_map_like(self) -> bool:
        return False


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1
    name = "Read"


@dataclass
class InputData(LogicalOp):
    """Pre-materialized bundles (from_blocks / from_pandas…)."""

    bundles: List[Tuple[Any, BlockMetadata]]
    name = "InputData"


@dataclass
class MapLike(LogicalOp):
    kind: str
    kwargs: Dict[str, Any]

    @property
    def name(self):  # type: ignore[override]
        return self.kind

    def is_map_like(self) -> bool:
        return True

    def row_preserving(self) -> bool:
        # Only 1:1 row transforms; a map_batches fn may change row counts,
        # so a Limit must not move past it (reference: limit_pushdown.py
        # only crosses ops that cannot alter cardinality).
        return self.kind == "map_rows"


@dataclass
class Limit(LogicalOp):
    n: int
    name = "Limit"


@dataclass
class FusedMap(LogicalOp):
    """A run of map-likes merged by the OperatorFusion rule; one task
    applies the whole chain (reference: rules/operator_fusion.py)."""

    transforms: List[Transform]

    @property
    def name(self):  # type: ignore[override]
        return "+".join(k for k, _ in self.transforms)

    def is_map_like(self) -> bool:
        return True


@dataclass
class AllToAll(LogicalOp):
    """Barrier ops executed over the materialized bundle list by a
    function in the calling process (reference: AllToAllOperator)."""

    kind: str  # repartition / random_shuffle / sort / union / zip / hash_partition
    kwargs: Dict[str, Any]

    @property
    def name(self):  # type: ignore[override]
        return self.kind


@dataclass
class LogicalPlan:
    ops: List[LogicalOp]

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])


# ------------------------------------------------------------- optimizer

@dataclass
class MapSegment:
    """A fused pipeline segment: optional source + fused transforms +
    an early-stop row limit for the launcher."""

    source: Optional[LogicalOp]  # Read or InputData; None = previous segment
    spec: MapSpec
    stop_after_rows: Optional[int] = None


def optimize(plan: LogicalPlan, rules=None) -> List[Any]:
    """LogicalPlan -> [MapSegment | AllToAll, ...]: run the named rule
    pipeline (``_rules.DEFAULT_RULES`` — fusion, limit pushdown, column
    pruning), then segment the rewritten ops for the streaming
    executor (reference: LogicalOptimizer.optimize in
    data/_internal/logical/optimizers.py)."""
    from ._rules import apply_rules

    return segment(apply_rules(list(plan.ops), rules))


def segment(ops: List[LogicalOp]) -> List[Any]:
    """Attach (possibly fused) map chains to their upstream source so
    read+transform run in one task; all-to-alls stay barriers."""
    segments: List[Any] = []
    cur_seg: Optional[MapSegment] = None
    for op in ops:
        if isinstance(op, (Read, InputData)):
            cur_seg = MapSegment(source=op, spec=MapSpec())
            segments.append(cur_seg)
        elif isinstance(op, FusedMap):
            if cur_seg is None:
                cur_seg = MapSegment(source=None, spec=MapSpec())
                segments.append(cur_seg)
            cur_seg.spec.transforms.extend(op.transforms)
        elif isinstance(op, MapLike):
            if cur_seg is None:
                cur_seg = MapSegment(source=None, spec=MapSpec())
                segments.append(cur_seg)
            cur_seg.spec.transforms.append((op.kind, op.kwargs))
        elif isinstance(op, Limit):
            if cur_seg is None:
                cur_seg = MapSegment(source=None, spec=MapSpec())
                segments.append(cur_seg)
            cur_seg.spec.transforms.append(("limit", {"n": op.n}))
            cur_seg.stop_after_rows = (
                op.n
                if cur_seg.stop_after_rows is None
                else min(cur_seg.stop_after_rows, op.n)
            )
        elif isinstance(op, AllToAll):
            segments.append(op)
            cur_seg = None
        else:
            raise TypeError(f"unknown logical op {op}")
    return segments
