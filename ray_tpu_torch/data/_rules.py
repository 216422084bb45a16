"""Named logical-plan rewrite rules.

Reference: python/ray/data/_internal/logical/rules/ — the optimizer
there is a list of Rule classes (operator_fusion.py, limit_pushdown.py,
zero_copy_map_fusion.py) each rewriting the logical DAG; sources and
projections meet in `set_read_parallelism`/parquet column pruning. Here
a rule rewrites the linear op list; `optimize()` in ``_plan.py`` runs
``DEFAULT_RULES`` in order and then segments the result for the
streaming executor. New rules plug in by appending to ``DEFAULT_RULES``
(or passing ``rules=`` to ``apply_rules``), in place of ad-hoc fusion
inside segmentation. A copy of the reference's module (ray_tpu/data/_rules.py).
"""
from __future__ import annotations

from typing import List, Optional


class Rule:
    """One rewrite pass: ops in, ops out (pure; no execution)."""

    name = "Rule"

    def apply(self, ops: List["LogicalOp"]) -> List["LogicalOp"]:
        raise NotImplementedError


class LimitPushdown(Rule):
    """Bubble ``Limit`` ops upstream past row-preserving transforms so
    the launcher stops scheduling reads as early as possible
    (reference: rules/limit_pushdown.py — a Limit only crosses
    operators that cannot change row count)."""

    name = "LimitPushdown"

    def apply(self, ops):
        from ._plan import Limit, MapLike

        ops = list(ops)
        changed = True
        while changed:
            changed = False
            for i in range(1, len(ops)):
                prev, cur = ops[i - 1], ops[i]
                if (
                    isinstance(cur, Limit)
                    and isinstance(prev, MapLike)
                    and prev.row_preserving()
                ):
                    ops[i - 1], ops[i] = cur, prev
                    changed = True
        return ops


class ColumnPruningPushdown(Rule):
    """Push a ``select_columns`` projection into the source read when it
    is the first transform after the Read and the source can prune
    (Parquet/Lance column projection, Mongo cursor projection) —
    reference: the parquet datasource's ``columns=`` pushdown plus
    rules/zero_copy_map_fusion.py's dropped-projection rewrites. The
    select op is removed: the source then emits exactly those columns,
    so bytes never read leave disk/DB."""

    name = "ColumnPruningPushdown"

    def apply(self, ops):
        import copy

        from ._plan import MapLike, Read

        ops = list(ops)
        i = 0
        while i + 1 < len(ops):
            op, nxt = ops[i], ops[i + 1]
            if (
                isinstance(op, Read)
                and isinstance(nxt, MapLike)
                and nxt.kwargs.get("projection") is not None
                and hasattr(op.datasource, "prune_columns")
            ):
                # Never mutate the shared source: sibling Datasets
                # derived from the same read hold the same op objects.
                pruned = copy.copy(op.datasource)
                if pruned.prune_columns(list(nxt.kwargs["projection"])):
                    ops[i] = Read(pruned, op.parallelism)
                    del ops[i + 1]
                    continue  # a following select may also push down
            i += 1
        return ops


class OperatorFusion(Rule):
    """Merge runs of consecutive map-like ops into one ``FusedMap`` so
    each task applies the whole chain to a block without materializing
    intermediates (reference: rules/operator_fusion.py — map ops fuse
    unless separated by an all-to-all boundary)."""

    name = "OperatorFusion"

    def apply(self, ops):
        from ._plan import FusedMap, MapLike

        out: List = []
        for op in ops:
            if isinstance(op, MapLike):
                if out and isinstance(out[-1], FusedMap):
                    out[-1] = FusedMap(
                        out[-1].transforms + [(op.kind, op.kwargs)]
                    )
                else:
                    out.append(FusedMap([(op.kind, op.kwargs)]))
            else:
                out.append(op)
        return out


DEFAULT_RULES: List[Rule] = [
    LimitPushdown(),
    ColumnPruningPushdown(),
    OperatorFusion(),
]


def apply_rules(ops, rules: Optional[List[Rule]] = None):
    for rule in DEFAULT_RULES if rules is None else rules:
        ops = rule.apply(ops)
    return ops
