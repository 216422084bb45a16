"""Placement groups: gang resource reservation.

Reference: python/ray/util/placement_group.py:145 and the GCS-side 2PC
scheduler (gcs_placement_group_scheduler.h:113). With the resource
authority centralized in this rebuild's GCS, reservation is a single
atomic transaction; the strategies (PACK/SPREAD/STRICT_*) keep reference
semantics. `train.TorchTrainer` gang-places its workers with one bundle
per worker ({"GPU": 1} each with `use_gpu`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .._private.ids import PlacementGroupID
from .._private.worker import global_client

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self._bundles = bundles

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self) -> bool:
        info = global_client().request(
            {"type": "placement_group_info", "pg_id": self.id.binary()}
        )
        return bool(info.get("ok")) and info.get("state") == "CREATED"

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until every bundle is reserved. PGs can sit PENDING
        (capacity busy, or an autoscaler still adding nodes —
        reference: gcs_placement_group_manager pending queue). The
        request parks at the GCS and is answered on the state
        transition — no polling."""
        try:
            reply = global_client().request(
                {"type": "wait_placement_group", "pg_id": self.id.binary()},
                timeout=timeout_seconds,
            )
        except Exception:  # noqa: BLE001 - timeout
            return False
        return bool(reply.get("ok")) and reply.get("state") == "CREATED"

    def bundle_placements(self) -> List[Optional[bytes]]:
        info = global_client().request(
            {"type": "placement_group_info", "pg_id": self.id.binary()}
        )
        if not info.get("ok"):
            return []
        return [b["node_id"] for b in info["bundles"]]

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy}; one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    pg_id = PlacementGroupID.from_random()
    reply = global_client().request(
        {
            "type": "create_placement_group",
            "pg_id": pg_id.binary(),
            "bundles": [{k: float(v) for k, v in b.items()} for b in bundles],
            "strategy": strategy,
            "name": name,
        }
    )
    if not reply.get("ok"):
        from ..exceptions import PlacementGroupSchedulingError

        raise PlacementGroupSchedulingError(reply.get("error", "unschedulable"))
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    global_client().request(
        {"type": "remove_placement_group", "pg_id": pg.id.binary()}
    )
