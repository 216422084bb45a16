"""State API: typed listing of cluster entities.

Reference: python/ray/util/state/api.py (list_actors:781,
list_tasks:1008, summarize_tasks:1365) — served there by the dashboard
StateHead + state aggregator over GCS; served here directly by the GCS.
``list_cluster_events`` / ``summarize_events`` read the flight
recorder (_private/events.py).
"""
from __future__ import annotations

from .api import (  # noqa: F401
    list_actors,
    list_cluster_events,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    list_workers,
    set_events_recording,
    summarize_events,
    summarize_tasks,
)

__all__ = [
    "list_actors",
    "list_cluster_events",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "list_tasks",
    "list_workers",
    "set_events_recording",
    "summarize_events",
    "summarize_tasks",
]
