"""State API implementation."""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional


def _list(kind: str, limit: int = 1000,
          filters: Optional[List[tuple]] = None) -> List[Dict[str, Any]]:
    from ..._private.worker import global_client

    for f in filters or []:
        if f[1] not in ("=", "!="):
            raise ValueError(f"unsupported filter op {f[1]!r}")
    # Filters apply server-side BEFORE the limit truncation so matches
    # beyond `limit` aren't silently dropped.
    reply = global_client().state_read(
        {"type": "list_state", "kind": kind, "limit": limit,
         "filters": [list(f) for f in filters or []]}
    )
    if not reply.get("ok"):
        raise RuntimeError(f"list_state({kind}) failed: {reply.get('error')}")
    return reply["items"]


def list_actors(filters=None, limit: int = 1000):
    return _list("actors", limit, filters)


def list_tasks(filters=None, limit: int = 1000):
    return _list("tasks", limit, filters)


def list_nodes(filters=None, limit: int = 1000):
    return _list("nodes", limit, filters)


def list_workers(filters=None, limit: int = 1000):
    return _list("workers", limit, filters)


def list_objects(filters=None, limit: int = 1000):
    return _list("objects", limit, filters)


def list_placement_groups(filters=None, limit: int = 1000):
    return _list("placement_groups", limit, filters)


def list_cluster_events(
    entity: Optional[str] = None,
    category: Optional[str] = None,
    job: Optional[str] = None,
    event: Optional[str] = None,
    limit: int = 1000,
) -> List[Dict[str, Any]]:
    """Flight-recorder transitions (reference: `ray list cluster-events`
    over the GCS task-event store; here events.py covers every layer
    boundary — submission, scheduling, lease, fork, exec, seal)."""
    from ..._private.state import list_cluster_events as _impl

    return _impl(
        entity=entity, category=category, job=job, event=event,
        limit=limit,
    )


def summarize_events() -> Dict[str, Any]:
    """Derived flight-recorder metrics: per-phase latency histograms,
    drop counters, live pending-queue depth."""
    from ..._private.worker import global_client

    reply = global_client().request({"type": "events_summary"})
    if not reply.get("ok"):
        raise RuntimeError("events_summary failed")
    return reply["summary"]


def set_events_recording(enabled: bool) -> None:
    """Toggle flight-recorder capture cluster-wide at runtime (head +
    every worker and node daemon), without a restart. Already-recorded
    events stay readable; only new captures stop."""
    from ..._private.worker import global_client

    reply = global_client().request(
        {"type": "set_events_recording", "enabled": bool(enabled)}
    )
    if not reply.get("ok"):
        raise RuntimeError("set_events_recording failed")


def summarize_tasks() -> Dict[str, Any]:
    """Per-function-name counts by state (reference:
    util/state/api.py summarize_tasks:1365)."""
    tasks = _list("tasks", limit=100_000)
    by_func: Dict[str, Counter] = {}
    for t in tasks:
        by_func.setdefault(t["name"], Counter())[t["state"]] += 1
    return {
        "total": len(tasks),
        "by_func_name": {
            name: dict(states) for name, states in sorted(by_func.items())
        },
    }
