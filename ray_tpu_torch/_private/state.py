"""GlobalState helpers: timeline export (reference:
python/ray/_private/state.py — ray.timeline :942 dumps chrome://tracing
JSON from the GCS task-event store).

Every event-name literal this module stitches against is checked
against _private/event_names.py by raylint (the module marker below):
a renamed event fails the lint instead of silently vanishing from the
timeline."""
# raylint: check-event-literals
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def task_events() -> List[Dict[str, Any]]:
    from .worker import global_client

    reply = global_client().state_read({"type": "get_task_events"})
    if not reply.get("ok"):
        raise RuntimeError("get_task_events failed")
    return reply["events"]


def list_cluster_events(
    entity: Optional[str] = None,
    category: Optional[str] = None,
    job: Optional[str] = None,
    event: Optional[str] = None,
    limit: int = 1000,
) -> List[Dict[str, Any]]:
    """Flight-recorder transitions from the head aggregator
    (events.py); the read barrier-flushes worker rings first."""
    from .worker import global_client

    reply = global_client().state_read(
        {
            "type": "list_events",
            "entity": entity,
            "category": category,
            "job": job,
            "event": event,
            "limit": limit,
        }
    )
    if not reply.get("ok"):
        raise RuntimeError("list_events failed")
    return reply["events"]


def task_transitions(task_id_hex: str) -> List[Dict[str, Any]]:
    """One task's lifecycle transitions (SUBMITTED → ... → SEALED),
    time-ordered."""
    return list_cluster_events(
        entity=task_id_hex, category="task", limit=10_000
    )


def timeline(filename: Optional[str] = None) -> Optional[List[Dict]]:
    """Chrome-trace (chrome://tracing / perfetto) export of task
    execution. RUNNING→FINISHED/FAILED pairs become complete ("X")
    events laid out per worker, PLUS one stitched row per task from
    the flight recorder: the submit→queue→lease→fork→exec→seal
    phases laid end to end (pid "tasks")."""
    events = task_events()
    starts: Dict[str, Dict[str, Any]] = {}
    trace: List[Dict[str, Any]] = []
    for ev in events:
        if ev["event"] == "RUNNING":
            starts[ev["task_id"]] = ev
        elif ev["event"] in ("FINISHED", "FAILED"):
            start = starts.pop(ev["task_id"], None)
            if start is None:
                continue
            trace.append(
                {
                    "name": start["name"],
                    "cat": "task",
                    "ph": "X",
                    "ts": start["timestamp"] * 1e6,
                    "dur": (ev["timestamp"] - start["timestamp"]) * 1e6,
                    "pid": ev["worker_id"][:8] or "driver",
                    "tid": ev["worker_id"][:8] or "driver",
                    "args": {
                        "task_id": ev["task_id"],
                        "state": ev["event"],
                    },
                }
            )
    try:
        from . import events as _events

        recorder_events = list_cluster_events(
            category="task", limit=100_000
        )
        for slices in _events.stitch_task_phases(recorder_events).values():
            trace.extend(slices)
    except Exception:  # noqa: BLE001 - recorder disabled or old head
        pass
    try:
        # Object-plane rows (pid "object_plane"): shard applies and
        # admitted pulls (PULL_DONE carries the activate→done window)
        # render as duration slices, flush/enqueue/promotion/queueing/
        # cancellation/spill failures as instants — an object-plane
        # stall shows up NEXT TO the task phase it delays (e.g. a long
        # SHARD_APPLY beside widened seal phases, a starved PULL_QUEUED
        # train beside a broadcast).
        refs_events = list_cluster_events(category="refs", limit=100_000)
        for ev in refs_events:
            attrs = ev.get("attrs") or {}
            name = ev["event"]
            base = {
                "name": name,
                "cat": "object_plane",
                "pid": "object_plane",
                "tid": ev["entity"],
                "args": {**attrs, "entity": ev["entity"]},
            }
            if name in ("SHARD_APPLY", "PULL_DONE") and \
                    attrs.get("seconds") is not None:
                dur = float(attrs["seconds"]) * 1e6
                trace.append(
                    {
                        **base, "ph": "X", "dur": dur,
                        "ts": ev["timestamp"] * 1e6 - dur,
                    }
                )
            else:
                trace.append(
                    {**base, "ph": "i", "ts": ev["timestamp"] * 1e6,
                     "s": "t"}
                )
    except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- recorder disabled or old head: the timeline goes without these rows
        pass
    try:
        # Chaos rows (pid "chaos"): every injected fault — message
        # drop/delay/dup/reorder, connect refusals, process kills —
        # renders as an instant beside the task/object-plane rows it
        # perturbed, so a failed chaos run is attributable from the
        # timeline alone.
        chaos_events = list_cluster_events(category="chaos", limit=100_000)
        cuts: Dict[str, Dict[str, Any]] = {}
        throttles: Dict[str, Dict[str, Any]] = {}
        for ev in chaos_events:
            name, entity = ev["event"], ev["entity"]
            if name == "PARTITION_BEGIN":
                cuts[entity] = ev
                continue
            if name == "THROTTLE_BEGIN":
                throttles[entity] = ev
                continue
            if name == "THROTTLE_HEAL" and entity in throttles:
                # Stragglers row (pid "stragglers"): the window a link
                # ran degraded renders as one slice, so suspect edges,
                # quarantines and hedges line up under the throttle
                # that caused them.
                t0 = throttles.pop(entity)["timestamp"]
                trace.append(
                    {
                        "name": f"throttle:{entity}",
                        "cat": "stragglers", "pid": "stragglers",
                        "tid": entity, "ph": "X", "ts": t0 * 1e6,
                        "dur": max(0.0, ev["timestamp"] - t0) * 1e6,
                        "args": {
                            **(ev.get("attrs") or {}), "entity": entity,
                        },
                    }
                )
                continue
            if name == "PARTITION_HEAL" and entity in cuts:
                # Membership row (pid "membership"): the cut window a
                # link pair observed renders as one slice, so fences and
                # zombie drains line up under the partition that caused
                # them.
                t0 = cuts.pop(entity)["timestamp"]
                trace.append(
                    {
                        "name": f"partition:{entity}",
                        "cat": "membership", "pid": "membership",
                        "tid": entity, "ph": "X", "ts": t0 * 1e6,
                        "dur": max(0.0, ev["timestamp"] - t0) * 1e6,
                        "args": {
                            **(ev.get("attrs") or {}), "entity": entity,
                        },
                    }
                )
                continue
            trace.append(
                {
                    "name": f"{name}:{entity}",
                    "cat": "chaos",
                    "pid": "chaos",
                    "tid": name,
                    "ph": "i",
                    "ts": ev["timestamp"] * 1e6,
                    "s": "g",
                    "args": {
                        **(ev.get("attrs") or {}),
                        "entity": entity,
                        "source": ev.get("source", ""),
                    },
                }
            )
        # Unhealed throttles (still slow at dump time) stay visible.
        for entity, ev in throttles.items():
            trace.append(
                {
                    "name": f"throttle:{entity}", "cat": "stragglers",
                    "pid": "stragglers", "tid": entity, "ph": "i",
                    "ts": ev["timestamp"] * 1e6, "s": "g",
                    "args": {**(ev.get("attrs") or {}), "entity": entity},
                }
            )
        # Unhealed cuts (still dark at dump time) stay visible.
        for entity, ev in cuts.items():
            trace.append(
                {
                    "name": f"partition:{entity}", "cat": "membership",
                    "pid": "membership", "tid": entity, "ph": "i",
                    "ts": ev["timestamp"] * 1e6, "s": "g",
                    "args": {**(ev.get("attrs") or {}), "entity": entity},
                }
            )
    except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- recorder disabled or old head: the timeline goes without these rows
        pass
    try:
        # Failover rows (pid "failover"): HEAD_DOWN/HEAD_RECONNECT
        # pairs per client render as duration slices (the outage window
        # each process observed), RECONCILE_BEGIN/RECONCILE_END as the
        # head's recovery window, and claims/ghost sweeps as instants —
        # so a failover's outage and reconcile durations are measurable
        # per session straight from the timeline.
        head_events = list_cluster_events(category="head", limit=100_000)
        downs: Dict[str, Dict[str, Any]] = {}
        quarantines: Dict[str, Dict[str, Any]] = {}
        begin: Optional[Dict[str, Any]] = None
        for ev in head_events:
            name, entity = ev["event"], ev["entity"]
            base = {
                "cat": "failover",
                "pid": "failover",
                "tid": entity,
                "args": {**(ev.get("attrs") or {}), "entity": entity},
            }
            if name == "HEAD_DOWN":
                downs[entity] = ev
                continue
            if name == "HEALTH_SCORE":
                # Counter track: the scorer's EWMA per node, so a
                # node's decay/recovery is a curve under the throttle
                # slice that drove it.
                trace.append(
                    {
                        "name": f"health:{entity}", "cat": "stragglers",
                        "pid": "stragglers", "ph": "C",
                        "ts": ev["timestamp"] * 1e6,
                        "args": {
                            "score": (ev.get("attrs") or {}).get("score", 0)
                        },
                    }
                )
                continue
            if name == "NODE_QUARANTINE":
                quarantines[entity] = ev
                continue
            if name == "NODE_READMIT" and entity in quarantines:
                t0 = quarantines.pop(entity)["timestamp"]
                trace.append(
                    {
                        **base, "name": f"quarantine:{entity}",
                        "cat": "stragglers", "pid": "stragglers",
                        "ph": "X", "ts": t0 * 1e6,
                        "dur": max(0.0, ev["timestamp"] - t0) * 1e6,
                    }
                )
                continue
            if name in (
                "NODE_SUSPECT", "NODE_READMIT",
                "HEDGE_LAUNCH", "HEDGE_WIN", "HEDGE_CANCEL",
            ):
                trace.append(
                    {
                        **base, "name": name, "cat": "stragglers",
                        "pid": "stragglers", "ph": "i",
                        "ts": ev["timestamp"] * 1e6, "s": "g",
                    }
                )
                continue
            if name == "HEAD_RECONNECT" and entity in downs:
                t0 = downs.pop(entity)["timestamp"]
                trace.append(
                    {
                        **base, "name": "outage", "ph": "X",
                        "ts": t0 * 1e6,
                        "dur": max(0.0, ev["timestamp"] - t0) * 1e6,
                    }
                )
                continue
            if name in (
                "NODE_FENCED", "ACTOR_EPOCH_FENCED", "ZOMBIE_SELF_FENCE"
            ):
                # Membership row: every fence decision (head-side stale
                # rejection, epoch mismatch, zombie drain) renders as an
                # instant beside the partition slice that provoked it.
                trace.append(
                    {
                        **base, "name": name, "cat": "membership",
                        "pid": "membership", "ph": "i",
                        "ts": ev["timestamp"] * 1e6, "s": "g",
                    }
                )
                continue
            if name == "RECONCILE_BEGIN":
                begin = ev
                continue
            if name == "RECONCILE_END" and begin is not None:
                t0 = begin["timestamp"]
                trace.append(
                    {
                        **base, "name": "recovery_window", "ph": "X",
                        "ts": t0 * 1e6,
                        "dur": max(0.0, ev["timestamp"] - t0) * 1e6,
                    }
                )
                begin = None
                continue
            trace.append(
                {**base, "name": name, "ph": "i",
                 "ts": ev["timestamp"] * 1e6, "s": "g"}
            )
        # Still-quarantined nodes at dump time stay visible.
        for entity, ev in quarantines.items():
            trace.append(
                {
                    "name": f"quarantine:{entity}", "cat": "stragglers",
                    "pid": "stragglers", "tid": entity, "ph": "i",
                    "ts": ev["timestamp"] * 1e6, "s": "g",
                    "args": {**(ev.get("attrs") or {}), "entity": entity},
                }
            )
        # Unpaired HEAD_DOWNs (reconnect never landed) stay visible.
        for entity, ev in downs.items():
            trace.append(
                {
                    "name": "HEAD_DOWN", "cat": "failover",
                    "pid": "failover", "tid": entity, "ph": "i",
                    "ts": ev["timestamp"] * 1e6, "s": "g",
                    "args": {**(ev.get("attrs") or {}), "entity": entity},
                }
            )
    except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- recorder disabled or old head: the timeline goes without these rows
        pass
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
        return None
    return trace
