"""User-defined metrics: Counter / Gauge / Histogram.

Reference: python/ray/util/metrics.py — metrics flow through the node's
metrics agent to Prometheus there; here each process publishes its
series into the GCS KV under a reserved namespace, and
``get_metrics_snapshot()`` (or the CLI's ``python -m ray_tpu_torch
metrics``) aggregates across processes. Tag-based partitioning matches
the reference API.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_NS = "__metrics__"
_FLUSH_INTERVAL_S = 1.0


class _Registry:
    def __init__(self):
        self._metrics: Dict[str, "Metric"] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def register(self, m: "Metric"):
        with self._lock:
            self._metrics[m.name] = m
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True
                )
                self._thread.start()

    def _flush_loop(self):
        while True:
            time.sleep(_FLUSH_INTERVAL_S)
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - cluster may be down
                pass

    def flush(self):
        from .._private.worker import global_client, is_initialized

        if not is_initialized():
            return
        with self._lock:
            payload = {
                name: m._dump() for name, m in self._metrics.items()
            }
        key = f"proc_{os.getpid()}".encode()
        global_client().kv_put(
            key, json.dumps(payload).encode(), ns=_NS
        )


_registry = _Registry()


class Metric:
    kind = "metric"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._series: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def _dump(self):
        with self._lock:
            return {
                "kind": self.kind,
                "description": self.description,
                "series": [
                    {"tags": dict(k), "value": v}
                    for k, v in self._series.items()
                ],
            }


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._series[self._key(tags)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        self.boundaries = sorted(boundaries or [0.1, 1, 10, 100, 1000])
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1)
            )
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._series[key] = self._sums[key]  # sum as scalar series

    def _dump(self):
        with self._lock:
            return {
                "kind": self.kind,
                "description": self.description,
                "boundaries": self.boundaries,
                "series": [
                    {
                        "tags": dict(k),
                        "sum": self._sums.get(k, 0.0),
                        "counts": c,
                    }
                    for k, c in self._counts.items()
                ],
            }


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return ("_" + s) if s and s[0].isdigit() else s


def _escape_label_value(v) -> str:
    # Exposition format: label values escape backslash, double-quote
    # AND newline (a raw newline splits the sample line and corrupts
    # the whole scrape).
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(tags: Dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(
        f'{_prom_name(k)}="{_escape_label_value(v)}"'
        for k, v in sorted(tags.items())
    )
    return "{" + inner + "}"


def prometheus_text(snapshot: Dict[str, Dict]) -> str:
    """Render a metrics snapshot in the Prometheus text exposition
    format (reference: the node metrics agent's OpenCensus→Prometheus
    exporter, _private/metrics_agent.py; format spec:
    prometheus.io/docs/instrumenting/exposition_formats)."""
    lines: List[str] = []
    for name, dump in sorted(snapshot.items()):
        pname = _prom_name(name)
        kind = dump.get("kind", "gauge")
        prom_type = {"counter": "counter", "histogram": "histogram"}.get(
            kind, "gauge"
        )
        if dump.get("description"):
            desc = dump["description"].replace("\n", " ")
            lines.append(f"# HELP {pname} {desc}")
        lines.append(f"# TYPE {pname} {prom_type}")
        if kind == "histogram":
            bounds = dump.get("boundaries", [])
            for s in dump.get("series", []):
                tags = s.get("tags", {})
                counts = s.get("counts", [])
                cum = 0
                for b, c in zip(bounds, counts):
                    cum += c
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels({**tags, 'le': repr(float(b))})}"
                        f" {cum}"
                    )
                total = sum(counts)
                lines.append(
                    f"{pname}_bucket{_prom_labels({**tags, 'le': '+Inf'})}"
                    f" {total}"
                )
                lines.append(
                    f"{pname}_sum{_prom_labels(tags)} {s.get('sum', 0.0)}"
                )
                lines.append(f"{pname}_count{_prom_labels(tags)} {total}")
        else:
            for s in dump.get("series", []):
                lines.append(
                    f"{pname}{_prom_labels(s.get('tags', {}))}"
                    f" {s.get('value', 0.0)}"
                )
    return "\n".join(lines) + "\n"


def core_runtime_snapshot() -> Dict[str, Dict]:
    """Built-in runtime series computed live at scrape time (reference:
    stats/metric_defs.cc — tasks/actors/nodes/object-store gauges),
    merged into /metrics beside user-defined metrics."""
    from .._private.worker import global_client
    from . import state as state_api

    client = global_client()
    info = client.cluster_info()
    out: Dict[str, Dict] = {}

    def gauge(name, desc, series):
        out[name] = {"kind": "gauge", "description": desc, "series": series}

    gauge(
        "ray_tpu_torch_resources_total",
        "cluster total resources by kind",
        [
            {"tags": {"resource": k}, "value": v}
            for k, v in info["total"].items()
        ],
    )
    gauge(
        "ray_tpu_torch_resources_available",
        "cluster available resources by kind",
        [
            {"tags": {"resource": k}, "value": v}
            for k, v in info["available"].items()
        ],
    )
    gauge(
        "ray_tpu_torch_nodes_alive",
        "alive cluster nodes",
        [{"tags": {}, "value": sum(1 for n in info["nodes"] if n["alive"])}],
    )
    workers = state_api.list_workers(limit=10_000)
    by_state: Dict[str, int] = {}
    for w in workers:
        by_state[w.get("state", "?")] = by_state.get(w.get("state", "?"), 0) + 1
    gauge(
        "ray_tpu_torch_workers",
        "workers by state",
        [
            {"tags": {"state": s}, "value": c}
            for s, c in sorted(by_state.items())
        ],
    )
    tasks = state_api.summarize_tasks()
    by_state: Dict[str, int] = {}
    for states in tasks.get("by_func_name", {}).values():
        for s, c in states.items():
            by_state[s] = by_state.get(s, 0) + c
    # Gauge, not counter: per-state counts shrink as tasks transition
    # (RUNNING falls on every completion), and a shrinking counter
    # reads as a reset to Prometheus rate().
    out["ray_tpu_torch_tasks"] = {
        "kind": "gauge",
        "description": "task events by state",
        "series": [
            {"tags": {"state": s}, "value": c}
            for s, c in sorted(by_state.items())
        ],
    }
    counts = client.request({"type": "msg_counts"}).get("counts", {})
    out["ray_tpu_torch_control_messages"] = {
        "kind": "counter",
        "description": "head control-plane messages by type",
        "series": [
            {"tags": {"type": t}, "value": c}
            for t, c in sorted(counts.items())
        ],
    }
    out.update(flight_recorder_snapshot(client))
    return out


def flight_recorder_snapshot(client=None) -> Dict[str, Dict]:
    """Derived flight-recorder series (events.py aggregator): per-phase
    task latency histograms, event/drop counters, live pending-queue
    depth. Drops are the load-bearing series — ring overflow is counted
    at the source and summed here, never silently lost."""
    if client is None:
        from .._private.worker import global_client

        client = global_client()
    reply = client.request({"type": "events_summary"})
    if not reply.get("ok"):
        return {}
    s = reply["summary"]
    out: Dict[str, Dict] = {}
    out["ray_tpu_torch_pending_tasks"] = {
        "kind": "gauge",
        "description": "tasks in the head scheduling queue",
        "series": [{"tags": {}, "value": s.get("queue_depth", 0)}],
    }
    out["ray_tpu_torch_pending_scheduling_classes"] = {
        "kind": "gauge",
        "description": "distinct scheduling classes with queued tasks",
        "series": [{"tags": {}, "value": s.get("queue_classes", 0)}],
    }
    out["ray_tpu_torch_flight_recorder_events_total"] = {
        "kind": "counter",
        "description": "flight-recorder transitions ingested by category",
        "series": [
            {"tags": {"category": c}, "value": n}
            for c, n in sorted(s.get("totals", {}).items())
        ],
    }
    # Always emit at least one sample so "no drops" is an observable 0,
    # not an absent series.
    drops = s.get("drops", {}) or {"": 0}
    out["ray_tpu_torch_flight_recorder_dropped_total"] = {
        "kind": "counter",
        "description": "flight-recorder events dropped (ring overflow "
        "+ retention eviction) by source",
        "series": [
            {"tags": {"source": src} if src else {}, "value": n}
            for src, n in sorted(drops.items())
        ],
    }
    out["ray_tpu_torch_task_phase_seconds"] = {
        "kind": "histogram",
        "description": "per-phase task latency "
        "(submit/queue/lease/fork/exec/seal)",
        "boundaries": list(s.get("phase_boundaries", [])),
        "series": [
            {
                "tags": {"phase": p},
                "sum": s.get("phase_sums", {}).get(p, 0.0),
                "counts": c,
            }
            for p, c in sorted(s.get("phase_counts", {}).items())
        ],
    }
    return out


def get_metrics_snapshot() -> Dict[str, Dict]:
    """Aggregate every process's published metrics from the GCS KV.

    Series from different processes that share a metric name AND tag
    set are MERGED (summed; histograms element-wise) — the Prometheus
    exposition format forbids duplicate samples for one labelset, and
    "total across processes" is the useful cluster-level reading
    (reference: the metrics agent aggregates per-worker streams the
    same way before export)."""
    from .._private.worker import global_client

    client = global_client()
    _registry.flush()
    out: Dict[str, Dict] = {}
    for key in client.kv_keys(b"", ns=_NS):
        blob = client.kv_get(key, ns=_NS)
        if not blob:
            continue
        for name, dump in json.loads(blob).items():
            slot = out.setdefault(
                name,
                {
                    "kind": dump["kind"],
                    "description": dump["description"],
                    "series": [],
                    "_by_tags": {},
                },
            )
            if "boundaries" in dump:
                slot["boundaries"] = dump["boundaries"]
            for s in dump.get("series", []):
                tkey = tuple(sorted((s.get("tags") or {}).items()))
                prev = slot["_by_tags"].get(tkey)
                if prev is None:
                    slot["_by_tags"][tkey] = merged = dict(s)
                    slot["series"].append(merged)
                elif "counts" in s:  # histogram: element-wise
                    prev["sum"] = prev.get("sum", 0.0) + s.get("sum", 0.0)
                    pc, sc = prev.get("counts", []), s.get("counts", [])
                    prev["counts"] = [
                        a + b
                        for a, b in zip(pc, sc)
                    ] if len(pc) == len(sc) else (pc or sc)
                else:
                    prev["value"] = prev.get("value", 0.0) + s.get(
                        "value", 0.0
                    )
    for slot in out.values():
        slot.pop("_by_tags", None)
    return out
