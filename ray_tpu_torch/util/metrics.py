"""User-defined metrics: Counter / Gauge / Histogram.

Reference: python/ray/util/metrics.py — metrics flow through the node's
metrics agent to Prometheus there; here each process publishes its
series into the GCS KV under a reserved namespace, and
``get_metrics_snapshot()`` aggregates
across processes. Tag-based partitioning matches the reference API.
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
