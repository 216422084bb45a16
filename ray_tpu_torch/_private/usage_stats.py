"""Usage statistics, offline-native (reference:
python/ray/_private/usage/usage_lib.py).

The reference batches cluster metadata + feature-usage tags and POSTs
them to a collector unless disabled. This environment has zero egress,
so the pipeline keeps the reference's *shape* — tag recording, cluster
snapshot, periodic flush, explicit enable/disable — but the sink is a
local JSONL file under the session temp dir that operators inspect.
Nothing ever leaves the machine.

Env toggles (reference parity): RAY_TPU_TORCH_USAGE_STATS_ENABLED=0 disables
recording entirely.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_tags: Dict[str, str] = {}
_features: set = set()
_path: Optional[str] = None


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "False",
    )


def _sink_path() -> Optional[str]:
    global _path
    if _path is not None:
        return _path
    from .config import temp_root

    base = temp_root()
    try:
        os.makedirs(base, exist_ok=True)
        _path = os.path.join(base, "usage_stats.jsonl")
    except OSError:
        _path = None
    return _path


def record_library_usage(library: str) -> None:
    """Mark a library as used this session (reference:
    record_library_usage — called from data/train/tune/serve/rllib
    entry points)."""
    if not enabled():
        return
    with _lock:
        _features.add(library)


def record_extra_usage_tag(key: str, value: str) -> None:
    if not enabled():
        return
    with _lock:
        _tags[key] = str(value)


def cluster_snapshot() -> Dict[str, Any]:
    """Cluster metadata the reference ships in each report."""
    snap: Dict[str, Any] = {
        "ts": time.time(),
        "session": os.environ.get("RAY_TPU_TORCH_NODE_ID", ""),
    }
    try:
        import ray_tpu_torch

        snap["total_resources"] = ray_tpu_torch.cluster_resources()
        snap["num_nodes"] = len(ray_tpu_torch.nodes())
    except Exception:  # noqa: BLE001 - not initialized
        pass
    with _lock:
        snap["libraries"] = sorted(_features)
        snap["tags"] = dict(_tags)
    return snap


def flush() -> Optional[str]:
    """Append one snapshot line to the local sink; returns the path."""
    if not enabled():
        return None
    path = _sink_path()
    if path is None:
        return None
    try:
        with open(path, "a") as f:
            f.write(json.dumps(cluster_snapshot()) + "\n")
    except OSError:
        return None
    return path


def read_all() -> List[Dict[str, Any]]:
    path = _sink_path()
    if path is None or not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
