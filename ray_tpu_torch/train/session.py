"""Per-worker training session.

Reference: train/_internal/session.py — _TrainSession :110, report()
:402. The worker's train loop calls `ray_tpu_torch.train.report(metrics,
checkpoint=...)`; results flow through a queue the trainer drains,
epoch-synchronized across the worker group.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

_session_lock = threading.Lock()
_session: Optional["TrainSession"] = None


@dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    node_rank: int
    experiment_name: str
    storage_path: Optional[str]


class TrainSession:
    def __init__(self, context: TrainContext):
        self.context = context
        self.result_queue: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any], checkpoint=None):
        self.result_queue.put(("report", metrics, checkpoint))

    def finish(self, error: Optional[BaseException] = None):
        self.error = error
        self.finished.set()
        self.result_queue.put(("done", None, None))

    def next_result(self, timeout: Optional[float] = None):
        return self.result_queue.get(timeout=timeout)


def init_session(context: TrainContext) -> TrainSession:
    global _session
    with _session_lock:
        _session = TrainSession(context)
        return _session


def get_session() -> Optional[TrainSession]:
    return _session


def report(metrics: Dict[str, Any], *, checkpoint=None) -> None:
    """Reference: ray.train.report — every worker must call it the same
    number of times; rank-0's checkpoint is persisted."""
    s = get_session()
    if s is None:
        raise RuntimeError("report() called outside a train session")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = get_session()
    if s is None:
        raise RuntimeError("get_context() called outside a train session")
    return s.context
