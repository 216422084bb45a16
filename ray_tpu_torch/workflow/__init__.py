"""ray_tpu_torch.workflow: durable, resumable task DAGs.

Reference: python/ray/workflow/ (api.py:123 run, workflow_executor.py,
workflow_storage.py). A workflow executes a DAG of tasks with
every task's output persisted; re-running (``resume``) skips completed
tasks, giving exactly-once semantics across driver crashes.
"""
from __future__ import annotations

from .events import get_event, post_event, wait_for_event  # noqa: F401
from .api import (  # noqa: F401
    cancel,
    delete,
    get_output,
    get_status,
    init,
    list_all,
    resume,
    run,
    run_async,
)

__all__ = [
    "cancel",
    "get_event",
    "post_event",
    "wait_for_event",
    "delete",
    "get_output",
    "get_status",
    "init",
    "list_all",
    "resume",
    "run",
    "run_async",
]

from ray_tpu_torch._private import usage_stats as _usage

_usage.record_library_usage("workflow")
