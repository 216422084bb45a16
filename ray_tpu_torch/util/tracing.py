"""Tracing: span context propagated through task submission.

Reference: util/tracing/tracing_helper.py:36-82 — OpenTelemetry spans
injected around _remote calls with context carried in the TaskSpec.
Zero-dependency equivalent: when RAY_TPU_TORCH_TRACE=1, submissions stamp a
(trace_id, parent span) into the runtime_env env_vars and executions
record spans; spans export through the GCS KV and assemble into one
chrome-trace / parent-child tree with ``get_trace`` or
``ray_tpu_torch.timeline()`` (task events already cover execution timing —
this adds cross-task causality).
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional

_NS = "__traces__"
_TRACE_ENV = "RAY_TPU_TORCH_TRACE_CTX"


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_TRACE", "0") == "1"


def current_context() -> Optional[Dict[str, str]]:
    blob = os.environ.get(_TRACE_ENV)
    return json.loads(blob) if blob else None


def new_context(name: str) -> Dict[str, str]:
    parent = current_context()
    return {
        "trace_id": parent["trace_id"] if parent else uuid.uuid4().hex[:16],
        "span_id": uuid.uuid4().hex[:8],
        "parent_span_id": parent["span_id"] if parent else "",
        "name": name,
    }


def inject(runtime_env: Optional[Dict[str, Any]], task_name: str):
    """Called at submission: thread the span context into the task's
    env so the worker's execution becomes a child span."""
    if not enabled():
        return runtime_env
    ctx = new_context(task_name)
    runtime_env = dict(runtime_env or {})
    env_vars = dict(runtime_env.get("env_vars") or {})
    env_vars[_TRACE_ENV] = json.dumps(ctx)
    env_vars["RAY_TPU_TORCH_TRACE"] = "1"
    runtime_env["env_vars"] = env_vars
    return runtime_env


def record_span(name: str, start: float, end: float,
                ctx: Optional[Dict[str, str]] = None) -> None:
    if not enabled():
        return
    from .._private.worker import global_client, is_initialized

    if not is_initialized():
        return
    ctx = ctx or current_context() or new_context(name)
    span = {
        "name": name,
        "trace_id": ctx["trace_id"],
        "span_id": ctx["span_id"],
        "parent_span_id": ctx.get("parent_span_id", ""),
        "start": start,
        "end": end,
        "pid": os.getpid(),
    }
    global_client().kv_put(
        f"{ctx['trace_id']}:{ctx['span_id']}".encode(),
        json.dumps(span).encode(),
        ns=_NS,
    )


class span:
    """Context manager for user code: ``with tracing.span("step"): ...``"""

    def __init__(self, name: str):
        self.name = name
        self._ctx = None
        self._start = 0.0
        self._saved = None

    def __enter__(self):
        self._ctx = new_context(self.name)
        self._start = time.time()
        self._saved = os.environ.get(_TRACE_ENV)
        os.environ[_TRACE_ENV] = json.dumps(self._ctx)
        return self

    def __exit__(self, *exc):
        record_span(self.name, self._start, time.time(), self._ctx)
        if self._saved is None:
            os.environ.pop(_TRACE_ENV, None)
        else:
            os.environ[_TRACE_ENV] = self._saved
        return False


def get_trace(trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """All spans (optionally one trace), sorted by start time."""
    from .._private.worker import global_client

    client = global_client()
    spans = []
    prefix = f"{trace_id}:".encode() if trace_id else b""
    for key in client.kv_keys(prefix, ns=_NS):
        blob = client.kv_get(key, ns=_NS)
        if blob:
            spans.append(json.loads(blob))
    return sorted(spans, key=lambda s: s["start"])
