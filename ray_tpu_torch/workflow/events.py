"""Workflow event triggers: block a DAG node on an external event.

Reference: python/ray/workflow/http_event_provider.py +
event_listener.py — ``workflow.wait_for_event(...)`` inserts a node
that completes only when an external system posts the event, over HTTP
or from Python. Durability composes with the workflow executor: the
event payload lands in the GCS KV (surviving driver crashes), and once
the wait node completes its result persists like any task, so a resume
neither re-waits nor double-fires downstream work.

    recv = workflow.wait_for_event("order/123")
    final = process.bind(recv)
    workflow.run_async(final, workflow_id="order-123")
    # later, from anywhere (curl / another service):
    #   POST <dashboard>/api/workflow/events/order/123  {"paid": true}
"""
from __future__ import annotations

import json
import time
from typing import Any, Optional

import ray_tpu_torch

EVENTS_NS = "workflow_events"


@ray_tpu_torch.remote(num_cpus=0.01)
def _await_event_task(event_key: str, poll_interval_s: float,
                      timeout_s: Optional[float]):
    from ray_tpu_torch._private.worker import global_client

    client = global_client()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        raw = client.kv_get(event_key.encode(), ns=EVENTS_NS)
        if raw is not None:
            # Consume: an event fires its waiter ONCE. Without this, a
            # recurring key (e.g. "deploy/done") would resolve every
            # future wait instantly with a stale payload. Durability is
            # unaffected: the wait node's result persists in workflow
            # storage the moment it completes.
            client.kv_del(event_key.encode(), ns=EVENTS_NS)
            return json.loads(raw)
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"workflow event {event_key!r} not posted within "
                f"{timeout_s}s"
            )
        time.sleep(poll_interval_s)


def wait_for_event(event_key: str, *, poll_interval_s: float = 0.2,
                   timeout_s: Optional[float] = None):
    """A DAG node resolving to the event's payload once posted.

    Delivery is one-shot: the waiter consumes the key, so reposting
    the same key fires the next waiter. Use one key per waiter (the
    reference couples listeners to workflow ids the same way)."""
    return _await_event_task.bind(event_key, poll_interval_s, timeout_s)


def post_event(event_key: str, payload: Any = None) -> None:
    """Deliver an event from Python (the HTTP provider does the same
    via the dashboard endpoint). Payload must be JSON-serializable."""
    from ray_tpu_torch._private.worker import global_client

    global_client().kv_put(
        event_key.encode(), json.dumps(payload).encode(), ns=EVENTS_NS
    )


def get_event(event_key: str) -> Optional[Any]:
    from ray_tpu_torch._private.worker import global_client

    raw = global_client().kv_get(event_key.encode(), ns=EVENTS_NS)
    return None if raw is None else json.loads(raw)
