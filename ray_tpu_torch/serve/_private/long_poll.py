"""Long-poll config propagation (reference: serve/_private/long_poll.py
LongPollHost:173 / LongPollClient:64).

The host lives inside the controller. Clients (routers, proxies) call
``listen_for_change(snapshot_ids)`` — an async actor method that parks
until any watched key advances past the caller's snapshot id, then
returns the changed key→(snapshot_id, object) map. This turns config
distribution into O(changes), not O(polls).
"""
from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, Dict, Optional, Tuple

LISTEN_TIMEOUT_S = 30.0


class LongPollHost:
    def __init__(self):
        self._snapshot_ids: Dict[str, int] = {}
        self._objects: Dict[str, Any] = {}
        self._event = asyncio.Event()

    def notify_changed(self, updates: Dict[str, Any]) -> None:
        for key, obj in updates.items():
            self._snapshot_ids[key] = self._snapshot_ids.get(key, 0) + 1
            self._objects[key] = obj
        # Wake all parked listeners; each re-checks its own keys.
        self._event.set()
        self._event = asyncio.Event()

    def _changes_for(self, snapshot_ids: Dict[str, int]) -> Dict[str, Tuple[int, Any]]:
        out = {}
        for key, client_id in snapshot_ids.items():
            cur = self._snapshot_ids.get(key, 0)
            if cur > client_id and key in self._objects:
                out[key] = (cur, self._objects[key])
        return out

    async def listen_for_change(
        self, snapshot_ids: Dict[str, int]
    ) -> Dict[str, Tuple[int, Any]]:
        changes = self._changes_for(snapshot_ids)
        if changes:
            return changes
        event = self._event
        try:
            await asyncio.wait_for(event.wait(), timeout=LISTEN_TIMEOUT_S)
        except asyncio.TimeoutError:
            return {}
        return self._changes_for(snapshot_ids)


class LongPollClient:
    """Runs a poll loop on a daemon thread; invokes ``callbacks[key]``
    with the new object whenever a key changes. The loop ends with the
    session it started in: a runtime shut down without ``serve.shutdown()``
    leaves no poller calling into the process's next session (the
    reference's poller dies with its core worker)."""

    def __init__(
        self,
        controller_handle,
        callbacks: Dict[str, Callable[[Any], None]],
    ):
        from ..._private.worker import current_session

        self._controller = controller_handle
        self._callbacks = callbacks
        self._snapshot_ids = {k: 0 for k in callbacks}
        self._stopped = threading.Event()
        self._session = current_session()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        from ... import get
        from ..._private.worker import current_session

        while not self._stopped.is_set():
            if current_session() is not self._session:
                return
            try:
                changes = get(
                    self._controller.listen_for_change.remote(self._snapshot_ids),
                    timeout=LISTEN_TIMEOUT_S + 10.0,
                )
            except Exception:
                if self._stopped.is_set():
                    return
                self._stopped.wait(0.5)
                continue
            for key, (snapshot_id, obj) in changes.items():
                self._snapshot_ids[key] = snapshot_id
                try:
                    self._callbacks[key](obj)
                except Exception:  # noqa: BLE001 - callbacks must not kill the loop
                    pass
