"""Channelized pubsub over the GCS (reference: src/ray/pubsub/ —
publisher.h per-channel subscriber registries, subscriber.h client
surface). Delivery is push on the process's persistent GCS connection;
callbacks run on the connection's reader thread, so keep them short
(hand off to your own queue/executor for real work).

Built-in channels published by the runtime:
  NODE_INFO  — node joins/deaths: {"state": "ALIVE"|"DEAD", ...}
  ACTOR      — actor lifecycle:   {"state": "ALIVE"|"DEAD", ...}

Arbitrary user channels work too:

    from ray_tpu_torch.util import pubsub
    sub = pubsub.subscribe("my_channel", lambda key, data: print(key, data))
    pubsub.publish("my_channel", "k1", {"x": 1})
    sub.unsubscribe()
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

_lock = threading.Lock()
# channel -> list of (callback, key_prefix)
_subscribers: Dict[str, List[Tuple[Callable, str, "Subscription"]]] = {}
_installed = False


class Subscription:
    def __init__(self, channel: str, callback: Callable, key_prefix: str):
        self.channel = channel
        self._callback = callback
        self._key_prefix = key_prefix

    def unsubscribe(self) -> None:
        from .._private.worker import global_client

        with _lock:
            subs = _subscribers.get(self.channel, [])
            _subscribers[self.channel] = [
                s for s in subs if s[2] is not self
            ]
            empty = not _subscribers[self.channel]
        if empty:
            try:
                global_client().request(
                    {"type": "pubsub_unsubscribe", "channel": self.channel}
                )
            except Exception:  # noqa: BLE001 - cluster may be down
                pass


def _dispatch(msg: Dict[str, Any]) -> None:
    if msg.get("type") != "pubsub":
        return
    with _lock:
        subs = list(_subscribers.get(msg.get("channel", ""), ()))
    for callback, prefix, _ in subs:
        if prefix and not str(msg.get("key", "")).startswith(prefix):
            continue
        try:
            callback(msg.get("key"), msg.get("data"))
        except Exception:  # noqa: BLE001 - user callback must not kill reader
            pass


def _ensure_installed() -> None:
    """Chain our dispatcher onto the process's GCS push handler."""
    global _installed
    if _installed:
        return
    from .._private.worker import global_client

    client = global_client()
    prev = client._push_handler

    def chained(msg):
        _dispatch(msg)
        prev(msg)

    client._push_handler = chained
    _installed = True


def subscribe(
    channel: str,
    callback: Callable[[str, Any], None],
    *,
    key_prefix: str = "",
) -> Subscription:
    """Register a callback for a channel; returns a Subscription handle.
    The server-side registration happens once per (process, channel)."""
    from .._private.worker import global_client

    _ensure_installed()
    sub = Subscription(channel, callback, key_prefix)
    with _lock:
        subs = _subscribers.setdefault(channel, [])
        first = not subs
        subs.append((callback, key_prefix, sub))
    if first:
        global_client().request(
            {"type": "pubsub_subscribe", "channel": channel}
        )
    return sub


def publish(channel: str, key: str = "", data: Any = None) -> None:
    from .._private.worker import global_client

    global_client().request(
        {"type": "pubsub_publish", "channel": channel, "key": key,
         "data": data}
    )


def _reset_for_shutdown() -> None:
    """Called by ray_tpu_torch.shutdown(): the client (and its chained push
    handler) is gone."""
    global _installed
    with _lock:
        _subscribers.clear()
    _installed = False
