"""Distributed reference counting: client-side instance tracking.

Reference: src/ray/core_worker/reference_count.h:61 — every process
counts the ObjectRef instances it holds; the cluster-level view decides
when an object's memory can be reclaimed.

Two implementations share this module's track()/untrack() hooks:

- :class:`~.object_plane.owner_refs.OwnerRefTracker` (the default for
  in-cluster clients, re-exported here as ``RefTracker``): owner-side
  counting — the process that created an object keeps the
  authoritative holder/borrow state and batches only ownership-edge
  transitions to the head (see object_plane/).

- :class:`LegacyRefTracker`: the original centralized variant — every
  client batches its local 0<->1 transitions as ``update_refs``
  holder add/removes. Kept for transports whose peer interprets the
  wire messages itself (the ray_tpu_torch:// client proxy translates
  adds/removes into session-held refs) and as the documented
  head-fallback semantics for ownerless objects.

Python refcounting does the heavy lifting: ObjectRef.__init__ calls
track(), __del__ calls untrack(); only the edges cross the wire,
batched on a flusher thread.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Set

from .object_plane.owner_refs import (  # noqa: F401 - re-exports
    FLUSH_INTERVAL_S,
    OwnerRefTracker,
)

# The default tracker for CoreClient processes.
RefTracker = OwnerRefTracker

_current = None


def set_current(tracker) -> None:
    global _current
    _current = tracker


def track(oid: bytes, owner: bytes = b"") -> None:
    t = _current
    if t is not None:
        t.incr(oid, owner)


def untrack(oid: bytes) -> None:
    t = _current
    if t is not None:
        t.decr(oid)


class LegacyRefTracker:
    """Centralized variant: batches 0<->1 holder transitions to the
    connected peer as ``update_refs`` messages."""

    def __init__(self, client):
        # weakref: the tracker thread must not keep a closed client alive.
        self._client = weakref.ref(client)
        self._counts: Dict[bytes, int] = {}
        self._dirty: Set[bytes] = set()
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stopped = False
        # oids whose local count hit zero; the client drops lineage for
        # them at flush time.
        self._zeroed: Set[bytes] = set()
        # oids whose presence we have ADVERTISED to the GCS. A remove is
        # only valid after its add: a ref held and dropped within one
        # flush window must send NOTHING — a bare remove from a client
        # the directory never saw holding would race ahead of the real
        # owner's still-batched add and free a live object (the
        # intermittent cross-worker arg-resolution hang).
        self._advertised: Set[bytes] = set()

    def incr(self, oid: bytes, owner: bytes = b"") -> None:
        with self._lock:
            n = self._counts.get(oid, 0) + 1
            self._counts[oid] = n
            if n == 1:
                if not self._dirty:
                    self._wake.set()
                self._dirty.add(oid)
                self._zeroed.discard(oid)
                self._ensure_flusher()

    def decr(self, oid: bytes) -> None:
        with self._lock:
            n = self._counts.get(oid, 0) - 1
            if n <= 0:
                self._counts.pop(oid, None)
                if not self._dirty:
                    self._wake.set()
                self._dirty.add(oid)
                self._zeroed.add(oid)
            else:
                self._counts[oid] = n

    def holds(self, oid: bytes) -> bool:
        with self._lock:
            return self._counts.get(oid, 0) > 0

    def mark_advertised(self, oid: bytes) -> None:
        """The directory already records this client as a holder (e.g.
        put_object registers the putter) — the eventual drop must send
        its remove."""
        with self._lock:
            self._advertised.add(oid)

    def forget(self, oids) -> None:
        """Explicitly freed oids: drop local bookkeeping (API parity
        with OwnerRefTracker)."""
        with self._lock:
            for oid in oids:
                self._counts.pop(oid, None)
                self._advertised.discard(oid)
                self._dirty.discard(oid)
                self._zeroed.discard(oid)

    def _ensure_flusher(self):
        if self._flusher is None and not self._stopped:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="ref-flusher", daemon=True
            )
            self._flusher.start()

    def _flush_loop(self):
        import time

        # Park while clean: an idle process's tracker must cost zero
        # wakeups (per-process polling timers were the many-actor scale
        # bottleneck). incr/decr arm the event on the empty->dirty edge;
        # the interval sleep then batches the burst.
        while not self._stopped:
            self._wake.wait()
            if self._stopped:
                return
            time.sleep(FLUSH_INTERVAL_S)
            self._wake.clear()
            client = self._client()
            if client is None:
                return
            if client.conn.closed:
                # Head outage: if a failover reconnect may still land,
                # stay alive — the re-dirtied edges flush after the
                # swap (mirrors OwnerRefTracker._flush_loop).
                if getattr(
                    client, "conn_failover_pending", lambda: False
                )():
                    self._wake.set()
                    time.sleep(FLUSH_INTERVAL_S)
                    continue
                return
            self.flush(client)

    def flush(self, client) -> None:
        """Send the net presence change per dirty oid (idempotent set
        semantics server-side, so transient 1->0->1 flaps are safe)."""
        with self._lock:
            if not self._dirty:
                return
            dirty, self._dirty = self._dirty, set()
            add = [oid for oid in dirty if self._counts.get(oid, 0) > 0]
            remove = [
                oid
                for oid in dirty
                if self._counts.get(oid, 0) <= 0 and oid in self._advertised
            ]
            # adds may include oids the head already records (re-adds
            # are idempotent); the ConnectionLost revert below must
            # only un-advertise what THIS flush newly advertised, or a
            # pre-advertised oid's eventual remove would be suppressed
            # and the head would keep a phantom holder forever.
            newly_advertised = [
                oid for oid in add if oid not in self._advertised
            ]
            self._advertised.update(add)
            self._advertised.difference_update(remove)
            zeroed, self._zeroed = self._zeroed, set()
        if zeroed:
            for oid in zeroed:
                client._lineage.pop(oid, None)
            client._wait_prune(zeroed)
        if not add and not remove:
            return
        from .protocol import ConnectionLost

        try:
            # raylint: disable=raw-send-on-gcs-path -- reverted and re-dirtied on ConnectionLost below; the next flush after a failover resends (idempotent 0/1 set semantics head-side)
            client.conn.send(
                {
                    "type": "update_refs",
                    "client": client.worker_id.binary(),
                    "add": add,
                    "remove": remove,
                }
            )
        except ConnectionLost:
            with self._lock:
                # The head never saw this batch: revert the advertised
                # state (only the edges this flush introduced) and
                # re-dirty the oids so a flush on a future reconnected
                # transport re-sends the edges instead of losing them
                # (swallowed-ConnectionLost bug class).
                self._advertised.difference_update(newly_advertised)
                self._advertised.update(remove)
                self._dirty.update(add)
                self._dirty.update(remove)
                # Re-arm the flusher: incr/decr only set the wake on
                # the empty->dirty edge, which can never fire again now
                # that _dirty is non-empty — without this the loop
                # parks in _wake.wait() forever and the re-dirtied
                # edges never resend.
                self._wake.set()
            # CoreClient transports may have a failover landing;
            # transports without the hook (the ray_tpu_torch:// proxy) have
            # no reconnect story, so the tracker stops as before.
            if not getattr(
                client, "conn_failover_pending", lambda: False
            )():
                self._stopped = True

    def stop(self):
        self._stopped = True
