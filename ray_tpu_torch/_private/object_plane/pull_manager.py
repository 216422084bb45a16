"""Admission-controlled pull manager: the node-level front of the
object transfer plane.

Reference: src/ray/object_manager/pull_manager.h:52 — pull requests are
prioritized get > wait > task-argument (FIFO within a class) and only
activate while their total object bytes fit an in-flight budget; a
completed, failed, or cancelled pull releases its budget and activates
the next queued request. That admission control is what keeps a bulk
broadcast (a learner fanning weights out to hundreds of rollout actors)
from starving concurrent small ``ray.get``\\ s: the broadcast's chunk
train queues object-by-object while gets jump ahead the moment budget
frees.

This manager fronts :class:`~..object_transfer.ObjectFetcher` in every
process that pulls (drivers and workers — each process is its own
admission domain over the shared node pool):

- requests enter a priority queue keyed ``(class, seq)``;
- a request activates only while ``in_flight_bytes + size`` fits the
  effective budget (``pull_in_flight_bytes``, default a quarter of the
  node pool), **demoted** to the pool's current free space when the
  store shrinks under spill pressure so pulls don't land on a pool the
  spill rung is actively draining;
- one oversized request may run alone (liveness: an object larger than
  the whole budget must still be fetchable) — flagged ``solo`` in its
  activation event;
- concurrent pulls of one object dedup here: followers ride the active
  leader without charging budget;
- ``cancel`` (ref-drop, explicit free) removes queued requests and
  frees their budget share immediately.

Every transition records a REFS flight-recorder event (PULL_QUEUED /
PULL_ACTIVATE / PULL_DONE / PULL_CANCEL) — the pressure_soak scenario
asserts the budget invariant straight from those events — and feeds
Prometheus gauges (per-class queue depth, in-flight bytes).
"""
from __future__ import annotations

import heapq
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from .. import events as _events

#: Priority classes, highest first (reference: pull_manager.h). The
#: wait class is currently RESERVED: ray.wait in this runtime is
#: push-based readiness and never fetches object data, so no product
#: path runs at PULL_WAIT yet — it exists to mirror the reference's
#: ordering and for a future fetch_local wait.
PULL_GET, PULL_WAIT, PULL_TASK_ARGS = 0, 1, 2
CLASS_NAMES = {PULL_GET: "get", PULL_WAIT: "wait", PULL_TASK_ARGS: "task_args"}

#: Request states.
_QUEUED, _ACTIVE, _CANCELLED, _TIMED_OUT = range(4)

# Per-thread pull class (set by the worker runtime around task-argument
# resolution — same idiom as events.set_task_context). Thread-local,
# not a contextvar: the gets that pull run on the thread resolving the
# args.
_ctx = threading.local()


@contextmanager
def pull_class(cls: int):
    """Scope the calling thread's pulls to a priority class."""
    prev = getattr(_ctx, "pull_class", None)
    _ctx.pull_class = cls
    try:
        yield
    finally:
        _ctx.pull_class = prev


def current_pull_class() -> int:
    cls = getattr(_ctx, "pull_class", None)
    return PULL_GET if cls is None else cls


class _Request:
    __slots__ = ("oid", "size", "cls", "seq", "state", "charge")

    def __init__(self, oid: bytes, size: int, cls: int, seq: int):
        self.oid = oid
        self.size = size
        self.cls = cls
        self.seq = seq
        self.state = _QUEUED
        self.charge = max(int(size), 1)


class _ActivePull:
    """One in-flight object: the leader fetches, followers wait."""

    __slots__ = ("charge", "done", "ok", "t0")

    def __init__(self, charge: int):
        self.charge = charge
        self.done = threading.Event()
        self.ok = False
        self.t0 = time.monotonic()


class PullManager:
    def __init__(self, fetcher, store=None,
                 budget_bytes: Optional[int] = None):
        """``budget_bytes`` overrides the config/auto budget (tests);
        ``store`` supplies pool stats for the auto budget and the
        spill-pressure demotion."""
        self._fetcher = fetcher
        self._store = store
        self._budget_override = budget_bytes
        self._cond = threading.Condition()
        self._seq = 0
        #: Min-heap of (cls, seq, request) — FIFO within class.
        self._heap: List[tuple] = []
        self._queued_per_class: Dict[int, int] = {}
        self._active: Dict[bytes, _ActivePull] = {}
        self._in_flight_bytes = 0
        self._closed = False
        # Pool stats are a ctypes call; cache briefly so a get storm
        # doesn't pay one per admission decision.
        self._pool_cache = (0.0, 0, 0)  # (stamp, size, in_use)
        self._gauges = None

    # ------------------------------------------------------------- budget

    def effective_budget(self) -> int:
        """Current admission budget in bytes. The configured budget,
        demoted to the pool's free space while the store runs hot
        (spill pressure must drain the pool, not race new pulls into
        it) — floored at one transfer chunk so the plane always moves."""
        from ..object_transfer import CHUNK_BYTES
        from ..config import RayConfig

        base = self._budget_override
        if base is None:
            base = int(RayConfig.pull_in_flight_bytes)
        pool_size, in_use = self._pool_stats()
        if not base:
            base = max(4 * CHUNK_BYTES, pool_size // 4) if pool_size \
                else 256 << 20
        if pool_size:
            free = max(0, pool_size - in_use)
            return max(CHUNK_BYTES, min(base, free))
        return base

    def _pool_stats(self):
        pool = getattr(self._store, "_pool", None) if self._store else None
        if pool is None:
            return 0, 0
        now = time.monotonic()
        stamp, size, in_use = self._pool_cache
        if now - stamp < 0.05:
            return size, in_use
        try:
            st = pool.stats()
            size = st.get("pool_size") or st.get("arena_size") or 0
            in_use = st.get("bytes_in_use", 0)
        except Exception:  # noqa: BLE001 - store mid-close
            size, in_use = 0, 0
        self._pool_cache = (now, size, in_use)
        return size, in_use

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        with self._cond:
            out = {
                "in_flight_bytes": self._in_flight_bytes,
                "active": len(self._active),
                "budget": self.effective_budget(),
            }
            for cls, name in CLASS_NAMES.items():
                out[f"queued_{name}"] = self._queued_per_class.get(cls, 0)
        return out

    def _update_gauges_locked(self) -> None:
        """Per-class queue depth + in-flight bytes Prometheus gauges
        (published through util.metrics' per-process KV flush). Lazy:
        processes that never pull pay nothing."""
        try:
            if self._gauges is None:
                from ...util.metrics import Gauge

                self._gauges = (
                    Gauge(
                        "ray_tpu_torch_pull_queue_depth",
                        "queued pull requests by priority class",
                        tag_keys=("pull_class",),
                    ),
                    Gauge(
                        "ray_tpu_torch_pull_in_flight_bytes",
                        "total bytes of admitted in-flight pulls",
                    ),
                )
            depth, in_flight = self._gauges
            for cls, name in CLASS_NAMES.items():
                depth.set(
                    self._queued_per_class.get(cls, 0),
                    {"pull_class": name},
                )
            in_flight.set(self._in_flight_bytes)
        except Exception:  # noqa: BLE001 - metrics must never break pulls
            self._gauges = None

    # --------------------------------------------------------------- pull

    def pull(self, oid, address: str, size: int = 0,
             priority: Optional[int] = None,
             timeout: Optional[float] = 60.0,
             resolve=None) -> bool:
        """Admission-gated fetch of ``oid`` from ``address`` into the
        local store. Blocks until the request activates (budget) and the
        underlying chunk pull finishes; False on cancellation, admission
        timeout, or fetch failure. ``timeout`` covers BOTH the queue
        wait and the fetch; None (a patient, deadline-less get) waits
        for admission indefinitely — being parked behind a saturated
        budget is a transient, not a loss — and gives the fetch itself
        the fetcher's usual 60s window. ``size`` is the directory's
        sealed size — the budget charge (0 = unknown, charged as 1
        byte). ``resolve`` (optional) re-leads a below-floor pull onto a
        fresh holder inside the one admitted attempt — the budget is
        charged once, never per re-lead (see ObjectFetcher.pull)."""
        key = oid.binary()
        deadline = None if timeout is None else time.monotonic() + timeout
        cls = current_pull_class() if priority is None else priority
        rec = _events.get_recorder()
        with self._cond:
            leader = self._active.get(key)
            if leader is None:
                req = self._enqueue_locked(key, size, cls, rec)
                while req.state == _QUEUED:
                    remaining = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if (
                        remaining is not None and remaining <= 0
                    ) or self._closed:
                        req.state = _TIMED_OUT
                        self._queued_per_class[cls] = max(
                            0, self._queued_per_class.get(cls, 0) - 1
                        )
                        self._update_gauges_locked()
                        return False
                    self._cond.wait(remaining)
                if req.state != _ACTIVE:
                    return False
                leader = self._active[key]
                is_leader = True
            else:
                is_leader = False
        if not is_leader:
            # Dedup: ride the active pull; no budget charge, no wire
            # traffic (reference: PullManager dedup of concurrent
            # requests for one object).
            leader.done.wait(
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            return self._store.contains(oid) if self._store else leader.ok
        ok = False
        try:
            ok = self._fetcher.pull(
                oid, address,
                timeout=(
                    60.0 if deadline is None
                    else max(0.1, deadline - time.monotonic())
                ),
                resolve=resolve,
            )
        finally:
            self._release(key, leader, ok, rec)
        return ok

    def _enqueue_locked(self, key: bytes, size: int, cls: int,
                        rec) -> _Request:
        self._seq += 1
        req = _Request(key, size, cls, self._seq)
        heapq.heappush(self._heap, (cls, req.seq, req))
        self._queued_per_class[cls] = self._queued_per_class.get(cls, 0) + 1
        if rec.enabled:
            rec.record(
                _events.REFS, _hex12(key), "PULL_QUEUED",
                {
                    "cls": CLASS_NAMES.get(cls, cls), "bytes": size,
                    "depth": len(self._heap),
                },
            )
        self._maybe_activate_locked(rec)
        return req

    def _release(self, key: bytes, active: _ActivePull, ok: bool,
                 rec) -> None:
        with self._cond:
            if self._active.get(key) is active:
                del self._active[key]
            self._in_flight_bytes -= active.charge
            active.ok = ok
            active.done.set()
            if rec.enabled:
                rec.record(
                    _events.REFS, _hex12(key), "PULL_DONE",
                    {
                        "ok": ok, "in_flight": self._in_flight_bytes,
                        "seconds": round(time.monotonic() - active.t0, 6),
                    },
                )
            self._maybe_activate_locked(rec)
            self._cond.notify_all()

    def _maybe_activate_locked(self, rec) -> None:
        budget = self.effective_budget()
        while self._heap:
            cls, _seq, req = self._heap[0]
            if req.state != _QUEUED:
                heapq.heappop(self._heap)  # cancelled/timed out: discard
                continue
            if req.oid in self._active:
                # An earlier request for the same object is mid-flight:
                # this one resolves as a follower once it completes —
                # re-queue behind the release (cheap: the release's
                # activation pass re-examines it).
                break
            solo = not self._active
            if not solo and self._in_flight_bytes + req.charge > budget:
                break  # head-of-line waits for budget; FIFO within class
            heapq.heappop(self._heap)
            self._queued_per_class[cls] = max(
                0, self._queued_per_class.get(cls, 0) - 1
            )
            active = _ActivePull(req.charge)
            self._active[req.oid] = active
            self._in_flight_bytes += req.charge
            req.state = _ACTIVE
            if rec.enabled:
                attrs = {
                    "cls": CLASS_NAMES.get(cls, cls), "bytes": req.size,
                    "in_flight": self._in_flight_bytes, "budget": budget,
                }
                # Flag from the ADMISSION MODE, not the post-hoc
                # in_flight-vs-budget comparison: a buggy over-admission
                # of a non-solo request must show up as an unflagged
                # overrun (the pressure soak asserts exactly that), not
                # be self-excused by the overrun it caused.
                if solo and self._in_flight_bytes > budget:
                    attrs["solo"] = True  # oversize liveness admission
                rec.record(
                    _events.REFS, _hex12(req.oid), "PULL_ACTIVATE", attrs
                )
        self._update_gauges_locked()
        self._cond.notify_all()

    # ------------------------------------------------------------- cancel

    def cancel(self, oid_bytes: bytes) -> int:
        """Drop queued pulls for an object whose last ref died; their
        budget share frees immediately (active pulls run out — their
        release frees budget the normal way). Returns requests
        cancelled."""
        rec = _events.get_recorder()
        n = 0
        with self._cond:
            for _cls, _seq, req in self._heap:
                if req.oid == oid_bytes and req.state == _QUEUED:
                    req.state = _CANCELLED
                    self._queued_per_class[req.cls] = max(
                        0, self._queued_per_class.get(req.cls, 0) - 1
                    )
                    n += 1
                    if rec.enabled:
                        rec.record(
                            _events.REFS, _hex12(oid_bytes), "PULL_CANCEL",
                            {"cls": CLASS_NAMES.get(req.cls, req.cls)},
                        )
            if n:
                self._maybe_activate_locked(rec)
                self._cond.notify_all()
        return n

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def _hex12(key: bytes) -> str:
    return key.hex()[:12]
