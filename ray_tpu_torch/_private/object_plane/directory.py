"""Sharded object directory: the head half of the object plane.

Reference: src/ray/object_manager/ownership_based_object_directory.h —
the directory is consulted per object id, never serialized through one
global table pass. Here the head's object table is split into N shards,
each with its own lock domain and its own refcount flush queue:

- The **facade** (dict-compatible: get/setdefault/pop/items/...) lets
  the GCS handlers keep their existing call sites; each call takes only
  the owning shard's lock, so directory traffic from different handler
  threads stops contending on one structure.

- **Flush queues**: refcount batches (`ref_flush`/legacy `update_refs`)
  are ENQUEUED by the dispatch loop — an O(batch) list append, no
  per-object holder mutation — and applied by one applier thread per
  shard under the shard lock. Appliers nominate free candidates; actual
  freeing re-checks and runs under the GCS lock via ``free_callback``
  (ownership-edge transitions are rare relative to instance churn, so
  this keeps every hot-path mutation off the dispatch loop while frees
  stay coherent with waiter/pin/store state).

- **Early-drop ledger** (per shard): an owner's release can race ahead
  of the worker's batched task_done that creates the entry (the leased
  path advertises return refs client-side only). The ledger remembers
  the release so seal-time reclaims the result instead of leaking it —
  the sharded port of the head's old ``_early_drops``.

Lock order: GCS lock -> shard lock (facade calls under the GCS lock).
Appliers take the shard lock alone, release it, then call the free
callback which takes the GCS lock — never both at once, so the two
domains cannot deadlock.

Test hook: ``GUARD``/``mark_dispatch`` flag the dispatch threads and
wrap entry holder-sets so a test can assert that NO per-object
refcount/holder-set mutation executes on the head dispatch loop.

The same invariant is enforced statically: the raylint thread-domain
rule reads the guarded-attrs declaration below and requires every
mutation of those attributes to sit in a ``# raylint: applier-only``
function (the runtime guard catches what static analysis can't prove;
the lint catches it before it runs).
"""
# raylint: guarded-attrs=holders,owner_released,had_holder
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import events as _events

#: Per-shard bound on remembered early drops (FIFO eviction).
EARLY_DROP_CAP = 2048

#: Per-shard bound on free tombstones (FIFO eviction). A tombstone
#: remembers that an entry was FREED so a late borrow add (or a get)
#: for it cannot resurrect a forever-PENDING ghost — the late holder
#: lands on a LOST entry and the get fails fast instead of wedging
#: (found by the chaos soak: release racing a batched badd).
TOMBSTONE_CAP = 4096

# ---------------------------------------------------------------- guard

#: When True (tests), GCS dispatch threads are flagged via
#: mark_dispatch() and holder-set mutations performed on them are
#: counted into ShardedObjectDirectory.stats["dispatch_mutations"].
GUARD = False

_guard_tl = threading.local()


def mark_dispatch(active: bool) -> None:
    _guard_tl.active = active


def on_dispatch_thread() -> bool:
    return getattr(_guard_tl, "active", False)


class _GuardedHolderSet(set):
    """Holder set that counts mutations made on dispatch threads."""

    __slots__ = ("_stats",)

    def __init__(self, stats, iterable=()):
        super().__init__(iterable)
        self._stats = stats

    def _check(self):
        if on_dispatch_thread():
            self._stats["dispatch_mutations"] += 1

    def add(self, item):
        self._check()
        super().add(item)

    def discard(self, item):
        self._check()
        super().discard(item)

    def remove(self, item):
        self._check()
        super().remove(item)


class _Shard:
    __slots__ = (
        "index", "lock", "entries", "queue", "early_drops",
        "tombstones", "applied", "enqueued",
    )

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()
        self.entries: Dict[bytes, Any] = {}
        self.queue: List[tuple] = []
        self.early_drops: "OrderedDict[bytes, None]" = OrderedDict()
        self.tombstones: "OrderedDict[bytes, None]" = OrderedDict()
        self.applied = 0
        self.enqueued = 0


class ShardedObjectDirectory:
    """N-sharded object table + per-shard refcount flush queues.

    ``entry_factory`` builds a directory entry (the GCS's ObjectEntry);
    passed in to keep this module free of a gcs import cycle.
    ``free_callback(oids)`` is invoked by applier threads (no locks
    held) with entries that look reclaimable; the callback re-checks
    under the GCS lock and performs the actual free.
    """

    def __init__(
        self,
        entry_factory: Callable[[], Any],
        num_shards: Optional[int] = None,
        free_callback: Optional[Callable[[List[bytes]], None]] = None,
    ):
        from ..config import RayConfig

        n = int(num_shards or RayConfig.object_directory_shards)
        self.num_shards = max(1, n)
        self._entry_factory = entry_factory
        self.free_callback = free_callback
        # pin->borrow conversions ("pin2b") hand released pins back
        # through here once the borrow edge has landed (set by the GCS).
        self.unpin_callback: Optional[Callable[[List[bytes]], None]] = None
        self._shards = [_Shard(i) for i in range(self.num_shards)]
        # Clients known dead (bounded FIFO). A badd/add/pin2b op that
        # was still sitting in a shard queue when its client's death
        # sweep ran would otherwise apply AFTER the sweep and
        # resurrect a holder shadow nothing ever retracts (chaos-soak
        # leak: dead workers re-appearing in holder sets). Appliers
        # consult this under the shard lock; mutation happens on the
        # GCS death path.
        self.dead_clients: "OrderedDict[bytes, None]" = OrderedDict()
        self._dead_lock = threading.Lock()
        self._stopped = False
        # ONE applier thread services every shard queue. Shards keep
        # their own lock domains and flush queues (facade callers from
        # different dispatch threads contend per shard, not globally),
        # but apply/free runs on a single poll-coalescing thread: every
        # extra hot background thread in the head process measurably
        # taxed the dispatch hot path (~6us/task each at storm rates).
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._applying = False
        self.stats: Dict[str, int] = {
            "enqueued_ops": 0,
            "applied_ops": 0,
            "early_drops": 0,
            "free_candidates": 0,
            "dispatch_mutations": 0,
        }

    # ------------------------------------------------------------ sharding

    def _shard(self, oid: bytes) -> _Shard:
        return self._shards[hash(oid) % self.num_shards]

    def _wrap(self, entry):
        if GUARD and type(entry.holders) is set:
            # raylint: disable=thread-domain -- rebinds the set to its guard wrapper (same elements); not a refcount mutation
            entry.holders = _GuardedHolderSet(self.stats, entry.holders)
        return entry

    # ------------------------------------------------------- dict facade
    # Each call takes only the owning shard's lock; safe under the GCS
    # lock (lock order GCS -> shard).

    def get(self, oid: bytes, default=None):
        s = self._shard(oid)
        with s.lock:
            return s.entries.get(oid, default)

    def __getitem__(self, oid: bytes):
        s = self._shard(oid)
        with s.lock:
            return s.entries[oid]

    def __setitem__(self, oid: bytes, entry) -> None:
        s = self._shard(oid)
        with s.lock:
            s.tombstones.pop(oid, None)  # legitimate recreation
            s.entries[oid] = self._wrap(entry)

    def __contains__(self, oid: bytes) -> bool:
        s = self._shard(oid)
        with s.lock:
            return oid in s.entries

    def setdefault(self, oid: bytes, default):
        s = self._shard(oid)
        with s.lock:
            e = s.entries.get(oid)
            if e is None:
                s.tombstones.pop(oid, None)  # legitimate recreation
                e = s.entries[oid] = self._wrap(default)
            return e

    def pop(self, oid: bytes, default=None):
        s = self._shard(oid)
        with s.lock:
            return s.entries.pop(oid, default)

    def __len__(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    def items(self) -> List[Tuple[bytes, Any]]:
        out: List[Tuple[bytes, Any]] = []
        for s in self._shards:
            with s.lock:
                out.extend(s.entries.items())
        return out

    def values(self) -> List[Any]:
        out: List[Any] = []
        for s in self._shards:
            with s.lock:
                out.extend(s.entries.values())
        return out

    def keys(self) -> List[bytes]:
        out: List[bytes] = []
        for s in self._shards:
            with s.lock:
                out.extend(s.entries.keys())
        return out

    def __iter__(self):
        return iter(self.keys())

    # ------------------------------------------------------- early drops

    def pop_reclaimable(self, oid: bytes):
        """Atomically re-check eligibility and remove the entry — ONE
        shard-lock acquisition on the retire path (which runs under the
        GCS lock: every instruction here extends the serialized region
        the dispatch hot path waits on). Returns the popped entry, or
        None if it became ineligible."""
        s = self._shard(oid)
        with s.lock:
            e = s.entries.get(oid)
            if e is None or not self._reclaimable(e):
                return None
            del s.entries[oid]
            return e

    def seal_lookup(self, oid: bytes, default):
        """Seal-time hot path: setdefault + early-drop consume in ONE
        shard-lock acquisition (one per sealed result at storm rates).
        Returns (entry, release_raced_ahead)."""
        s = self._shard(oid)
        with s.lock:
            e = s.entries.get(oid)
            if e is None:
                s.tombstones.pop(oid, None)  # result (re)seal is fresh state
                e = s.entries[oid] = self._wrap(default)
            dropped = s.early_drops.pop(oid, _MISSING) is not _MISSING
        return e, dropped

    def take_early_drop(self, oid: bytes) -> bool:
        """Seal-time check: did a release/remove race ahead of this
        entry's creation? Consumes the ledger record."""
        s = self._shard(oid)
        with s.lock:
            return s.early_drops.pop(oid, _MISSING) is not _MISSING

    # -------------------------------------------------------- tombstones

    def note_tombstone(self, oid: bytes) -> None:
        """The entry was freed: remember it (bounded) so late refcount
        traffic and gets fail fast instead of resurrecting a ghost."""
        s = self._shard(oid)
        with s.lock:
            s.tombstones[oid] = None
            while len(s.tombstones) > TOMBSTONE_CAP:
                s.tombstones.popitem(last=False)

    def is_tombstoned(self, oid: bytes) -> bool:
        s = self._shard(oid)
        with s.lock:
            return oid in s.tombstones

    # ------------------------------------------------------ dead clients

    DEAD_CLIENT_CAP = 1024

    def note_dead_client(self, cid: bytes) -> None:
        """Mark a client dead BEFORE sweeping its holder shadows, so
        its queued-but-unapplied holder ops are dropped at apply time
        instead of resurrecting after the sweep."""
        with self._dead_lock:
            self.dead_clients[cid] = None
            while len(self.dead_clients) > self.DEAD_CLIENT_CAP:
                self.dead_clients.popitem(last=False)

    def is_dead_client(self, cid: bytes) -> bool:
        with self._dead_lock:
            return cid in self.dead_clients

    # ------------------------------------------------------- flush queues

    # raylint: dispatch-only
    def enqueue(self, ops: List[tuple]) -> Dict[int, int]:
        """Dispatch-loop half: split a refcount batch across shard
        queues. O(batch) appends; NO entry mutation happens here.

        Each op is ``(kind, oid, client)`` with kind one of:
        release / badd / bdel / add / remove.
        Returns per-shard enqueue counts (flight-recorder attrs).
        """
        per_shard: Dict[int, List[tuple]] = {}
        for op in ops:
            idx = hash(op[1]) % self.num_shards
            per_shard.setdefault(idx, []).append(op)
        counts: Dict[int, int] = {}
        for idx, shard_ops in per_shard.items():
            s = self._shards[idx]
            with s.lock:
                s.queue.extend(shard_ops)
                s.enqueued += len(shard_ops)
            counts[idx] = len(shard_ops)
        self.stats["enqueued_ops"] += len(ops)
        self._ensure_applier()
        self._wake.set()
        return counts

    def _ensure_applier(self) -> None:
        if self._thread is None and not self._stopped:
            t = threading.Thread(
                target=self._apply_loop, name="objdir-apply", daemon=True,
            )
            self._thread = t
            t.start()

    #: Coalescing window between applier passes. Refcount edges are
    #: latency-tolerant (clients already batch them on a 100ms flush);
    #: each pass costs one GIL slice plus one free-callback GCS-lock
    #: acquisition, so the window bounds the background tax on the
    #: dispatch hot path.
    _COALESCE_S = 0.02
    #: Empty passes before the applier parks on its event again. While
    #: a storm flows it poll-coalesces instead of paying a park/wake
    #: GIL handoff per flush message (same rationale as the event
    #: aggregator's poll loop).
    _HOT_PASSES = 8

    # raylint: applier-only
    def _apply_loop(self) -> None:
        while not self._stopped:
            self._wake.wait()
            if self._stopped:
                return
            self._wake.clear()
            idle_passes = 0
            while idle_passes < self._HOT_PASSES and not self._stopped:
                time.sleep(self._COALESCE_S)
                t0 = time.monotonic()
                self._applying = True
                total = 0
                candidates: List[bytes] = []
                unpins: List[bytes] = []
                for s in self._shards:
                    with s.lock:
                        if not s.queue:
                            continue
                        ops, s.queue = s.queue, []
                        for op in ops:
                            try:
                                self._apply_one(s, op, candidates, unpins)
                            except Exception:  # noqa: BLE001
                                # A poisoned op must not kill the only
                                # applier thread (that would silently
                                # stop every free cluster-wide); drop
                                # it, counted never silent.
                                self.stats["apply_errors"] = (
                                    self.stats.get("apply_errors", 0) + 1
                                )
                        s.applied += len(ops)
                    total += len(ops)
                if not total:
                    self._applying = False
                    idle_passes += 1
                    continue
                idle_passes = 0
                self.stats["applied_ops"] += total
                try:
                    if unpins and self.unpin_callback is not None:
                        self.unpin_callback(unpins)
                    if candidates:
                        self.stats["free_candidates"] += len(candidates)
                        cb = self.free_callback
                        if cb is not None:
                            # No locks held: the callback takes the
                            # GCS lock and re-checks eligibility there.
                            cb(candidates)
                except Exception:  # noqa: BLE001 - applier must survive
                    # A failing free/unpin callback drops this pass's
                    # candidates; the entries stay resident until the
                    # next retraction re-nominates them. Counted,
                    # never silent (raylint swallowed-fault).
                    self.stats["callback_errors"] = (
                        self.stats.get("callback_errors", 0) + 1
                    )
                finally:
                    self._applying = False
                if _events.enabled():
                    _events.record(
                        _events.REFS, "apply", "SHARD_APPLY",
                        {
                            "ops": total,
                            "freed_candidates": len(candidates),
                            "seconds": time.monotonic() - t0,
                        },
                    )

    # raylint: applier-only
    def _apply_one(self, s: _Shard, op: tuple,
                   candidates: List[bytes],
                   unpins: Optional[List[bytes]] = None) -> None:
        """One refcount op under the shard lock (applier thread)."""
        kind, oid, cid = op
        entry = s.entries.get(oid)
        dead = cid in self.dead_clients
        if dead and kind in ("badd", "add", "pin2b"):
            # The client died while this op sat in the queue: adding
            # its holder now would outlive every retraction path.
            self.stats["dead_client_ops"] = (
                self.stats.get("dead_client_ops", 0) + 1
            )
            if kind == "pin2b":
                # The pin release half must still run or task_pins leak.
                if unpins is not None:
                    unpins.append(oid)
                if entry is not None and self._reclaimable(entry):
                    candidates.append(oid)
            return
        if kind == "pin2b":
            # Dependency-pin -> borrow conversion (task_done piggyback):
            # record the borrow, then queue the pin release — the GCS
            # decrements task_pins under its own lock via
            # unpin_callback, AFTER this holder is visible.
            if entry is not None:
                entry.holders.add(cid)
                entry.had_holder = True
            if unpins is not None:
                unpins.append(oid)
            return
        if kind == "release":
            if entry is None:
                self._note_early_drop(s, oid)
                return
            entry.owner_released = True
            entry.had_holder = True
            if self._reclaimable(entry):
                candidates.append(oid)
        elif kind == "badd" or kind == "add":
            if entry is None:
                entry = s.entries[oid] = self._wrap(self._entry_factory())
                if oid in s.tombstones:
                    # The object was already FREED (the holder's add
                    # lost the race to the owner's release): a PENDING
                    # ghost here would park any get on it forever.
                    # LOST fails those gets fast, and the entry retires
                    # once this late holder retracts.
                    entry.status = "LOST"
                    self.stats["tombstone_hits"] = (
                        self.stats.get("tombstone_hits", 0) + 1
                    )
            entry.holders.add(cid)
            entry.had_holder = True
        elif kind == "bdel":
            if entry is None:
                # The owner decides this object's lifetime; a shadow
                # retraction for an entry not yet sealed carries no
                # information the owner's release won't.
                return
            entry.holders.discard(cid)
            if self._reclaimable(entry):
                candidates.append(oid)
        elif kind == "remove":
            if entry is None:
                self._note_early_drop(s, oid)
                return
            # A removal implies the client held the ref, even if its
            # add was compressed away within one flush window.
            entry.had_holder = True
            entry.holders.discard(cid)
            if self._reclaimable(entry):
                candidates.append(oid)

    def _note_early_drop(self, s: _Shard, oid: bytes) -> None:
        s.early_drops[oid] = None
        self.stats["early_drops"] += 1
        while len(s.early_drops) > EARLY_DROP_CAP:
            s.early_drops.popitem(last=False)

    @staticmethod
    def _reclaimable(entry) -> bool:
        """Shard-side pre-filter; the free callback re-checks under the
        GCS lock (same predicate as gcs._maybe_free)."""
        if entry.status == "PENDING" or entry.waiters:
            return False
        if entry.task_pins > 0 or entry.child_pins > 0:
            return False
        if entry.holders:
            return False
        hold = getattr(entry, "promoted_hold_until", 0.0)
        if hold and time.monotonic() < hold:
            # Dead-owner grace window (see gcs._sweep_client_refs): a
            # buffered borrow edge may still be in flight for it.
            return False
        return entry.owner_released or (
            entry.owner is None and entry.had_holder
        )

    # ----------------------------------------------------------- control

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every queued op has been applied (tests/barriers).
        Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while True:
            if self.queue_depth() == 0 and not self._applying:
                return True
            if time.monotonic() > deadline:
                return False
            self._ensure_applier()
            self._wake.set()
            time.sleep(0.001)

    def queue_depth(self) -> int:
        total = 0
        for s in self._shards:
            with s.lock:
                total += len(s.queue)
        return total

    def stop(self) -> None:
        self._stopped = True
        self._wake.set()


_MISSING = object()
