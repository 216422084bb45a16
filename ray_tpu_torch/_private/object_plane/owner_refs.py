"""Owner-side reference counting: the client half of the object plane.

Reference: src/ray/core_worker/reference_count.h — the process that
creates an object (its *owner*) keeps the authoritative reference
state: the count of local ObjectRef instances plus the set of remote
processes borrowing the ref. The cluster directory is only told about
ownership-edge transitions:

- ``release`` — the owner's authoritative view (local count + borrows)
  drained to zero: the object's memory can be reclaimed everywhere.
- ``badd``/``bdel`` — a *borrowed* ref (owner is another process)
  appeared in / vanished from this process; routed through the head to
  the owner, which folds it into its authoritative view.
- ``add``/``remove`` — head-fallback holder transitions for ownerless
  refs (owner unknown: detached handles, stream items consumed through
  a bare id); these keep the centralized semantics of the previous
  ``ref_tracker`` for objects no owner claims.

Python refcounting still does the heavy lifting: ObjectRef.__init__
calls track(), __del__ calls untrack(); only edges cross the wire,
batched on a flusher thread. The common case — every instance of an
object lives in the owner process — now costs ZERO wire traffic and
zero head-side work until the final release.

Flap/suppression invariants (regression-tested):
- a ref held and dropped (or 1->0->1 flapped) within one flush window
  sends NOTHING for un-advertised oids;
- a remove/bdel/release is only sent after its add (or for owner
  returns, after submission advertised the entry), so a bare removal
  can never race ahead of the state it retracts.

Thread domain (raylint-enforced): every mutation of the guarded
bookkeeping declared below happens in a ``# raylint: applier-only``
method, all of which hold ``self._lock`` — the tracker's equivalent
of the directory's single applier thread.
"""
# raylint: guarded-attrs=_counts,_owner_of,_dirty,_zeroed,_advertised,_borrows,_unacked,_dead_borrowers,_inline
from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from .. import chaos as _chaos
from .. import events as _events

FLUSH_INTERVAL_S = 0.1
#: Unacked ref_flush batches older than this are resent (at-least-once;
#: the head applies edges idempotently and sequences them per conn).
RETRANSMIT_S = 1.0
#: Resend attempts per batch before it is counted lost (never silent).
RETRANSMIT_MAX = 20
#: Recently-dead borrowers remembered so a head→owner borrow relay that
#: was delayed/reordered past the borrower_died sweep cannot re-add a
#: borrow edge nothing will ever retract.
DEAD_BORROWER_CAP = 256


class OwnerRefTracker:
    """Per-process instance tracking with owner-side authority.

    API-compatible with the legacy centralized ``RefTracker``
    (incr/decr/holds/mark_advertised/flush/stop) so the client wiring
    and the lifetime tests drive both the same way.
    """

    def __init__(self, client):
        # weakref: the tracker thread must not keep a closed client alive.
        self._client = weakref.ref(client)
        self._self_id: bytes = client.worker_id.binary()
        self._counts: Dict[bytes, int] = {}
        # oid -> owner worker id. b"" = ownerless (head fallback).
        # First truthy owner wins: classification is stable per process.
        self._owner_of: Dict[bytes, bytes] = {}
        self._dirty: Set[bytes] = set()
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stopped = False
        # oids whose local count hit zero; the client drops lineage for
        # them at flush time.
        self._zeroed: Set[bytes] = set()
        # oids whose presence the remote side already knows about (the
        # head for owned/ownerless oids, the owner for borrowed ones).
        # A retraction (release/bdel/remove) is only valid after its
        # advertisement: a ref held and dropped within one flush window
        # must send NOTHING — a bare retraction racing ahead of the
        # still-batched advertisement would free a live object.
        self._advertised: Set[bytes] = set()
        # Owned oids -> remote borrower worker ids (fed by head-relayed
        # borrow_update pushes). A drained local count does NOT release
        # while borrowers remain — the owner is the authority.
        self._borrows: Dict[bytes, Set[bytes]] = {}
        # At-least-once flush protocol: every edge-carrying ref_flush
        # gets a per-process sequence number and is retained here until
        # the head acks it; unacked batches retransmit on the flusher
        # (the head's per-conn sequencer dedups and re-orders). A batch
        # that a lossy transport eats is the correctness-critical path
        # for owner-side counting — one lost release leaks the object
        # cluster-wide forever.
        self._seq = 0
        self._unacked: "OrderedDict[int, List]" = OrderedDict()
        # Client conn generation the current numbering belongs to: a
        # fresh conn means a fresh head-side sequencer, so flush()
        # renumbers unacked batches before its first send on the new
        # conn (checked under the lock — NOT only in on_reconnect, or
        # a flush racing the conn swap would ship a stale seq and
        # poison the new sequencer's baseline).
        self._gen_seen = 0
        # Owned oids -> their serialized bytes, where no store of this
        # process holds them (an inline-only put): what a head
        # failover's reconcile sends for them. Kept until the release.
        self._inline: Dict[bytes, bytes] = {}
        # Borrowers swept by borrower_died; late borrow adds for them
        # are stale and must be ignored (see DEAD_BORROWER_CAP).
        self._dead_borrowers: "OrderedDict[bytes, None]" = OrderedDict()
        self.stats: Dict[str, int] = {
            "flushes": 0, "releases": 0, "badd": 0, "bdel": 0,
            "fallback_adds": 0, "fallback_removes": 0,
            "retransmits": 0, "lost_batches": 0, "stale_borrow_adds": 0,
        }

    # ------------------------------------------------------------- tracking

    # raylint: applier-only
    def incr(self, oid: bytes, owner: bytes = b"") -> None:
        with self._lock:
            n = self._counts.get(oid, 0) + 1
            self._counts[oid] = n
            if owner and not self._owner_of.get(oid):
                self._owner_of[oid] = owner
            if n == 1:
                if not self._dirty:
                    self._wake.set()
                self._dirty.add(oid)
                self._zeroed.discard(oid)
                self._ensure_flusher()

    # raylint: applier-only
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

    def owner_of(self, oid: bytes) -> bytes:
        with self._lock:
            return self._owner_of.get(oid, b"")

    # raylint: applier-only
    def mark_advertised(self, oid: bytes) -> None:
        """The remote side already records this oid's presence here:
        the head holds the entry for owner return-refs/puts from birth,
        or a task_done piggybacked this process's borrow. The eventual
        drop must send its retraction."""
        with self._lock:
            self._advertised.add(oid)

    # raylint: applier-only
    def mark_owned(self, oid: bytes) -> None:
        """Force owner classification (refs this process created)."""
        with self._lock:
            self._owner_of[oid] = self._self_id

    # raylint: applier-only
    def keep_inline(self, oid: bytes, blob: bytes) -> None:
        """An owned object's bytes that only the head holds besides this
        tracker (see ``_inline``)."""
        with self._lock:
            self._inline[oid] = blob

    def inline_of(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            return self._inline.get(oid)

    # raylint: applier-only
    def forget(self, oids) -> None:
        """Explicit free(): drop all bookkeeping so the instances still
        alive cannot emit retractions for an entry already gone."""
        with self._lock:
            for oid in oids:
                self._inline.pop(oid, None)
                self._counts.pop(oid, None)
                self._owner_of.pop(oid, None)
                self._advertised.discard(oid)
                self._borrows.pop(oid, None)
                self._dirty.discard(oid)
                self._zeroed.discard(oid)

    # ---------------------------------------------------- borrow authority

    # raylint: applier-only
    def apply_borrow_update(self, borrower: bytes, add, remove) -> None:
        """Head-relayed borrow edges for objects this process owns."""
        requeue = False
        with self._lock:
            if add and borrower in self._dead_borrowers:
                # The relay lost a race with the borrower_died sweep
                # (delayed/reordered delivery): adding now would pin the
                # object on an edge nothing will ever retract.
                self.stats["stale_borrow_adds"] += len(add)
                add = ()
            for oid in add or ():
                self._borrows.setdefault(oid, set()).add(borrower)
            for oid in remove or ():
                s = self._borrows.get(oid)
                if s is None:
                    continue
                s.discard(borrower)
                if not s:
                    del self._borrows[oid]
                    if (
                        self._counts.get(oid, 0) <= 0
                        and oid in self._advertised
                    ):
                        # Last borrower gone after our count drained:
                        # the release can go out now.
                        if not self._dirty:
                            self._wake.set()
                        self._dirty.add(oid)
                        requeue = True
        if requeue:
            self._ensure_flusher()

    # raylint: applier-only
    def on_reconnect(self) -> Dict[bytes, List[bytes]]:
        """The head restarted and this client re-registered on a fresh
        connection. Three things must replay (the head's per-conn
        sequencer numbers from 1 again and its object soft state is
        being rebuilt from bearers of truth):

        - unacked ref_flush batches renumber 1..k in their original
          order and retransmit immediately (the old numbering would
          read as a permanent gap to the new sequencer);
        - live borrowed/fallback refs are marked un-advertised so the
          next flush re-sends their badd/add edges;
        - owned refs (silent while alive by design) are returned as a
          reconcile payload — ``{oid: [borrower, ...]}`` — for the
          client to re-advertise into the head's recovery window.
        """
        owned: Dict[bytes, List[bytes]] = {}
        with self._lock:
            self._maybe_renumber_locked()
            for oid, n in self._counts.items():
                if n <= 0:
                    continue
                owner = self._owner_of.get(oid, b"")
                if owner == self._self_id:
                    if oid in self._advertised:
                        owned[oid] = sorted(self._borrows.get(oid, ()))
                else:
                    # Borrowed / head-fallback: re-advertise through the
                    # normal flush path.
                    self._advertised.discard(oid)
                    self._dirty.add(oid)
            # Owned oids kept alive only by remote borrowers (local
            # count drained): still ours to re-advertise.
            for oid, bs in self._borrows.items():
                if (
                    oid not in owned
                    and self._owner_of.get(oid) == self._self_id
                    and oid in self._advertised
                ):
                    owned[oid] = sorted(bs)
            if self._dirty or self._unacked:
                self._wake.set()
        self._ensure_flusher()
        return owned

    # raylint: applier-only
    def sweep_borrower(self, borrower: bytes) -> None:
        """A borrowing process died without retracting its borrows."""
        requeue = False
        with self._lock:
            self._dead_borrowers[borrower] = None
            while len(self._dead_borrowers) > DEAD_BORROWER_CAP:
                self._dead_borrowers.popitem(last=False)
            for oid in list(self._borrows):
                s = self._borrows[oid]
                s.discard(borrower)
                if not s:
                    del self._borrows[oid]
                    if (
                        self._counts.get(oid, 0) <= 0
                        and oid in self._advertised
                    ):
                        if not self._dirty:
                            self._wake.set()
                        self._dirty.add(oid)
                        requeue = True
        if requeue:
            self._ensure_flusher()

    # ------------------------------------------------------------- flushing

    # raylint: applier-only
    def _maybe_renumber_locked(self) -> None:
        """Caller holds self._lock. Renumber unacked batches 1..k
        (original order, due immediately) when the client moved to a
        new connection — see _gen_seen."""
        client = self._client()
        gen = getattr(client, "_conn_gen", 0) if client is not None else 0
        if gen == self._gen_seen:
            return
        self._gen_seen = gen
        old = list(self._unacked.values())
        self._unacked.clear()
        self._seq = 0
        for rec in old:
            self._seq += 1
            rec[0]["seq"] = self._seq
            rec[1] = 0.0  # due immediately
            rec[2] = 1  # fresh head: reset the attempt budget
            self._unacked[self._seq] = rec

    def _ensure_flusher(self):
        if self._flusher is None and not self._stopped:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="ref-flusher", daemon=True
            )
            self._flusher.start()

    def _flush_loop(self):
        # Park while clean: an idle process's tracker must cost zero
        # wakeups. incr/decr arm the event on the empty->dirty edge;
        # the interval sleep then batches the burst. With unacked
        # batches outstanding the park is bounded so retransmits run
        # even when no new edges arrive.
        while not self._stopped:
            if self._unacked:
                self._wake.wait(RETRANSMIT_S / 2)
            else:
                self._wake.wait()
            if self._stopped:
                return
            time.sleep(FLUSH_INTERVAL_S)
            self._wake.clear()
            client = self._client()
            if client is None:
                return
            if client.conn.closed:
                # Head connection down. If a failover reconnect may
                # still land, stay alive — the unacked batches and the
                # reconcile re-advertisement need this thread after the
                # swap. Otherwise the session is over.
                if client.conn_failover_pending():
                    self._wake.set()
                    time.sleep(FLUSH_INTERVAL_S)
                    continue
                return
            self.flush(client)

    # raylint: applier-only
    def _classify(
        self
    ) -> Tuple[List[bytes], List[Tuple[bytes, bytes]],
               List[Tuple[bytes, bytes]], List[bytes], List[bytes],
               Set[bytes]]:
        """Net edge transitions for the dirty set. Caller holds the
        lock. Returns (release, badd, bdel, add, remove, zeroed)."""
        release: List[bytes] = []
        badd: List[Tuple[bytes, bytes]] = []
        bdel: List[Tuple[bytes, bytes]] = []
        add: List[bytes] = []
        remove: List[bytes] = []
        dirty, self._dirty = self._dirty, set()
        for oid in dirty:
            n = self._counts.get(oid, 0)
            owner = self._owner_of.get(oid, b"")
            owned = owner == self._self_id
            if n > 0:
                # Alive. Owned oids cost nothing — the head entry's
                # lifetime is governed solely by our eventual release.
                if owned:
                    continue
                if oid in self._advertised:
                    continue
                self._advertised.add(oid)
                if owner:
                    badd.append((owner, oid))
                else:
                    add.append(oid)
                continue
            # Drained locally.
            if owned:
                if self._borrows.get(oid):
                    # Remote borrowers keep the object alive; the
                    # borrow-drain path re-dirties this oid.
                    continue
                if oid in self._advertised:
                    self._advertised.discard(oid)
                    self._inline.pop(oid, None)
                    release.append(oid)
                # Never-advertised owned oids (flapped within one
                # window before submission registered) send nothing.
                self._owner_of.pop(oid, None)
                self._borrows.pop(oid, None)
            elif owner:
                if oid in self._advertised:
                    self._advertised.discard(oid)
                    bdel.append((owner, oid))
                self._owner_of.pop(oid, None)
            else:
                if oid in self._advertised:
                    self._advertised.discard(oid)
                    remove.append(oid)
                self._owner_of.pop(oid, None)
        return release, badd, bdel, add, remove, dirty

    # raylint: applier-only
    def flush(self, client) -> None:
        """Send the net ownership-edge transitions since the last
        flush (idempotent set semantics server-side, so transient
        1->0->1 flaps are safe)."""
        with self._lock:
            self._maybe_renumber_locked()
            if not self._dirty and not self._zeroed:
                pending_ack = bool(self._unacked)
                if not pending_ack:
                    return
                release = badd = bdel = add = remove = ()
                zeroed = ()
            else:
                release, badd, bdel, add, remove, _ = self._classify()
                zeroed, self._zeroed = self._zeroed, set()
        if not (release or badd or bdel or add or remove or zeroed):
            # Nothing new this window: just service retransmits.
            self._retransmit_due(client)
            return
        if zeroed:
            for oid in zeroed:
                client._lineage.pop(oid, None)
            client._wait_prune(zeroed)
        if not (release or badd or bdel or add or remove):
            return
        self.stats["flushes"] += 1
        self.stats["releases"] += len(release)
        self.stats["badd"] += len(badd)
        self.stats["bdel"] += len(bdel)
        self.stats["fallback_adds"] += len(add)
        self.stats["fallback_removes"] += len(remove)
        if _events.enabled():
            _events.record(
                _events.REFS, self._self_id.hex()[:12], "REF_FLUSH",
                {
                    "release": len(release), "badd": len(badd),
                    "bdel": len(bdel), "fallback": len(add) + len(remove),
                },
            )
        from ..protocol import ConnectionLost

        msg = {"type": "ref_flush", "client": self._self_id}
        if release:
            msg["release"] = release
        if badd:
            msg["badd"] = badd
        if bdel:
            msg["bdel"] = bdel
        if add:
            msg["add"] = add
        if remove:
            msg["remove"] = remove
        with self._lock:
            self._seq += 1
            msg["seq"] = self._seq
            # [msg, sent_at, attempts] — retained until the head acks.
            self._unacked[msg["seq"]] = [msg, time.monotonic(), 1]
        # Chaos kill point: "owner killed between SEAL and REF_FLUSH" —
        # the edges above are classified (and lineage dropped) but the
        # batch never reaches the head.
        _chaos.kill_point("owner.pre_ref_flush")
        try:
            # raylint: disable=raw-send-on-gcs-path -- this IS the at-least-once layer: the batch is retained in _unacked above and retransmits until the head acks
            client.conn.send(msg)
        except ConnectionLost:
            # The batch stays in _unacked; it retransmits on the next
            # connection if a failover lands (the send was already
            # at-least-once, so conn loss is just a longer gap).
            if not client.conn_failover_pending():
                self._stopped = True
            return
        self._retransmit_due(client)

    # raylint: applier-only
    def ack(self, seq: int) -> None:
        """Head acknowledged a ref_flush batch (delivered to its
        per-conn sequencer; idempotent application from there)."""
        with self._lock:
            self._unacked.pop(seq, None)

    # raylint: applier-only
    def _retransmit_due(self, client) -> None:
        """Resend unacked batches past the retransmit age; bounded
        attempts, lost batches counted — never silent."""
        now = time.monotonic()
        resend: List[dict] = []
        with self._lock:
            for seq, rec in list(self._unacked.items()):
                if now - rec[1] < RETRANSMIT_S:
                    break  # OrderedDict: the rest are younger
                if rec[2] >= RETRANSMIT_MAX:
                    del self._unacked[seq]
                    self.stats["lost_batches"] += 1
                    continue
                rec[1] = now
                rec[2] += 1
                resend.append(rec[0])
        if not resend:
            return
        from ..protocol import ConnectionLost

        self.stats["retransmits"] += len(resend)
        if _events.enabled():
            _events.record(
                _events.REFS, self._self_id.hex()[:12], "REF_REFLUSH",
                {"batches": len(resend)},
            )
        try:
            for m in resend:
                client.conn.send(m)
        except ConnectionLost:
            if not client.conn_failover_pending():
                self._stopped = True

    def stop(self):
        self._stopped = True
        self._wake.set()
