"""Core client: the library linked into every driver and worker process.

Reference: the CoreWorker library (src/ray/core_worker/core_worker.h:292)
— submission, object get/put/wait, KV access — minus the execution loop,
which lives in worker_main. One instance per process, connected to the
GCS over the session's unix socket.
"""
from __future__ import annotations

import collections
import concurrent.futures
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import chaos as _chaos
from . import serialization
from . import events as _events
from . import fastpath as _fastpath
from .config import RayConfig
from .ids import ObjectID, WorkerID, fast_unique_bytes
from .object_store import ObjectStore
from .protocol import OP_CALL, ConnectionLost, PeerConn
from .task_spec import TaskSpec
from ..exceptions import GetTimeoutError, RayTaskError, RayTpuError
from ..object_ref import ObjectRef

_MISSING = object()  # direct-route state: never looked up
_fp = _fastpath.get()  # native hot path (None → pure Python)
_return_oids = (
    _fp.return_oids
    if _fp is not None
    else lambda tid, n: [ObjectID.bytes_for_return(tid, i) for i in range(n)]
)
# In-flight tasks per leased worker. One, as in upstream Ray
# (max_tasks_in_flight_per_worker): a task queued behind another on one
# worker waits for it, and if the first waits for the second (ranks of
# a collective group) neither ever ends. The rest of a burst waits in
# the owner's backlog for its class and goes to the next lease to drain.
_LEASE_PIPELINE_MAX = 1
_LEASE_IDLE_RETURN_S = 0.5  # idle leases are given back after this
# A lease whose task has run this long is stalled; once every lease of a
# class is, and the pool cannot grow, its backlog goes through the head.
_LEASE_STALL_S = 1.0
_FLUSH_INTERVAL_S = 0.002  # safety flush for lazily-buffered sends

# get() resolution kinds: direct-call reply socket, same-host store hit
# (zero RPCs), or the GCS directory.
_GET_DIRECT = object()
_GET_LOCAL = object()
_GET_GCS = object()


class CoreClient:
    def __init__(
        self,
        address: str,
        authkey: bytes,
        role: str,
        worker_id: Optional[WorkerID] = None,
        push_handler: Optional[Callable[[Dict[str, Any]], None]] = None,
        transfer_addr: Optional[str] = None,
        direct_addr: Optional[str] = None,
        reconnect: Optional[bool] = None,
    ):
        from . import transport
        from .object_transfer import ObjectFetcher

        self.worker_id = worker_id or WorkerID.from_random()
        self.role = role
        self.store = ObjectStore()
        # Read-your-writes contract for state reads (list/timeline):
        # worker processes bind this to their _DoneBatcher.flush so
        # locally-coalesced task_done records reach the GCS before a
        # state query from this process is answered (the GCS-side flush
        # barrier cannot ping the requesting worker — its conn reader
        # thread is busy carrying the request; gcs._barrier_flush_events).
        self.pre_state_read_flush: Optional[Callable[[], None]] = None
        self._push_handler = push_handler or (lambda msg: None)
        self._address = address
        self._authkey = authkey
        self._transfer_addr = transfer_addr
        self._direct_addr = direct_addr
        # Head failover (reference: gcs_rpc_client retries across a GCS
        # restart). Workers always ride a failover — their head (the
        # same session address, unix or TCP) may be restarted by a
        # supervisor; drivers opt in when they connected to an external
        # head (an in-process head dies with this process).
        self._reconnect_enabled = (
            role == "worker" if reconnect is None else bool(reconnect)
        )
        self._closing = False
        self._reconnecting = False
        self._reconnect_lock = threading.Lock()
        # Leased-task resubmits that hit ConnectionLost park here for
        # ONE drainer thread (threads-per-lost-lease would balloon
        # during the exact mass-lease-death outage this serves).
        self._resubmit_pending: List[Any] = []
        self._resubmit_lock = threading.Lock()
        self._resubmit_thread: Optional[threading.Thread] = None
        self._conn_gen = 0
        #: Set when the head is gone for good (reconnect disabled,
        #: budget exhausted, or close()): watchers exit on this.
        self.head_permanently_lost = threading.Event()
        #: Worker runtime hooks: extra reconnect-hello payload (hosted
        #: actors, executing tasks, sealed locations) and a post-
        #: reconnect callback (done-batcher retransmit, drop_actors).
        self.reconcile_info: Optional[Callable[[], Dict[str, Any]]] = None
        self.on_reconnected: Optional[
            Callable[[Dict[str, Any]], None]
        ] = None
        self.done_ack: Optional[Callable[[int], None]] = None
        # Initial connect: ONE retry policy (chaos.Backoff, full
        # jitter) instead of failing on the first refused connect — a
        # worker spawned while the head restarts, or a driver racing
        # head bring-up, must absorb the same failure mode the
        # reconnect path does (reconnect stampede note in raylet.py).
        bo = _chaos.Backoff(
            base_s=0.1, cap_s=2.0,
            budget_s=(
                RayConfig.worker_register_timeout_s
                if role == "worker"
                else 5.0
            ),
        )
        conn = _chaos.retry_call(
            lambda: transport.connect(address, authkey),
            retry_on=(OSError,),
            backoff=bo,
        )
        self.conn = PeerConn(
            conn,
            push_handler=self._on_push,
            on_close=lambda gen=0: self._on_head_conn_close(gen),
            name=f"client-{role}",
        )
        # Partition-chaos role stamp: the far side of this conn is the
        # head (link-cut rules are expressed between named roles).
        self.conn.peer_role = "head"
        reply = self.conn.request(
            self._hello_msg(), timeout=RayConfig.worker_register_timeout_s
        )
        if not reply.get("ok"):
            raise RayTpuError(f"failed to register with GCS: {reply}")
        self.session_dir = reply["session_dir"]
        # The node this process's objects live on; objects located on
        # other nodes are pulled through the transfer plane.
        self.node_id: Optional[bytes] = reply.get("node_id")
        self._fetcher = ObjectFetcher(self.store, authkey)
        # Admission control over the transfer plane (pull_manager.h):
        # pulls queue get > wait > task-args under a bounded in-flight
        # byte budget so bulk broadcasts can't starve small gets.
        from .object_plane.pull_manager import PullManager

        self._pull_manager = PullManager(self._fetcher, store=self.store)
        self._registered_functions: set = set()
        self._fn_lock = threading.Lock()
        # Direct actor-call path (reference: actor calls bypass raylets,
        # gRPC straight to the actor process —
        # transport/direct_actor_task_submitter.h). aid -> PeerConn once
        # established, "resolving" while the GCS lookup is in flight
        # (calls buffer so one ordered stream flows down exactly one
        # path), or None when the actor stays on the GCS route
        # (restartable actors).
        self._direct_lock = threading.RLock()
        self._direct_conns: Dict[bytes, Any] = {}
        self._direct_buffer: Dict[bytes, list] = {}  # aid -> specs awaiting route
        self._direct_results: Dict[bytes, Any] = {}  # oid -> Future(fields)
        self._direct_oids: Dict[bytes, set] = {}  # aid -> unresolved oids
        # Workers (leases) and actors this process has pushed calls to
        # since its last state read: their batched completions are its
        # writes, which the read's barrier waits for (state_read).
        self._read_barrier_workers: set = set()
        self._read_barrier_actors: set = set()
        # Leased-worker pools per scheduling class (direct task transport).
        self._lease_lock = threading.Lock()
        self._leases: Dict[Any, list] = {}
        # Per-class grow hold-off: a monotonic deadline computed from
        # exponential backoff + jitter (one policy, chaos.Backoff)
        # instead of a fixed 100ms window, so a saturated or briefly-
        # unavailable head sees the retry rate decay instead of a
        # stampede of synchronized grow round-trips. The deadline entry
        # is popped (and the backoff reset) on a successful grow.
        self._lease_grow_hold_until: Dict[Any, float] = {}
        # Scheduling class -> tasks waiting for a lease of that class to
        # drain: (spec, result future, submit time), oldest first.
        self._lease_backlog: Dict[Any, collections.deque] = {}
        self._lease_backoff: Dict[Any, Any] = {}
        self._lease_reaper: Optional[threading.Thread] = None
        # Distributed refcounting + lineage (reference_count.h:61,
        # task_manager.h:269): live ObjectRef instances in this process
        # feed the tracker; specs this client submitted are retained for
        # reconstruction until their return refs die.
        from .ref_tracker import RefTracker, set_current

        self._lineage: Dict[bytes, TaskSpec] = {}
        self._tracker = RefTracker(self)
        set_current(self._tracker)
        # Lazily-buffered connections (hot-path frames coalesce into one
        # wire message per burst); flushed before any blocking get/wait
        # and by a safety timer for fire-and-forget callers.
        self._lazy_conns: set = set()
        self._lazy_flusher: Optional[threading.Thread] = None
        self._lazy_evt = threading.Event()
        self._lazy_parked = False
        # Push-based wait (reference: raylet/wait_manager.h — waits are
        # registered once and completed by callbacks, never polled).
        # _wait_ready is a monotone set of locally-known-ready ids fed by
        # (a) direct-call reply callbacks and (b) one-shot GCS
        # subscriptions answered with ("RDY", oids) pushes; wait() just
        # partitions against it under the condvar. Pruned when refs die.
        self._wait_cond = threading.Condition()
        self._wait_ready: set = set()
        self._wait_interest: set = set()  # ids a wait() is blocked on
        self._wait_subscribed: set = set()  # ids subscribed at the GCS
        # Superset of ready ∪ interest: ids wait() has classified.
        # Registration happens ONCE per id (O(changed) across a whole
        # drain-by-wait loop); the per-call scan pays one set probe per
        # already-tracked ref instead of re-classifying. Pruned with
        # the other wait sets when refs die.
        self._wait_tracked: set = set()
        # registered counts first-time classifications — the perf
        # assertion in ray_perf checks it stays O(refs), not O(n^2).
        self._wait_stats = {"registered": 0}
        self._head_conn_lost = False

    # --------------------------------------------------------- lazy flushing

    def _mark_lazy(self, conn: PeerConn) -> None:
        self._lazy_conns.add(conn)
        if self._lazy_parked:
            self._lazy_parked = False
            self._lazy_evt.set()
        if self._lazy_flusher is None:
            self._lazy_flusher = threading.Thread(
                target=self._lazy_flush_loop, name="lazy-flusher", daemon=True
            )
            self._lazy_flusher.start()

    def flush_lazy(self) -> None:
        # Hot path (runs before every blocking get/wait): flush() itself
        # early-outs on an empty buffer, so one call per conn is cheap.
        for c in tuple(self._lazy_conns):
            try:
                c.flush()
            except ConnectionLost:
                self._lazy_conns.discard(c)
            else:
                if c.closed:
                    self._lazy_conns.discard(c)

    def _lazy_flush_loop(self) -> None:
        # Safety flush for fire-and-forget senders, parked while no conn
        # has buffered frames — an idle process must cost zero wakeups
        # (hundreds of workers x a 2 ms timer would saturate a core on
        # their own; see the 150-actor scale stress).
        while self._running():
            busy = False
            for c in tuple(self._lazy_conns):
                if c.has_buffered:
                    busy = True
                    break
            if busy:
                time.sleep(_FLUSH_INTERVAL_S)
                self.flush_lazy()
                continue
            self._lazy_parked = True
            # Re-check under the parked flag: a send_lazy racing the
            # scan above sees parked=True and sets the event.
            if any(c.has_buffered for c in tuple(self._lazy_conns)):
                self._lazy_parked = False
                continue
            self._lazy_evt.wait()
            self._lazy_evt.clear()
            self._lazy_parked = False

    # ------------------------------------------------------- head failover
    # Reference: gcs_rpc_client.h retries RPCs across a GCS restart and
    # bearers of truth re-report via NotifyGCSRestart. Here: on conn
    # loss, a reconnect thread re-dials the SAME head address with
    # chaos.Backoff, re-registers under the same worker/job id
    # (hello reconnect=True), then replays in-flight state — wait
    # re-subscriptions, owned-object reconciliation, unacked
    # ref_flush/task_done batches (per-batch seq + head-side dedup make
    # retransmission safe). Blocked get()/wait() callers park on the
    # failover instead of raising.

    def _hello_msg(self, reconnect: bool = False) -> Dict[str, Any]:
        hello: Dict[str, Any] = {
            "type": "hello",
            "role": self.role,
            "worker_id": self.worker_id.binary(),
            "pid": os.getpid(),
        }
        if self._transfer_addr:
            hello["transfer_addr"] = self._transfer_addr
        if self._direct_addr:
            hello["direct_addr"] = self._direct_addr
        nid_hex = os.environ.get("RAY_TPU_TORCH_NODE_ID")
        if nid_hex:
            hello["node_id"] = bytes.fromhex(nid_hex)
        if os.environ.get("RAY_TPU_TORCH_LOCAL_ONLY"):
            # Raylet-leased worker: the daemon dispatches to us, the GCS
            # only keeps directory/worker bookkeeping.
            hello["local_only"] = True
        if reconnect:
            hello["reconnect"] = True
            info = self.reconcile_info
            if info is not None:
                try:
                    hello.update(info())
                except Exception:  # noqa: BLE001 - reconcile is best-effort
                    pass
        return hello

    def _on_head_conn_close(self, gen: int = -1) -> None:
        if gen >= 0 and gen != self._conn_gen:
            return  # a superseded connection's late close: ignore
        # Blocked waiters must observe head loss (the old polling wait
        # raised out of its per-iteration request; push-based waits
        # would otherwise sleep forever on the condvar).
        with self._wait_cond:
            self._head_conn_lost = True
            self._wait_cond.notify_all()
        if self._closing or not self._reconnect_enabled:
            self.head_permanently_lost.set()
            return
        with self._reconnect_lock:
            if self._reconnecting or self._closing:
                return
            self._reconnecting = True
        threading.Thread(
            target=self._reconnect_loop, name="head-reconnect", daemon=True
        ).start()

    def conn_failover_pending(self) -> bool:
        """True while the head connection may yet come back (a failover
        reconnect is possible and not exhausted) — loops that would
        exit on a closed conn should idle instead."""
        return (
            self._reconnect_enabled
            and not self._closing
            and not self.head_permanently_lost.is_set()
        )

    def _running(self) -> bool:
        """Session liveness for background loops: the current conn is
        open, or a failover may still bring a new one."""
        if self._closing:
            return False
        if not self.conn.closed:
            return True
        return self.conn_failover_pending()

    def _reconnect_loop(self) -> None:
        from . import transport

        t0 = time.monotonic()
        if _events.enabled():
            _events.record(
                _events.HEAD, self.worker_id.hex()[:12], "HEAD_DOWN",
                {"role": self.role},
            )
        bo = _chaos.Backoff(
            base_s=0.2, cap_s=2.0,
            budget_s=RayConfig.gcs_reconnect_budget_s,
        )
        reply = None
        conn = None
        while not self._closing:
            try:
                raw = transport.connect(self._address, self._authkey)
            except OSError:
                if bo.sleep():
                    continue
                break
            conn = PeerConn(
                raw, push_handler=self._on_push, name=f"client-{self.role}"
            )
            conn.peer_role = "head"
            try:
                reply = conn.request(
                    self._hello_msg(reconnect=True),
                    timeout=RayConfig.worker_register_timeout_s,
                )
            except (
                ConnectionLost, TimeoutError,
                concurrent.futures.TimeoutError, OSError,
            ):
                reply = None
            if reply is not None and reply.get("fenced"):
                # The head fenced this identity (declared-dead worker
                # whose W_DEAD record outlived the partition): replaying
                # the same hello can never succeed — give up now so the
                # process exits instead of burning the whole budget.
                conn.close()
                reply, conn = None, None
                break
            if reply is None or not reply.get("ok"):
                conn.close()
                reply, conn = None, None
                if bo.sleep():
                    continue
                break
            break
        ok = reply is not None and conn is not None
        if ok:
            self.session_dir = reply["session_dir"]
            if reply.get("node_id"):
                self.node_id = reply["node_id"]
            self._conn_gen += 1
            self.conn = conn
            conn.set_on_close(
                lambda gen=self._conn_gen: self._on_head_conn_close(gen)
            )
        with self._reconnect_lock:
            self._reconnecting = False
        if not ok:
            self.head_permanently_lost.set()
            with self._wait_cond:
                self._wait_cond.notify_all()
            return
        with self._wait_cond:
            self._head_conn_lost = False
            self._wait_cond.notify_all()
        try:
            self._replay_after_reconnect(reply)
        except Exception:  # noqa: BLE001 - replay is best-effort; the
            pass  # recovery sweep covers what a racing close drops
        if _events.enabled():
            _events.record(
                _events.HEAD, self.worker_id.hex()[:12], "HEAD_RECONNECT",
                {
                    "outage_s": round(time.monotonic() - t0, 3),
                    "attempts": bo.attempts + 1,
                    "role": self.role,
                },
            )

    def _replay_after_reconnect(self, reply: Dict[str, Any]) -> None:
        """Re-advertise in-flight state to the restarted head: owned
        objects + live borrow edges (tracker reconcile), one-shot wait
        subscriptions, and the runtime's extras (done-batch replay)."""
        on_rec = getattr(self._tracker, "on_reconnect", None)
        owned = on_rec() if on_rec is not None else {}
        if owned:
            items = []
            for oid, borrowers in owned.items():
                try:
                    loc = self.store.location_of(ObjectID(oid))
                except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- no local copy: the reconcile entry goes without a location and the head keeps its own
                    loc = None
                # An inline-only put goes with its bytes, which the
                # restarted head may never have persisted.
                inline = self._tracker.inline_of(oid) if loc is None else None
                items.append((oid, loc, borrowers, inline))
            try:
                self.conn.send(
                    {
                        "type": "reconcile",
                        "client": self.worker_id.binary(),
                        "owned": items,
                    }
                )
            except ConnectionLost:
                pass
        with self._wait_cond:
            subs = list(self._wait_subscribed)
        if subs:
            try:
                r = self.conn.request(
                    {"type": "wait_subscribe", "object_ids": subs}
                )
                ready = r.get("ready")
                if ready:
                    self._wait_mark(ready, subscribed=True)
            except (ConnectionLost, TimeoutError):
                pass
        cb = self.on_reconnected
        if cb is not None:
            try:
                cb(reply)
            except Exception:  # noqa: BLE001
                pass

    def _await_failover(self) -> bool:
        """Park the calling thread until the failover lands (True) or
        is hopeless (False). Callers re-issue their request on True."""
        if not self.conn_failover_pending():
            return False
        deadline = (
            time.monotonic()
            + RayConfig.gcs_reconnect_budget_s
            + RayConfig.worker_register_timeout_s
        )
        while time.monotonic() < deadline:
            if self.head_permanently_lost.is_set() or self._closing:
                return False
            with self._wait_cond:
                if not self._head_conn_lost and not self.conn.closed:
                    return True
                # Parked, not polled: the reconnect loop notifies this
                # condvar on both success and final failure (the
                # timeout only guards a close handler that never ran).
                self._wait_cond.wait(timeout=0.25)
        return False

    def send_reliable(self, msg: Dict[str, Any]) -> None:
        """A send that survives a head failover: on conn loss, park
        until the reconnect re-registers, then resend on the new conn
        (used for submits — the task must not be dropped because the
        head was mid-restart)."""
        while True:
            try:
                self.conn.send(msg)
                return
            except ConnectionLost:
                if not self._await_failover():
                    raise

    def request_reliable(
        self, msg: Dict[str, Any], timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        """Request/reply across a failover: a lost connection re-issues
        the request on the reconnected one (request ids are assigned
        per-conn, so re-sending the same dict is safe)."""
        while True:
            try:
                return self.conn.request(msg, timeout=timeout)
            except ConnectionLost:
                if not self._await_failover():
                    raise

    # raylint: dispatch-only
    def _on_push(self, msg: Dict[str, Any]):
        if type(msg) is tuple and msg[0] == "RDY":
            self._wait_mark(msg[1], subscribed=True)
            return
        mtype = msg.get("type") if type(msg) is dict else None
        if mtype == "borrow_update":
            # Object plane: head-relayed borrow edges for objects this
            # process owns — fold into the authoritative view.
            self._tracker.apply_borrow_update(
                msg.get("borrower", b""), msg.get("add"), msg.get("remove")
            )
            return
        if mtype == "borrower_died":
            self._tracker.sweep_borrower(msg.get("client", b""))
            return
        if mtype == "ref_flush_ack":
            # At-least-once ref_flush: the head received the batch;
            # stop retransmitting it.
            ack = getattr(self._tracker, "ack", None)
            if ack is not None:
                ack(msg.get("seq", 0))
            return
        if mtype == "task_done_ack":
            # At-least-once task_done_batch (worker runtime): the head
            # received the completion batch; stop retransmitting it.
            ack = self.done_ack
            if ack is not None:
                ack(msg.get("seq", 0))
            return
        if mtype == "fenced":
            # Membership fence: the head declared this client dead while
            # a partition hid its heartbeats. A fenced worker's results
            # and refcount edges are already being dropped head-side —
            # the only correct move is to stop being this identity.
            # Workers exit (the raylet's fresh incarnation respawns
            # capacity); a driver surfaces permanent head loss.
            if self.role == "worker":
                self._reconnect_enabled = False
                self.head_permanently_lost.set()
                with self._wait_cond:
                    self._head_conn_lost = True
                    self._wait_cond.notify_all()
                try:
                    self.conn.close()
                except Exception:  # noqa: BLE001 - counted, never silent
                    self._fence_close_errors = getattr(
                        self, "_fence_close_errors", 0
                    ) + 1
            return
        self._push_handler(msg)

    # -------------------------------------------------- push-based wait state

    def _wait_mark(self, oids, subscribed: bool = False) -> None:
        """A result landed: promote interested ids to the ready set.

        Ids without registered interest are ignored (wait() classifies
        already-done entries itself), keeping the ready set bounded by
        what has actually been waited on."""
        cond = self._wait_cond
        with cond:
            interest = self._wait_interest
            if subscribed:
                hit = [o for o in oids if o in self._wait_subscribed]
            else:
                if not interest:
                    return
                hit = [o for o in oids if o in interest]
            if not hit:
                return
            interest.difference_update(hit)
            self._wait_ready.update(hit)
            cond.notify_all()

    def _wait_on_failure(self, oids) -> None:
        """A direct route died and its entries were rewritten to
        sentinels: re-classify interested ids — terminal sentinels are
        ready, via_gcs resubmissions move to a GCS subscription."""
        to_subscribe = []
        cond = self._wait_cond
        with cond:
            interest = self._wait_interest
            if not interest:
                return
            woke = False
            for oid in oids:
                if oid not in interest:
                    continue
                entry = self._direct_results.get(oid)
                if isinstance(entry, dict) and entry.get("via_gcs"):
                    if oid not in self._wait_subscribed:
                        self._wait_subscribed.add(oid)
                        to_subscribe.append(oid)
                else:
                    # FAILED / exception sentinel (or a racing success):
                    # counts as ready; get() surfaces the outcome.
                    interest.discard(oid)
                    self._wait_ready.add(oid)
                    woke = True
            if woke:
                cond.notify_all()
        if to_subscribe:
            self._wait_subscribe_async(to_subscribe)

    def _wait_subscribe_async(self, oids) -> None:
        fut = self.conn.request_async(
            {"type": "wait_subscribe", "object_ids": oids}
        )

        def _done(f):
            try:
                ready = f.result().get("ready")
            except BaseException:  # noqa: BLE001 - conn loss ends waits
                return
            if ready:
                self._wait_mark(ready, subscribed=True)

        fut.add_done_callback(_done)

    def _wait_prune(self, oids) -> None:
        """Refs died locally: forget their wait bookkeeping. O(changed)
        — set difference over the dead ids only, never a rescan of the
        live wait set."""
        cond = self._wait_cond
        with cond:
            if (
                not self._wait_tracked
                and not self._wait_subscribed
            ):
                return
            self._wait_ready.difference_update(oids)
            self._wait_interest.difference_update(oids)
            self._wait_subscribed.difference_update(oids)
            self._wait_tracked.difference_update(oids)

    # ------------------------------------------------------------------ submit

    def register_function_once(self, function_id: bytes, blob: bytes) -> Optional[bytes]:
        """Registers the function with the head on its first call here,
        waiting for the answer, and returns None: the spec need not
        carry the blob. Waiting matters for the leased route, which
        reaches a worker without the head, and the worker fetches the
        function from the head (the reference ships the blob with the
        first submit, which a later leased call can overtake)."""
        if function_id in self._registered_functions:
            return None
        with self._fn_lock:
            if function_id not in self._registered_functions:
                self.request_reliable({
                    "type": "register_function",
                    "function_id": function_id,
                    "blob": blob,
                })
                self._registered_functions.add(function_id)
        return None

    def fetch_function(self, function_id: bytes) -> bytes:
        reply = self.request_reliable(
            {"type": "get_function", "function_id": function_id}
        )
        if not reply.get("ok"):
            raise RayTpuError(f"function {function_id.hex()} not found in GCS")
        return reply["blob"]

    def _record_lineage(self, spec: TaskSpec) -> None:
        if spec.actor_id is None:
            for oid in spec.return_object_ids():
                self._lineage[oid.binary()] = spec

    def submit(self, spec: TaskSpec) -> List[ObjectRef]:
        self._record_lineage(spec)
        _rec = _events.get_recorder()
        if _rec.enabled:
            _rec.record(
                _events.TASK, spec.task_id.hex(), "SUBMITTED",
                {"route": "gcs", "name": spec.name},
            )
        # Reliable: a submit racing a head restart parks on the
        # failover and lands on the recovered head instead of vanishing.
        self.send_reliable({"type": "submit_task", "spec": spec})
        owner = self.worker_id.binary()
        refs = [ObjectRef(oid, owner) for oid in spec.return_object_ids()]
        self._advertise_returns(refs)
        return refs

    def _advertise_returns(self, refs: Sequence[ObjectRef]) -> None:
        """Owner-side return refs count as advertised from birth: the
        directory frees a sealed result on the owner's remove (the
        had_holder fast-drop path), so the drop must go out even when
        the ref dies inside the first flush window — otherwise every
        short-lived `get(f.remote())` result leaks server-side."""
        for r in refs:
            self._tracker.mark_advertised(r.id().binary())

    # ------------------------------------------------- leased task transport
    # Reference: CoreWorkerDirectTaskSubmitter (direct_task_transport.cc:24)
    # — the caller leases idle workers from the control plane once per
    # burst and pushes tasks to them directly, so the steady-state task
    # path costs one hop (caller -> worker -> caller) instead of four
    # through the GCS. Resource accounting happens at lease grant/return
    # granularity; the worker's async task_done keeps the object
    # directory coherent for wait/free/cross-process refs.

    def _lease_eligible(self, spec: TaskSpec) -> bool:
        return (
            spec.actor_id is None
            and not spec.actor_creation
            and not spec.dependencies
            # Nested arg refs need the GCS route's lifetime pins (the
            # leased path has no head-side pinning at all).
            and not spec.borrowed_refs
            and spec.placement_group_id is None
            and spec.scheduling_strategy is None
            and not spec.retry_exceptions
            # The compact frame carries no runtime_env: a task with one
            # takes the GCS route, whose spec the worker activates.
            and not spec.runtime_env
            and spec.function_blob is None  # first call registers via GCS
            # Single-card GPU tasks lease from the LOCAL raylet only
            # (its pool assigns each worker a dedicated card); larger
            # shapes need the GCS's quantity accounting.
            and (
                spec.resources.get("GPU", 0) == 0
                or (
                    # Exactly one whole card: local slots are card-
                    # granular; fractional requests need the GCS's
                    # float quantity accounting.
                    spec.resources.get("GPU", 0) == 1
                    and os.environ.get("RAY_TPU_TORCH_LOCAL_RAYLET")
                )
            )
        )

    def submit_task_leased(self, spec: TaskSpec) -> Optional[List[ObjectRef]]:
        """Push a task to a leased worker; None -> route via the GCS."""
        if not self._lease_eligible(spec):
            return None
        # Flight recorder, compact form: ONE ring append per task
        # carrying the submit/queue/lease boundaries in its attrs (the
        # head expands it off the hot path — events._expand).
        _rec = _events.get_recorder()
        t_submit = time.time() if _rec.enabled else 0.0
        key = spec.scheduling_class()
        now = time.monotonic()
        with self._lease_lock:
            lease = self._claim_free_lease(key, now)
        if lease is None:
            # Back off after a failed grow: each attempt is a
            # synchronous GCS round-trip, and a saturated pool would
            # otherwise retry on every submit of a burst.
            held = self._lease_grow_held(key, now)
            lease = None if held else self._grow_lease(key, spec.resources)
            if lease is None:
                if not held:
                    self._note_lease_grow_failed(key)
                # Pool can't grow: wait in the class's backlog for the
                # next lease to drain, never behind another task on a
                # worker (see _LEASE_PIPELINE_MAX). No lease at all (or
                # one reaped meanwhile): the GCS route.
                return self._queue_leased(key, spec, t_submit)
        self._record_lease_span(spec, t_submit)
        return self._push_leased(lease, spec)

    @staticmethod
    def _record_lease_span(spec: TaskSpec, t_submit: float) -> None:
        # t_submit truthy too: recording toggled on mid-submit must not
        # ship a half-captured span (a 0.0 boundary poisons the phase
        # histograms with epoch-sized durations).
        _rec = _events.get_recorder()
        if _rec.enabled and t_submit:
            # Recorded BEFORE the push so the span is in the ring before
            # the task can possibly execute — the head aggregator drains
            # this process's ring ahead of shipped worker batches, which
            # keeps submit→…→seal ordered without cross-process sync.
            # t_queue = t_submit: the owner queues at once, so the
            # submit→lease-claim gap (the backlog's wait, if any) is
            # attributed to the lease phase.
            _rec.record(
                _events.TASK, spec.task_id.hex(), "SUBMIT_SPAN",
                {
                    "t_submit": t_submit,
                    "t_queue": t_submit,
                    "t_lease": time.time(),
                    "route": "lease",
                },
            )

    def _claim_free_lease(self, key, now: float) -> Optional[dict]:
        """A lease of the class with no task on it, claimed (caller
        holds the lease lock, so the idle reaper can't return the lease
        between selection and push)."""
        for lease in self._leases.get(key, ()):
            if lease["outstanding"] < _LEASE_PIPELINE_MAX:
                lease["outstanding"] += 1
                lease["busy_since"] = now
                return lease
        return None

    def _grow_lease(self, key, resources) -> Optional[dict]:
        """Lease one more worker for the class, claimed; None if none."""
        lease = self._acquire_lease(key, resources)
        if lease is None:
            return None
        with self._lease_lock:
            # Grow succeeded: the hold-off window resets.
            bo = self._lease_backoff.get(key)
            if bo is not None:
                bo.reset()
            self._lease_grow_hold_until.pop(key, None)
            if lease["returned"]:
                # Reaped while the grow round-trip was in flight (a
                # loaded head can stall lease_worker past the idle-
                # return window): its conn is closing and its reader
                # may already be gone — a frame pushed now would be
                # dropped with a forever-pending future.
                return None
            lease["outstanding"] += 1
            lease["busy_since"] = time.monotonic()
        return lease

    def _queue_leased(
        self, key, spec: TaskSpec, t_submit: float
    ) -> Optional[List[ObjectRef]]:
        """Queue a task at the owner until a lease of its class drains
        (reference: the owner's per-class task queue in
        direct_task_transport.cc). Its returns resolve through a future
        of their own that the eventual push (or a handoff to the head)
        settles. None when the class holds no lease to wait for."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        oids = _return_oids(spec.task_id._bytes, spec.num_returns)
        with self._lease_lock:
            lease = self._claim_free_lease(key, time.monotonic())
            if lease is None:
                if not any(not c["returned"] for c in self._leases.get(key, ())):
                    return None
                for i, ob in enumerate(oids):
                    self._lineage[ob] = spec
                    self._direct_results[ob] = (fut, i)
                self._lease_backlog.setdefault(key, collections.deque()).append(
                    (spec, fut, t_submit)
                )
                self._ensure_lease_reaper()
        if lease is not None:
            # A lease drained while the grow failed.
            self._record_lease_span(spec, t_submit)
            return self._push_leased(lease, spec)
        owner = self.worker_id.binary()
        refs = [ObjectRef(ObjectID(ob), owner) for ob in oids]
        self._advertise_returns(refs)
        return refs

    def _lease_grow_held(self, key, now: float) -> bool:
        """Inside the post-failure hold-off window for this class?"""
        return now <= self._lease_grow_hold_until.get(key, 0.0)

    def _note_lease_grow_failed(self, key) -> None:
        from .chaos import Backoff

        with self._lease_lock:
            bo = self._lease_backoff.get(key)
            if bo is None:
                bo = self._lease_backoff[key] = Backoff(
                    base_s=0.1, cap_s=2.0
                )
            self._lease_grow_hold_until[key] = (
                time.monotonic() + max(0.05, bo.next_delay())
            )

    def _raylet_conn(self) -> Optional[PeerConn]:
        """Connection to this node's raylet lease service, if any."""
        addr = os.environ.get("RAY_TPU_TORCH_LOCAL_RAYLET")
        if not addr:
            return None
        with self._lease_lock:
            conn = getattr(self, "_raylet_peer", None)
            if conn is not None and not conn.closed:
                return conn
        from . import transport

        try:
            raw = transport.connect(addr, self._authkey)
        except OSError:
            return None
        conn = PeerConn(raw, push_handler=lambda m: None, name="raylet-lease")
        with self._lease_lock:
            cur = getattr(self, "_raylet_peer", None)
            if cur is not None and not cur.closed:
                # Lost a connect race: keep the winner, drop ours.
                conn.close()
                return cur
            self._raylet_peer = conn
        return conn

    def _acquire_lease(self, key, resources) -> Optional[dict]:
        # Local dispatch first (reference: tasks submitted on a node
        # lease from its raylet, not the head — cluster_task_manager):
        # one node-local hop, the head never sees the dispatch.
        # Local slots are single-unit: multi-CPU/GPU shapes need the
        # GCS's quantity accounting (_fits/_acquire), not a 1-slot
        # grant.
        gpu_shape = bool(resources) and resources.get("GPU", 0) > 0
        simple_shape = not resources or (
            set(resources) <= {"CPU", "GPU"}
            and resources.get("CPU", 0) <= 1
            and resources.get("GPU", 0) in (0, 1)
        )
        rconn = self._raylet_conn() if simple_shape else None
        if rconn is not None:
            try:
                reply = rconn.request(
                    {"type": "lease_worker", "resources": resources},
                    timeout=5,
                )
            except (ConnectionLost, TimeoutError):
                reply = None
            if reply and reply.get("ok") and reply.get("addr"):
                lease = self._connect_lease(key, reply, raylet=True)
                if lease is not None:
                    return lease
        if gpu_shape:
            # The head's lease pool has no card; GPU tasks the local
            # raylet cannot serve take the GCS submit route.
            return None
        try:
            reply = self.conn.request(
                {"type": "lease_worker", "resources": resources}
            )
        except ConnectionLost:
            return None
        if not reply.get("ok") or not reply.get("addr"):
            return None
        return self._connect_lease(key, reply, raylet=False)

    def _connect_lease(self, key, reply, raylet: bool) -> Optional[dict]:
        from . import transport

        try:
            raw = transport.connect(reply["addr"], self._authkey)
        except OSError:
            # Worker on another machine (or gone): give the lease back.
            self._send_lease_return(reply["worker_id"], raylet)
            return None
        lease = {
            "worker_id": reply["worker_id"],
            "key": key,
            "outstanding": 0,
            "returned": False,
            "raylet": raylet,
        }
        lease["conn"] = PeerConn(
            raw, push_handler=lambda m: None, name="lease",
        )
        with self._lease_lock:
            self._leases.setdefault(key, []).append(lease)
        return lease

    def _send_lease_return(self, worker_id: bytes, raylet: bool) -> None:
        if raylet:
            # Over the connection that holds the lease, whether or not
            # this process still asks the raylet for leases: looked up
            # through $RAY_TPU_TORCH_LOCAL_RAYLET, a return made after the
            # variable was dropped was lost, and the raylet kept the
            # worker leased and its CPU taken from the head's view. A
            # closed connection gave its leases back as it closed.
            with self._lease_lock:
                rconn = getattr(self, "_raylet_peer", None)
            if rconn is not None and not rconn.closed:
                try:
                    rconn.send(
                        {"type": "return_lease", "worker_id": worker_id}
                    )
                except ConnectionLost:
                    pass
            return
        try:
            self.conn.send({"type": "return_lease", "worker_id": worker_id})
        except ConnectionLost:
            pass

    def _push_leased(
        self, lease, spec: TaskSpec, queued: Optional[concurrent.futures.Future] = None
    ) -> Optional[List[ObjectRef]]:
        """Caller must have already claimed a slot (outstanding += 1).

        Ships a compact OP_CALL frame, buffered (send_lazy): a burst of
        submissions coalesces into one wire message, and the reply
        future doubles as the per-return result slot — get() interprets
        the reply frame lazily, so the steady-state task costs one
        Future and one tuple pickle end to end. A task from the backlog
        ships at once, and the future its refs were handed out with
        (``queued``) takes the reply; it returns no refs."""
        conn: PeerConn = lease["conn"]
        tid = spec.task_id._bytes
        nret = spec.num_returns
        oids = _return_oids(tid, nret)
        req_id = conn.next_req_id()
        rfut = conn.register_future(req_id, queued)
        refs = None
        if queued is None:
            lineage = self._lineage
            for i, ob in enumerate(oids):
                lineage[ob] = spec
                self._direct_results[ob] = (rfut, i)
            owner = self.worker_id.binary()
            refs = [ObjectRef(ObjectID(ob), owner) for ob in oids]
            self._advertise_returns(refs)
        frame = (
            OP_CALL, req_id, tid, spec.function_id, None, spec.args_blob,
            nret, None, None,
        )
        self._read_barrier_workers.add(lease["worker_id"])
        try:
            conn.send_lazy(frame)
            if queued is None:
                self._mark_lazy(conn)
            else:
                conn.flush()
        except ConnectionLost:
            conn.drop_future(req_id)
            # Send failed: the task never reached the worker, so a GCS
            # resubmit is always safe.
            self._leased_conn_lost(lease, spec, oids, delivered=False)
            if queued is not None:
                queued.set_exception(ConnectionLost("leased worker lost"))
            return refs
        if conn.closed_after_push(req_id):
            # Closed between claim and push (the 1-in-200k lost-task
            # wedge): resolve through the conn-lost path;
            # delivered=True keeps at-most-once semantics in case the
            # frame flushed before the close landed.
            self._leased_conn_lost(lease, spec, oids, delivered=True)
            if queued is not None:
                queued.set_exception(ConnectionLost("leased worker lost"))
            return refs
        rfut.add_done_callback(
            lambda f, lease=lease, spec=spec, oids=oids: self._resolve_leased(
                lease, spec, oids, f
            )
        )
        return refs

    def _resolve_leased(self, lease, spec: TaskSpec, oids, rfut):
        if rfut.exception() is not None:
            self._leased_conn_lost(lease, spec, oids, delivered=True)
            return
        self._dec_lease(lease)
        self._wait_mark(oids)

    def _leased_conn_lost(self, lease, spec: TaskSpec, oids, delivered: bool):
        give_back = False
        with self._lease_lock:
            pool = self._leases.get(lease["key"], [])
            if lease in pool:
                pool.remove(lease)
            if not lease["returned"]:
                lease["returned"] = True
                give_back = True
        if give_back:
            # The worker may still be alive with only the lease conn
            # broken: give the lease back so it isn't stranded leased
            # (idempotent if the worker actually died).
            self._send_lease_return(lease["worker_id"], lease.get("raylet", False))
        if delivered and spec.max_retries <= 0:
            # May have executed: at-most-once for non-retriable tasks
            # (reference: only retriable tasks resubmit on worker crash —
            # task_manager.h:468).
            from ..exceptions import WorkerCrashedError

            blob = serialization.pack(
                WorkerCrashedError("leased worker connection lost mid-task")
            )
            for ob in oids:
                self._direct_results[ob] = {"status": "FAILED", "error": blob}
            self._wait_on_failure(oids)
            return
        if delivered:
            spec.max_retries -= 1
        for ob in oids:
            self._direct_results[ob] = {"via_gcs": True}
        self._submit_via_head(spec)
        self._wait_on_failure(oids)

    def _submit_via_head(self, spec: TaskSpec) -> None:
        try:
            # Fast path: head healthy, the resubmit lands instantly.
            # raylint: disable=raw-send-on-gcs-path -- ConnectionLost hands off to send_reliable on a side thread below; a raw drop here previously lost the resubmit across a head failover (the _report_done bug class)
            self.conn.send({"type": "submit_task", "spec": spec})
        except ConnectionLost:
            # Head mid-failover. send_reliable parks until the
            # reconnect lands — but THIS code often runs on the dying
            # leased conn's reader thread (close-sweep future
            # callbacks), and parking that thread would stall the
            # sweep's remaining futures for the whole outage window.
            # Queue for the single drainer thread (same pattern as
            # _report_done on the batcher thread); many
            # leases die together in a failover, so thread-per-spec
            # would balloon exactly when the process is degraded.
            self._queue_resubmit(spec)

    def _queue_resubmit(self, spec):
        with self._resubmit_lock:
            self._resubmit_pending.append(spec)
            t = self._resubmit_thread
            if t is not None and t.is_alive():
                return
            self._resubmit_thread = threading.Thread(
                target=self._drain_resubmits, name="resubmit-reliable",
                daemon=True,
            )
            self._resubmit_thread.start()

    def _drain_resubmits(self):
        while True:
            with self._resubmit_lock:
                if not self._resubmit_pending:
                    self._resubmit_thread = None
                    return
                spec = self._resubmit_pending.pop(0)
            try:
                self.send_reliable({"type": "submit_task", "spec": spec})
            except ConnectionLost:
                # Head permanently lost: the session is over; gets
                # fail through the head-loss path — drop the rest,
                # counted (a post-mortem must be able to tell a mass
                # resubmit discard from tasks never resubmitted).
                with self._resubmit_lock:
                    dropped = len(self._resubmit_pending) + 1
                    del self._resubmit_pending[:]
                    self._resubmit_thread = None
                if _events.enabled():
                    _events.record(
                        _events.HEAD, self.worker_id.hex()[:12],
                        "RESUBMITS_DROPPED", {"count": dropped},
                    )
                return
            except Exception as e:
                # Anything else (say, a spec that fails to serialize
                # on the reconnected conn) must not kill the drainer
                # with specs still queued behind it — count and drop
                # THIS spec, keep draining; its gets fail through the
                # normal result paths.
                if _events.enabled():
                    _events.record(
                        _events.HEAD, self.worker_id.hex()[:12],
                        "RESUBMITS_DROPPED",
                        {"count": 1, "error": type(e).__name__},
                    )

    def _dec_lease(self, lease):
        with self._lease_lock:
            lease["outstanding"] -= 1
            if lease["outstanding"] > 0:
                return
            backlog = self._lease_backlog.get(lease["key"])
            if backlog and not lease["returned"]:
                spec, fut, t_submit = backlog.popleft()
                lease["outstanding"] += 1
                lease["busy_since"] = time.monotonic()
            else:
                # Keep the lease warm: returning on drain would pay a
                # lease round-trip per burst (reference: leased workers
                # are reused across tasks of a scheduling class and
                # returned after an idle timeout).
                lease["idle_since"] = time.monotonic()
                self._ensure_lease_reaper()
                return
        # The next task of the class's backlog takes the drained lease.
        self._record_lease_span(spec, t_submit)
        self._push_leased(lease, spec, queued=fut)

    def _ensure_lease_reaper(self):
        if self._lease_reaper is None:
            self._lease_reaper = threading.Thread(
                target=self._lease_reaper_loop, name="lease-reaper", daemon=True
            )
            self._lease_reaper.start()

    def _lease_reaper_loop(self):
        while self._running():
            time.sleep(0.1)
            now = time.monotonic()
            to_return = []
            waiting = []
            with self._lease_lock:
                for key, pool in self._leases.items():
                    for lease in list(pool):
                        if (
                            lease["outstanding"] <= 0
                            and not lease["returned"]
                            and now - lease.get("idle_since", now)
                            > _LEASE_IDLE_RETURN_S
                        ):
                            lease["returned"] = True
                            pool.remove(lease)
                            to_return.append(lease)
                for key, backlog in self._lease_backlog.items():
                    if backlog:
                        stalled = all(
                            c["outstanding"] > 0
                            and now - c["busy_since"] > _LEASE_STALL_S
                            for c in self._leases.get(key, ())
                        )
                        waiting.append((key, backlog[0][0].resources, stalled))
            for lease in to_return:
                lease["conn"].close()
                if not self._running():
                    return
                self._send_lease_return(
                    lease["worker_id"], lease.get("raylet", False)
                )
            for key, resources, stalled in waiting:
                self._serve_backlog(key, resources, stalled, now)

    def _serve_backlog(self, key, resources, stalled: bool, now: float) -> None:
        """A class's backlog outlasted a reaper pass: ask for another
        lease (the backlog grows while every lease is busy); if none
        comes and every lease has stalled on a long task (ranks of a
        collective waiting for a queued rank, say), the backlog goes
        through the head, which sees the whole cluster."""
        lease = None
        if not self._lease_grow_held(key, now):
            lease = self._grow_lease(key, resources)
            if lease is None:
                self._note_lease_grow_failed(key)
        if lease is not None:
            self._dec_lease(lease)  # frees the claim: pushes the next task
            return
        if not stalled:
            return
        with self._lease_lock:
            backlog = self._lease_backlog.pop(key, None) or ()
        for spec, fut, _ in backlog:
            oids = _return_oids(spec.task_id._bytes, spec.num_returns)
            for ob in oids:
                self._direct_results[ob] = {"via_gcs": True}
            self._submit_via_head(spec)
            # Parked gets read the rewritten entry (see
            # _resolve_direct_entry); waits move to a GCS subscription.
            fut.set_exception(ConnectionLost("handed to the head"))
            self._wait_on_failure(oids)

    # ----------------------------------------------------- direct actor path

    def call_actor_fast(
        self,
        aid: bytes,
        method_name: str,
        args_blob: bytes,
        num_returns: int,
        deps: Sequence[ObjectID] = (),
        concurrency_group: Optional[str] = None,
    ) -> Optional[List[ObjectRef]]:
        """Steady-state actor call: compact frame straight down an
        established direct connection, no TaskSpec object at all.
        Returns None when the route isn't live yet (first call,
        resolving, or GCS-routed actor) — the caller falls back to the
        TaskSpec path which establishes/buffers correctly."""
        conn = self._direct_conns.get(aid)
        if conn is None or conn == "resolving" or isinstance(conn, str):
            return None
        tid = fast_unique_bytes()
        if _events.enabled():
            _events.record(_events.TASK, tid.hex(), "SUBMITTED", None)
        return self._send_frame(
            conn, aid, tid, method_name, args_blob, num_returns, deps,
            concurrency_group,
        )

    def _send_frame(
        self, conn, aid: bytes, tid: bytes, method_name: str,
        args_blob: bytes, num_returns: int, deps: Sequence[ObjectID] = (),
        concurrency_group: Optional[str] = None,
    ) -> List[ObjectRef]:
        oids = _return_oids(tid, num_returns)
        req_id = conn.next_req_id()
        rfut = conn.register_future(req_id)
        with self._direct_lock:
            pending = self._direct_oids.setdefault(aid, set())
            for i, ob in enumerate(oids):
                self._direct_results[ob] = (rfut, i)
                pending.add(ob)
        # Pin arg refs for the life of the in-flight call. The GCS route
        # pins spec.dependencies server-side (_h_submit_task task_pins);
        # the direct route bypasses the GCS, so without this the caller
        # dropping its own ref (e.g. re-broadcasting weights every step
        # while calls queue behind a deep actor backlog) frees the
        # object before the actor's arg-resolution get — which then
        # parks forever and wedges the serial actor.
        dep_ids = [d.binary() for d in deps]
        for d in dep_ids:
            self._tracker.incr(d)
        frame = (
            OP_CALL, req_id, tid, None, method_name, args_blob, num_returns,
            aid, concurrency_group,
        )
        self._read_barrier_actors.add(aid)
        owner = self.worker_id.binary()
        refs = [ObjectRef(ObjectID(ob), owner) for ob in oids]
        self._advertise_returns(refs)
        try:
            conn.send_lazy(frame)
        except ConnectionLost:
            conn.drop_future(req_id)
            for d in dep_ids:
                self._tracker.decr(d)
            self._on_direct_close(aid)
            return refs
        self._mark_lazy(conn)
        if conn.closed_after_push(req_id):
            # Closed between the route lookup and this push (an actor
            # kill's async death cleanup racing the very next call);
            # found by the lock witness's timing perturbation in
            # test_kill_actor.
            for d in dep_ids:
                self._tracker.decr(d)
            self._on_direct_close(aid)
            return refs

        def _resolved(f, oids=oids, aid=aid, dep_ids=dep_ids):
            for d in dep_ids:
                self._tracker.decr(d)
            self._resolve_direct(aid, oids, f)

        rfut.add_done_callback(_resolved)
        return refs

    def submit_actor_direct(self, spec: TaskSpec) -> Optional[List[ObjectRef]]:
        """Submit an actor method over the direct transport.

        Returns the refs when the call is (or will be) delivered
        directly or is buffered pending route resolution; None tells the
        caller to route via the GCS (restartable actors). The first call
        for an actor kicks off an async get_actor_direct lookup (the GCS
        parks it until the actor is ALIVE); calls buffer until the route
        is known so a single ordered stream flows down exactly one path —
        mixing paths could reorder a caller's calls."""
        aid = spec.actor_id.binary()
        if _events.enabled():
            _events.record(
                _events.TASK, spec.task_id.hex(), "SUBMITTED", None
            )
        with self._direct_lock:
            st = self._direct_conns.get(aid, _MISSING)
            if st is None:
                return None  # definitive: GCS route
            if st is _MISSING:
                self._direct_conns[aid] = "resolving"
                self._direct_buffer[aid] = [spec]
                rfut = self.conn.request_async(
                    {"type": "get_actor_direct", "actor_id": aid}
                )
                rfut.add_done_callback(
                    lambda f, a=aid: self._on_direct_resolved(a, f)
                )
                return self._refs_for(spec)
            if st == "resolving":
                self._direct_buffer[aid].append(spec)
                return self._refs_for(spec)
            return self._send_direct(st, spec)

    def _refs_for(self, spec: TaskSpec) -> List[ObjectRef]:
        owner = self.worker_id.binary()
        refs = [ObjectRef(oid, owner) for oid in spec.return_object_ids()]
        self._advertise_returns(refs)
        return refs

    def _on_direct_resolved(self, aid: bytes, rfut):
        try:
            reply = rfut.result()
        except BaseException:  # noqa: BLE001
            reply = {"fallback": True}
        conn = None
        if reply.get("ok") and not reply.get("fallback") and reply.get("addr"):
            from . import transport

            try:
                raw = transport.connect(reply["addr"], self._authkey)
                conn = PeerConn(
                    raw,
                    push_handler=lambda msg: None,
                    on_close=lambda a=aid: self._on_direct_close(a),
                    name="direct",
                )
            except OSError:
                conn = None
        with self._direct_lock:
            # Flush the buffer down the chosen path, then publish it —
            # all under the lock so late submitters can't jump the queue.
            buffered = self._direct_buffer.pop(aid, [])
            for spec in buffered:
                if conn is not None:
                    self._send_direct(conn, spec)
                else:
                    try:
                        self.submit(spec)
                    except ConnectionLost:
                        pass
            self._direct_conns[aid] = conn

    def _send_direct(self, conn, spec: TaskSpec) -> Optional[List[ObjectRef]]:
        return self._send_frame(
            conn,
            spec.actor_id.binary(),
            spec.task_id._bytes,
            spec.method_name,
            spec.args_blob,
            spec.num_returns,
            spec.dependencies,
            spec.concurrency_group,
        )

    def _resolve_direct(self, aid: bytes, oids, rfut) -> None:
        if rfut.exception() is not None:
            # Conn lost mid-flight: _on_direct_close (triggered by the
            # reader teardown) marks every pending oid as actor-died.
            self._on_direct_close(aid)
            return
        with self._direct_lock:
            pending = self._direct_oids.get(aid)
            if pending is not None:
                pending.difference_update(oids)
        self._wait_mark(oids)

    def _on_direct_close(self, aid: bytes) -> None:
        from ..exceptions import ActorDiedError

        with self._direct_lock:
            self._direct_conns[aid] = None
            pending = self._direct_oids.pop(aid, set())
            for ob in pending:
                if self._direct_results.pop(ob, None) is not None:
                    self._direct_results[ob] = {
                        "exception": ActorDiedError(
                            reason="actor connection lost"
                        )
                    }
        if pending:
            self._wait_on_failure(pending)

    # ------------------------------------------------------------------ objects

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID(fast_unique_bytes())
        # Ref exists (count>=1) BEFORE the directory learns of the
        # object, and the tracker knows the directory holds us as a
        # holder (put_object registers the putter) — so the eventual
        # drop sends its remove even if the add batch never went out.
        # Marked before the advert leaves: an advert sent on a head conn
        # that has just died is lost, and the reconnect's reconcile
        # re-advertises only objects already marked (marked after, a
        # reconcile between the two dropped the object for good, and a
        # task depending on it waited at the new head forever).
        ref = ObjectRef(oid, self.worker_id.binary())
        self._tracker.mark_advertised(oid.binary())
        try:
            self.put_with_id(oid, value, owned=True)
        except BaseException:
            self._tracker.forget([oid.binary()])
            raise
        return ref

    def put_with_id(self, oid: ObjectID, value: Any,
                    owned: bool = False) -> Dict[str, Any]:
        """Seal a value; small values inline through the GCS, large ones go
        to the shm store (reference: max_direct_call_object_size split
        between memory store and plasma). ``owned``: this process owns
        the object (put), so it keeps an inline-only value's bytes for a
        head failover's reconcile."""
        from ..object_ref import _CaptureRefs

        with _CaptureRefs() as cap:
            payload, buffers = serialization.dumps(value)
        size = serialization.serialized_size(payload, buffers)
        if size <= RayConfig.max_inline_object_size:
            blob = bytearray(size)
            serialization.write_to(memoryview(blob), payload, buffers)
            blob = bytes(blob)
            fields = {"object_id": oid.binary(), "inline": blob, "size": size}
            # Node-segment copy for small values too (zero extra
            # syscalls — one pool create under the shm mutex): it is
            # what same-host readers hit with zero head round-trips,
            # and the local bearer of truth reconcile re-advertises
            # after a head failover — which is what makes the advert
            # below safe to fire-and-forget.
            try:
                loc = self.store.try_pool_put_packed(oid, blob)
            except Exception:  # noqa: BLE001 - pool mid-close
                self._pool_put_errors = getattr(
                    self, "_pool_put_errors", 0
                ) + 1
                loc = None
            if loc is not None:
                fields["segment"] = loc
            elif owned:
                # No store here holds it: the head's copy is the only
                # one, and a head killed before its next persist loses
                # it, acknowledged or not. Kept for the reconcile (the
                # reference's owner holds small objects in its own
                # memory store).
                self._tracker.keep_inline(oid.binary(), blob)
        else:
            name = object_segment_put(self.store, oid, payload, buffers, size)
            fields = {"object_id": oid.binary(), "segment": name, "size": size}
        if cap.seen:
            # Refs nested inside the stored value: the directory pins them
            # while this object lives (borrowing — reference_count.h:61).
            fields["children"] = cap.seen
        if fields.get("segment") is not None and not cap.seen:
            # Async advert (the put fast path): the value is sealed in
            # the local store, so the directory learns of it via a
            # buffered fire-and-forget frame — zero blocking round
            # trips per put. Safe because (a) frames on one conn are
            # FIFO, so any later submit/free naming this object lands
            # after the advert; (b) chaos faults never target
            # put_object; (c) on conn loss the reconnect reconcile
            # re-advertises every owned object from store.location_of.
            # Values with captured child refs stay synchronous: the
            # children pins ride the advert and must survive failover.
            self._advert_async({"type": "put_object", **fields})
            return fields
        reply = self.request_reliable({"type": "put_object", **fields})
        if not reply.get("ok"):
            raise RayTpuError(f"put failed: {reply}")
        return fields

    def _advert_async(self, msg: Dict[str, Any]) -> None:
        rec = _events.get_recorder()
        if rec.enabled:
            rec.record(
                _events.OBJECT, ObjectID(msg["object_id"]).hex(),
                "SHM_PUT_ADVERT", {"size": msg.get("size", 0)},
            )
        try:
            self.conn.send_lazy(msg)
        except ConnectionLost:
            return  # reconcile re-advertises from the store on reconnect
        self._mark_lazy(self.conn)

    def _materialize(self, reply: Dict[str, Any], oid: ObjectID,
                     _retried: bool = False, packed: bool = False,
                     timeout: Optional[float] = None) -> Any:
        from ..exceptions import ObjectLostError

        if reply.get("status") == "FAILED":
            err = serialization.unpack(reply["error"])
            if isinstance(err, RayTaskError):
                raise err.as_instanceof_cause()
            raise err
        if reply.get("status") == "LOST":
            raise ObjectLostError(f"object {oid.hex()} lost (node died)")
        if reply.get("inline") is not None:
            if packed:
                return bytes(reply["inline"])
            return serialization.unpack(reply["inline"])
        spilled = reply.get("spilled_path")
        if spilled is not None and not self.store.contains(oid):
            # Restore rung of the memory-pressure ladder: the object was
            # spilled to disk under pool pressure. Same-host: read the
            # file directly (header + checksum validated — truncated
            # bytes are never returned); cross-node: fall through to the
            # transfer plane (the owner's transfer server restores from
            # its spill dir).
            from .object_store import SpillCorruptionError, read_spill_file

            try:
                data = read_spill_file(spilled)
                return data if packed else serialization.unpack(data)
            except SpillCorruptionError:
                # Bad file: tell the head so the entry resolves LOST
                # (reconstruct from lineage) instead of every future get
                # re-reading garbage; fall through to the other copies.
                try:
                    self.send_reliable(
                        {"type": "spill_corrupt", "object_id": oid.binary()}
                    )
                except (ConnectionLost, RayTpuError):
                    pass
            except OSError:
                pass
        # Cross-node: the object's primary copy lives on another node —
        # pull it into the local store first, through the admission-
        # controlled pull manager (reference: raylet PullManager
        # fetching via the object directory).
        owner_node = reply.get("node_id")
        if (
            owner_node is not None
            and owner_node != self.node_id
            and not self.store.contains(oid)
        ):
            addr = reply.get("transfer_addr")

            def _relead(slow_addr: str):
                # Hedged pull: the current holder is below the
                # throughput floor — ask the directory again and move to
                # wherever the primary copy lives now. Same answer is
                # fine too (the fetcher reconnected already); returning
                # None just keeps the current lead.
                try:
                    fresh = self.request_reliable(
                        {"type": "get_object", "object_id": oid.binary()}
                    )
                except (ConnectionLost, RayTpuError):
                    return None
                new_addr = fresh.get("transfer_addr")
                if not new_addr or fresh.get("node_id") == self.node_id:
                    return None
                return new_addr

            # The caller's remaining get budget covers BOTH the
            # admission queue wait and the chunk fetch — a pull parked
            # behind a saturated budget must not fail a patient get.
            if not addr or not self._pull_manager.pull(
                oid, addr, size=reply.get("size") or 0, timeout=timeout,
                resolve=_relead,
            ):
                raise ObjectLostError(
                    f"object {oid.hex()} on node "
                    f"{owner_node.hex()[:8]} could not be fetched"
                )
        try:
            if packed:
                view = self.store.get_raw(oid)
                if view is None:
                    raise FileNotFoundError(oid.hex())
                try:
                    return bytes(view)
                finally:
                    del view
                    self.store.release_raw(oid)
            return self.store.get(oid)
        except FileNotFoundError:
            if not _retried:
                # The copy may have moved while this reply was in
                # flight (spilled to disk between directory lookup and
                # our read): ask the directory again once.
                fresh = self.request_reliable(
                    {"type": "get_object", "object_id": oid.binary()}
                )
                return self._materialize(fresh, oid, _retried=True,
                                         packed=packed, timeout=timeout)
            # Directory says READY but the data is gone (evicted).
            raise ObjectLostError(
                f"object {oid.hex()} missing from the local store (evicted)"
            ) from None

    def _materialize_or_reconstruct(
        self, reply: Dict[str, Any], ref: ObjectRef, remaining: Optional[float],
        packed: bool = False,
    ) -> Any:
        """Materialize; on loss, resubmit the producing task from lineage
        and retry (reference: ObjectRecoveryManager
        object_recovery_manager.h:41 + TaskManager::ResubmitTask
        task_manager.h:269 — the owner reconstructs)."""
        from ..exceptions import ObjectLostError

        oid = ref.id()
        for _ in range(3):
            try:
                return self._materialize(reply, oid, packed=packed,
                                         timeout=remaining)
            except ObjectLostError:
                spec = self._lineage.get(oid.binary())
                if spec is None:
                    raise
                self.send_reliable({"type": "submit_task", "spec": spec})
                reply = self.request_reliable(
                    {"type": "get_object", "object_id": oid.binary()},
                    timeout=remaining,
                )
        return self._materialize(reply, oid, packed=packed,
                                 timeout=remaining)

    def _resolve_direct_entry(
        self, ref: ObjectRef, entry, remaining: Optional[float]
    ) -> Dict[str, Any]:
        """Turn a _direct_results entry — (reply_future, index) or an
        already-resolved fields dict — into result fields, consuming it."""
        idb = ref.id().binary()
        if type(entry) is tuple:
            rfut, idx = entry
            try:
                reply = rfut.result(timeout=remaining)
            except (TimeoutError, concurrent.futures.TimeoutError):
                # Both: only Python 3.11 unified futures.TimeoutError
                # with the builtin.
                raise GetTimeoutError(f"get timed out on {ref}") from None
            except BaseException:
                # Connection lost: the failure callback rewrites the
                # entry with the outcome (resubmitted via GCS, failed,
                # actor died). Callbacks run just after waiters wake —
                # spin briefly for the rewrite.
                stop = time.monotonic() + 2.0
                while True:
                    e2 = self._direct_results.get(idb)
                    if isinstance(e2, dict):
                        entry = e2
                        break
                    if time.monotonic() > stop:
                        raise
                    time.sleep(0.001)
            else:
                # Consumed: later gets resolve through the GCS directory
                # (the worker's batched task_done seals results there).
                self._direct_results.pop(idb, None)
                if reply[2] is not None:
                    return {"status": "FAILED", "error": reply[2]}
                r = reply[3][idx]
                return {
                    "status": "READY",
                    "inline": r[0],
                    "segment": r[1],
                    "size": r[2],
                }
        # Sentinel dicts stay in place: the GCS never saw these tasks,
        # so a repeat get must find the sentinel again (popping it would
        # strand the second get on a directory entry that never seals).
        exc = entry.get("exception")
        if exc is not None:
            raise exc
        return entry

    def _gcs_get_fields(
        self, ref: ObjectRef, fut, deadline: Optional[float]
    ) -> Dict[str, Any]:
        """Resolve one GCS-routed get_object, riding out a head
        failover: a request parked on a connection that dies re-issues
        on the reconnected head (which re-parks it as a waiter; the
        recovery sweep answers LOST for entries nobody reclaims, so the
        get resolves into lineage reconstruction instead of wedging)."""
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(f"get timed out on {ref}")
            if fut is not None:
                try:
                    return fut.result(timeout=remaining)
                except (TimeoutError, concurrent.futures.TimeoutError):
                    # Both: only Python 3.11 unified futures.TimeoutError
                    # with the builtin.
                    raise GetTimeoutError(
                        f"get timed out on {ref}"
                    ) from None
                except ConnectionLost:
                    fut = None  # fall through to the failover retry
            if not self._await_failover():
                raise ConnectionLost("GCS connection lost during get")
            try:
                fut = self.conn.request_async(
                    {"type": "get_object", "object_id": ref.id().binary()}
                )
            except ConnectionLost:
                fut = None  # reconnected conn died again: loop

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None,
            packed: bool = False) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        self.flush_lazy()
        # Pipeline: fire every get_object request up front, then collect —
        # a batch of N costs one round-trip of latency, not N (reference:
        # the core worker batches plasma fetches in Get, core_worker.cc).
        rec = _events.get_recorder()
        futs = []
        for ref in refs:
            entry = self._direct_results.get(ref.id().binary())
            if entry is not None:
                # Direct call result: resolves on the direct socket,
                # no GCS round-trip.
                futs.append((ref, entry, _GET_DIRECT))
                continue
            # Local-first: a sealed same-host copy (node shm segment or
            # fallback segment) serves the get with zero RPCs — objects
            # are immutable once sealed, so no directory consult can
            # change the bytes. A copy that vanishes between this check
            # and the read (spilled/freed mid-flight) falls back to the
            # directory inside _materialize's retry.
            if self.store.contains(ref.id()):
                if rec.enabled:
                    rec.record(
                        _events.OBJECT, ref.id().hex(), "SHM_GET_LOCAL", {}
                    )
                futs.append((ref, {"status": "READY"}, _GET_LOCAL))
                continue
            try:
                fut = self.conn.request_async(
                    {"type": "get_object", "object_id": ref.id().binary()}
                )
            except ConnectionLost:
                # Head mid-restart: the collection loop re-issues
                # this one after the failover lands.
                fut = None
            futs.append((ref, fut, _GET_GCS))
        out = []
        for ref, ent, kind in futs:
            remaining = None
            direct = kind is _GET_DIRECT
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(f"get timed out on {ref}")
            if direct:
                fields = self._resolve_direct_entry(ref, ent, remaining)
            elif kind is _GET_LOCAL:
                fields = ent
            else:
                fields = self._gcs_get_fields(ref, ent, deadline)
            if direct and (
                fields.get("via_gcs")
                or (
                    fields.get("inline") is None
                    and fields.get("status") != "FAILED"
                    and not self.store.contains(ref.id())
                )
            ):
                # Resubmitted via the GCS, or a large result not in the
                # local store: the directory has (or will have) the
                # authoritative location.
                fields = self.request_reliable(
                    {"type": "get_object", "object_id": ref.id().binary()},
                    timeout=remaining,
                )
            out.append(
                self._materialize_or_reconstruct(
                    fields, ref, remaining, packed=packed
                )
            )
        return out

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """Push-based wait: zero head round-trips in steady state.

        Each id is classified ONCE (across all wait calls on it): ids
        with an in-flight direct future get completion callbacks, the
        rest are covered by a single GCS subscription whose readiness
        arrives as ("RDY", ids) pushes. After that, every wait() call is
        a pure in-process partition against the ready set under a
        condvar — the drain-by-wait loop (reference ray_perf
        wait_multiple_refs) costs O(n) set lookups per call and no wire
        traffic (reference: raylet/wait_manager.h)."""
        refs = list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        self.flush_lazy()
        cond = self._wait_cond
        ready_set = self._wait_ready
        interest = self._wait_interest
        tracked = self._wait_tracked
        direct = self._direct_results
        to_subscribe: List[bytes] = []
        with cond:
            for r in refs:
                oid = r._id._bytes
                if oid in tracked:
                    # Already classified by an earlier wait() on this
                    # id: one set probe, no re-registration — the
                    # drain-by-wait loop registers each id exactly once.
                    continue
                self._wait_stats["registered"] += 1
                tracked.add(oid)
                entry = direct.get(oid)
                if entry is None:
                    # GCS-routed (task result, put, foreign ref):
                    # subscribe once; the head replies with the already-
                    # sealed subset and pushes the rest as they seal.
                    interest.add(oid)
                    if oid not in self._wait_subscribed:
                        self._wait_subscribed.add(oid)
                        to_subscribe.append(oid)
                elif type(entry) is tuple:
                    fut = entry[0]
                    if fut.done() and fut.exception() is None:
                        ready_set.add(oid)
                    else:
                        # In flight (or failing): _resolve_leased/
                        # _resolve_direct mark success, the conn-lost
                        # handlers re-classify through _wait_on_failure.
                        interest.add(oid)
                else:
                    # Sentinel dict: resolved locally, unless the task
                    # was resubmitted through the GCS.
                    if entry.get("via_gcs"):
                        interest.add(oid)
                        if oid not in self._wait_subscribed:
                            self._wait_subscribed.add(oid)
                            to_subscribe.append(oid)
                    else:
                        ready_set.add(oid)
        if to_subscribe:
            # Synchronous: the old check_ready always performed one
            # readiness round-trip even with timeout=0 — "check once"
            # callers must see objects already sealed at the GCS.
            reply = self.request_reliable(
                {"type": "wait_subscribe", "object_ids": to_subscribe}
            )
            already = reply.get("ready")
            if already:
                self._wait_mark(already, subscribed=True)
        while True:
            with cond:
                if self._head_conn_lost and not self.conn_failover_pending():
                    # Head gone for good. While a failover reconnect is
                    # still possible the wait parks instead: the replay
                    # re-subscribes every id and the condvar is notified
                    # on both reconnect success and final failure.
                    raise ConnectionLost("GCS connection lost during wait")
                if num_returns == 1:
                    # Drain-loop fast path: results complete roughly in
                    # submission order, so the first ready ref sits near
                    # the front — scan to it (no per-element appends) and
                    # build the rest as two C-level slices.
                    hit = -1
                    i = 0
                    for r in refs:
                        if r._id._bytes in ready_set:
                            hit = i
                            break
                        i += 1
                    if hit >= 0:
                        return [refs[hit]], refs[:hit] + refs[hit + 1:]
                elif _fp is not None:
                    part = _fp.wait_partition(refs, ready_set, num_returns)
                    if part is not None:
                        return part
                else:
                    part = self._wait_split(refs, num_returns)
                    if part is not None:
                        return part
                if deadline is None:
                    cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # Timed out: partial result — whatever is ready
                        # (fewer than num_returns), rest unchanged.
                        ready = [
                            r for r in refs if r._id._bytes in ready_set
                        ][:num_returns]
                        got = {id(r) for r in ready}
                        rest = [r for r in refs if id(r) not in got]
                        return ready, rest
                    cond.wait(remaining)

    def _wait_split(
        self, refs, num_returns: int
    ) -> Optional[Tuple[List[ObjectRef], List[ObjectRef]]]:
        """Partition refs against the ready set; None if not enough
        ready yet (caller holds the wait condvar)."""
        ready_set = self._wait_ready
        ready: List[ObjectRef] = []
        rest: List[ObjectRef] = []
        nready = 0
        for r in refs:
            if nready < num_returns and r._id._bytes in ready_set:
                ready.append(r)
                nready += 1
            else:
                rest.append(r)
        if nready < num_returns:
            return None
        return ready, rest

    def free(self, refs: Sequence[ObjectRef]):
        ids = [r.id().binary() for r in refs]
        with self._direct_lock:
            for oid in ids:
                self._direct_results.pop(oid, None)
        # Queued pulls for a freed object cancel now — their budget
        # share activates the next request instead of fetching data
        # nobody can reference (reference: pull cancellation on
        # ref-drop, pull_manager.h).
        for oid in ids:
            self._pull_manager.cancel(oid)
        self._wait_prune(ids)
        # Explicit free: drop tracker state so the instances still alive
        # can't emit retractions for entries already gone.
        self._tracker.forget(ids)
        self.send_reliable({"type": "free_objects", "object_ids": ids})
        # Drop our local copies (pulled replicas / remote-driver puts);
        # the GCS fan-out only reaches node daemons, not this process.
        for r in refs:
            try:
                self.store.delete(r.id())
            except Exception:  # noqa: BLE001
                pass

    # ---------------------------------------------------------------------- kv

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True, ns: str = "") -> bool:
        r = self.conn.request(
            {"type": "kv_put", "key": key, "value": value, "overwrite": overwrite, "ns": ns}
        )
        return r.get("added", False)

    def kv_get(self, key: bytes, ns: str = "") -> Optional[bytes]:
        return self.conn.request({"type": "kv_get", "key": key, "ns": ns}).get("value")

    def kv_del(self, key: bytes, ns: str = "") -> bool:
        return self.conn.request({"type": "kv_del", "key": key, "ns": ns}).get("deleted", False)

    def kv_exists(self, key: bytes, ns: str = "") -> bool:
        return self.conn.request({"type": "kv_exists", "key": key, "ns": ns}).get("exists", False)

    def kv_keys(self, prefix: bytes = b"", ns: str = "") -> List[bytes]:
        return self.conn.request({"type": "kv_keys", "prefix": prefix, "ns": ns}).get("keys", [])

    # ------------------------------------------------------------------- misc

    def cluster_info(self) -> Dict[str, Any]:
        # A state read, not a bare request: health signals recorded in
        # this process's ring (a puller's PULL_RELEAD naming a slow
        # provider) must reach the head's scorer no later than the poll
        # that asks about node health — a bare request would leave a
        # driver-observed straggler invisible until some unrelated
        # state read happened to flush the ring.
        return self.state_read({"type": "cluster_info"})

    def request(self, msg: Dict[str, Any], timeout: Optional[float] = None) -> Dict[str, Any]:
        # Failover-transparent: control-plane requests (kv, actor
        # lookups, cluster info, state reads) park across a head
        # restart and re-issue, instead of surfacing ConnectionLost to
        # every API caller mid-failover.
        return self.request_reliable(msg, timeout=timeout)

    def flush_runtime_events(self) -> None:
        """Ship this process's flight-recorder ring to the head.

        Workers normally piggyback on the done-batcher flush and the
        head/driver shares a process with the aggregator; this covers
        the remaining case (remote drivers) and is harmless elsewhere
        (drain is destructive, so nothing double-ships)."""
        rec = _events.get_recorder()
        if not len(rec) and not rec.dropped:
            return
        msg = {"type": "event_batch", "source": rec.source}
        items, dropped = rec.attach(msg)
        try:
            self.conn.send(msg)
        except ConnectionLost:
            rec.count_lost(items, dropped)

    def state_read(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """A request that reads task/object state: flushes this
        process's own coalesced completion records first, and names the
        workers and actors it pushed calls to since its last read (the
        head's barrier waits for their batched completions), so the
        answer includes everything this process has already observed
        finish."""
        workers, self._read_barrier_workers = self._read_barrier_workers, set()
        actors, self._read_barrier_actors = self._read_barrier_actors, set()
        if workers:
            msg["flush_workers"] = list(workers)
        if actors:
            msg["flush_actors"] = list(actors)
        if self.pre_state_read_flush is not None:
            self.pre_state_read_flush()
        if self.role != "worker":
            # Workers flush via their done batcher (pre_state_read_flush
            # piggybacks the ring); non-worker clients ship here so a
            # remote driver's submission events reach the aggregator
            # before its own read is answered.
            self.flush_runtime_events()
        return self.request(msg)

    def send(self, msg: Dict[str, Any]) -> None:
        self.conn.send(msg)

    def close(self):
        # Mark the session over BEFORE closing the conn: the close
        # handler must not launch a reconnect against a head we are
        # deliberately leaving, and watchers parked on
        # head_permanently_lost must exit now.
        self._closing = True
        self.head_permanently_lost.set()
        self.conn.close()
        rp = getattr(self, "_raylet_peer", None)
        if rp is not None:
            rp.close()
        self._pull_manager.close()
        self._fetcher.close()
        self.store.close()


def object_segment_put(store: ObjectStore, oid: ObjectID, payload, buffers, size) -> str:
    return store.put_serialized(oid, payload, buffers, size)
