"""Global control service: the cluster control plane.

Reference: src/ray/gcs/gcs_server/ — GcsServer owns node membership, the
actor directory + scheduler, jobs, placement groups, internal KV and the
function table (gcs_server.cc:138,187-232). The reference splits
scheduling between GCS (actors, PGs) and per-node raylets (task leases,
local dispatch — raylet/node_manager.h:119, cluster_task_manager.cc:44).
In this rebuild the single-host control plane folds both roles into one
authority: the GCS holds the (eventually-multi-node) resource view and
does lease + dispatch directly, removing the spillback round-trips the
reference needs because its resource view is only eventually consistent.
Node abstractions are kept so a multi-node topology (one GCS per cluster,
N virtual nodes with their own worker pools) runs in one process tree,
mirroring the reference's Cluster test harness
(python/ray/cluster_utils.py:135).

Tables owned here:
  - object directory: id -> (inline bytes | shm segment), waiters
  - function table: function_id -> cloudpickle blob
  - actor directory: id -> (worker, state machine PENDING/ALIVE/DEAD)
  - node table + resource view (total/available per node)
  - placement groups: bundles reserved against node resources
  - internal KV

Every ``_h_*`` method is a dispatch-thread message handler: at task-
storm rates the dispatch loop is the cluster's throughput bottleneck,
so nothing reachable from a handler may sleep, do file/socket IO, or
mutate the object plane's guarded refcount state (raylint
no-blocking-on-dispatch / thread-domain enforce both statically; the
GUARD hook in object_plane/directory.py enforces the latter at
runtime in tests).
"""
# raylint: dispatch-handlers=_h_*
from __future__ import annotations

import math
import os
import queue
import random
import subprocess
import sys
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from multiprocessing.connection import Listener
from typing import Any, Dict, List, Optional, Set, Tuple

from . import chaos as _chaos
from . import events as _events
from .accelerators import GPUAcceleratorManager
from .config import RayConfig, unlink_worker_socket
from .object_plane import directory as _objdir
from .ids import ActorID, NodeID, ObjectID, PlacementGroupID, WorkerID
from .object_store import ObjectStore
from .protocol import ConnectionLost, PeerConn
from .task_spec import TaskSpec

# Object status
PENDING, READY, FAILED, LOST = "PENDING", "READY", "FAILED", "LOST"
# Actor states (reference: src/ray/design_docs/actor_states.rst)
A_PENDING, A_ALIVE, A_RESTARTING, A_DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"
# Worker states
W_STARTING, W_IDLE, W_BUSY, W_ACTOR, W_DEAD, W_LEASED = (
    "STARTING",
    "IDLE",
    "BUSY",
    "ACTOR",
    "DEAD",
    "LEASED",
)


@dataclass
class ObjectEntry:
    status: str = PENDING
    inline: Optional[bytes] = None
    segment: Optional[str] = None
    size: int = 0
    error: Optional[bytes] = None  # serialized exception when FAILED
    node_id: Optional[NodeID] = None
    # (peer, req_id) blocked gets to answer on seal.
    waiters: List[Tuple[PeerConn, int]] = field(default_factory=list)
    # (peer, oid) one-shot wait subscriptions: pushed ("RDY", [oid]) on
    # seal (reference: raylet/wait_manager.h push-completion waits).
    subscribers: List[Tuple[PeerConn, bytes]] = field(default_factory=list)
    # Object plane (reference: reference_count.h:61 +
    # ownership_based_object_directory.h). ``owner`` is the worker id
    # of the client that created the object; its process keeps the
    # authoritative instance/borrow counts and batches only the final
    # ``release`` edge here (owner_released). ``holders`` is the
    # head-fallback holder set: authoritative for ownerless entries
    # (owner None — detached/stream/promoted objects), a shadow of the
    # relayed borrow edges for owned ones (used to promote on owner
    # death). Pins from in-flight task dependencies and from parent
    # objects whose values embed this ref stay head-side either way.
    owner: Optional[bytes] = None
    owner_released: bool = False
    holders: Set[bytes] = field(default_factory=set)
    had_holder: bool = False
    task_pins: int = 0
    child_pins: int = 0
    children: List[bytes] = field(default_factory=list)
    # Memory-pressure ladder (reference: local_object_manager.h:41):
    # cold sealed objects spill to disk under pool pressure; gets read
    # the file (or restore through the transfer plane cross-node).
    spilled_path: Optional[str] = None
    last_access: float = 0.0
    # Owner-death grace (monotonic deadline, 0 = none): an entry
    # promoted to head-fallback when its owner died is not reclaimable
    # until this passes — a borrow edge buffered in the borrower's
    # unflushed (or in-retransmit) ref_flush batch must be able to land
    # on the holder shadow before the head frees the object.
    promoted_hold_until: float = 0.0


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    node_id: NodeID
    state: str = W_STARTING
    conn: Optional[PeerConn] = None
    proc: Optional[subprocess.Popen] = None
    pid: int = 0
    current_task: Optional[TaskSpec] = None
    task_started_at: float = 0.0  # OOM killing policy: newest-first
    # Set (under the GCS lock) before a deliberate kill so the racing
    # conn-close death handler reports the intended cause, not a
    # generic crash.
    death_reason_hint: str = ""
    actor_id: Optional[ActorID] = None
    # Dispatched-but-unfinished specs (task_id -> spec); failed on death.
    inflight: Dict[bytes, TaskSpec] = field(default_factory=dict)
    # Startup reaping: remote spawns have proc=None, so a raylet that
    # never delivers the worker is caught by register-timeout instead.
    spawned_at: float = field(default_factory=time.time)
    # GPU worker: the number of cards it was spawned to see (reference:
    # accelerator visibility env vars set per worker —
    # _private/accelerators/nvidia_gpu.py CUDA_VISIBLE_DEVICES), and on
    # the head node their ids. Workers of 0 are pinned to no card
    # (CUDA_VISIBLE_DEVICES="") so they never contend for one.
    gpus: int = 0
    gpu_ids: Tuple[str, ...] = ()
    # Direct actor-call socket served by the worker process (reference:
    # actor calls bypass raylets — direct_actor_task_submitter.h).
    direct_addr: str = ""
    # Shared actor host: packs many sub-core actors into one process
    # (see RayConfig.max_actors_per_worker). `packed` maps hosted
    # actor id -> its creation spec (for per-actor resource release and
    # restart bookkeeping on host death).
    actor_host: bool = False
    packed: Dict[bytes, TaskSpec] = field(default_factory=dict)
    # Resources held while leased to a client (direct task transport).
    lease_resources: Optional[Dict[str, float]] = None
    # A node daemon's own pool worker (its local lease authority): the
    # GCS holds it as LEASED for good and never schedules onto it;
    # whether a client holds it shows only in the daemon's heartbeat.
    local_only: bool = False


@dataclass
class ActorState:
    actor_id: ActorID
    spec: TaskSpec
    state: str = A_PENDING
    worker_id: Optional[WorkerID] = None
    name: Optional[str] = None
    pending: deque = field(default_factory=deque)  # method specs buffered pre-ALIVE
    restarts_used: int = 0
    death_reason: str = ""
    # Parked get_actor_direct lookups, answered on ALIVE/DEAD transition.
    direct_waiters: List[Tuple[PeerConn, int]] = field(default_factory=list)
    # Incarnation fence: bumped on every restart (worker death, head
    # failover sweep). Dispatched method specs and their done records
    # carry the epoch, so a falsely-dead incarnation's late results can
    # never seal — at-most-once is preserved across false death.
    epoch: int = 1


@dataclass
class NodeState:
    node_id: NodeID
    total: Dict[str, float]
    available: Dict[str, float]
    alive: bool = True
    # Fungible (non-actor) worker ids on this node.
    pool: Set[bytes] = field(default_factory=set)
    # Shared actor hosts on this node (worker ids with actor_host=True):
    # packable creations scan this, not the cluster worker table.
    actor_hosts: Set[bytes] = field(default_factory=set)
    label: str = ""
    # Multi-host: the node daemon's control connection (None for the head
    # node and for virtual nodes, whose workers the GCS spawns directly),
    # and the address of its chunked object-transfer server
    # (reference: raylet NodeManager + embedded ObjectManager).
    conn: Optional[PeerConn] = None
    transfer_addr: str = ""
    # Liveness bookkeeping rides time.monotonic() (NOT wall clock): a
    # wall step — NTP slew, VM resume — must never mass-declare live
    # nodes dead (the health sweep compares against monotonic now).
    last_heartbeat: float = 0.0
    # Membership fence: granted by the head at registration, bumped
    # when the death sweeper declares the node dead. Heartbeats carry
    # it; a stale incarnation gets a FENCED push instead of being
    # applied.
    incarnation: int = 0
    # Remote drivers register as zero-resource nodes (their store serves
    # pulls) but never receive dispatched work.
    schedulable: bool = True
    # Graceful drain (reference: node_manager.h:551 HandleDrainRaylet):
    # a draining node takes no new work; it is removed once its running
    # tasks finish or the deadline passes.
    draining: bool = False
    drain_deadline: float = 0.0
    drain_reason: str = ""
    # Monotonic time the drain began: the daemon's local lease counts
    # are trusted once a heartbeat sent after it has arrived.
    drain_started: float = 0.0
    # CPUs the node's daemon has leased to local clients, synced via
    # heartbeats (the daemon's local dispatch authority).
    local_cpus_in_use: float = 0.0
    local_gpus_in_use: float = 0.0
    # --- gray-failure health (scored by _score_nodes each sweep) ---
    # EWMA in [0,1]; 1.0 = healthy. Derived from heartbeat
    # inter-arrival jitter, lease-grant→ack transit, per-task exec
    # overrun, and pull re-lead attribution. EWMA + the consecutive-
    # window counters below give hysteresis: one blip never flips
    # state, readmission needs sustained health.
    health_score: float = 1.0
    # Monotonic timestamp of the previous heartbeat (inter-arrival).
    prev_heartbeat: float = 0.0
    # Worst heartbeat inter-arrival gap and grant→ack transit observed
    # since the last scoring sweep (reset each sweep).
    hb_gap_max: float = 0.0
    grant_lat_max: float = 0.0
    # Pull re-leads attributed to this node's transfer server and exec
    # overruns observed since the last sweep.
    releads: int = 0
    overruns: int = 0
    # Quarantine (NOT the fence path): no new leases or pull leads;
    # existing work finishes or hedges away; readmitted after
    # readmit_windows consecutive healthy sweeps. Only true silence
    # escalates to the partition fence.
    quarantined: bool = False
    quarantined_at: float = 0.0
    healthy_windows: int = 0
    suspect: bool = False
    # Hedge scoreboard (surfaced by list_cluster_nodes).
    hedges_won: int = 0
    hedges_lost: int = 0


@dataclass
class BundleState:
    resources: Dict[str, float]
    available: Dict[str, float]
    node_id: Optional[NodeID] = None


@dataclass
class PlacementGroupState:
    pg_id: PlacementGroupID
    bundles: List[BundleState]
    strategy: str
    state: str = "PENDING"  # PENDING | CREATED | REMOVED
    name: str = ""
    waiters: List[Tuple[PeerConn, int]] = field(default_factory=list)


class _PendingQueue:
    """Pending tasks bucketed by scheduling class (reference:
    cluster_task_manager's per-SchedulingClass queues,
    scheduling_class_util.h). The head-scaling property: placement
    feasibility for a *plain* task (no PG, no strategy) depends only on
    its resource shape, so when the head of a class queue can't place,
    the whole class is blocked — one O(nodes) scan per class per pass
    instead of per task. A 200k-deep queue over 1k nodes costs
    O(classes + grants) per pass, not O(200k x 1k).

    Tasks with placement groups or scheduling strategies keep per-task
    placement state and go to the `special` queue (scanned fully, like
    the old single-deque pass — these are rare relative to bulk task
    fans)."""

    __slots__ = ("classes", "special")

    def __init__(self):
        # key -> deque; key = (resource shape, actor_creation) — the
        # creation flag changes pool-growth rules (_schedule_once).
        self.classes: "OrderedDict[Any, deque]" = OrderedDict()
        self.special: deque = deque()

    @staticmethod
    def _key(spec: TaskSpec):
        if (
            spec.placement_group_id is not None
            or spec.scheduling_strategy is not None
        ):
            return None
        return (spec.scheduling_class(), spec.actor_creation)

    def append(self, spec: TaskSpec) -> None:
        key = self._key(spec)
        if key is None:
            self.special.append(spec)
        else:
            q = self.classes.get(key)
            if q is None:
                q = self.classes[key] = deque()
            q.append(spec)

    def extend(self, specs) -> None:
        for s in specs:
            self.append(s)

    def __len__(self) -> int:
        return len(self.special) + sum(
            len(q) for q in self.classes.values()
        )

    def __bool__(self) -> bool:
        return bool(self.special) or bool(self.classes)

    def __iter__(self):
        yield from self.special
        for q in self.classes.values():
            yield from q

    def remove_returning(self, oid: bytes) -> Optional[TaskSpec]:
        """Takes out and returns the queued task one of whose returns is
        `oid`; None when no queued task has it."""
        for key, q in [(None, self.special), *self.classes.items()]:
            for spec in q:
                if any(r.binary() == oid for r in spec.return_object_ids()):
                    q.remove(spec)
                    if key is not None and not q:
                        del self.classes[key]
                    return spec
        return None


class _Unschedulable(Exception):
    """Task can never be placed (bad/removed PG); fail instead of requeue."""


def _gpus_needed(spec: TaskSpec) -> int:
    """The cards a worker must see to run `spec`: its GPU request rounded
    up, so a fractional request still runs on one card."""
    return math.ceil(spec.resources.get("GPU", 0))


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())


def _acquire(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


def _release(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) + v


class GcsServer:
    def __init__(self, session_dir: str, address: str, authkey: bytes,
                 head_resources: Dict[str, float],
                 tcp_port: Optional[int] = None,
                 head_transfer_addr: str = ""):
        self.session_dir = session_dir
        self.address = address
        self.authkey = authkey
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        # An autoscaler announced itself: capacity is elastic, so PGs
        # exceeding CURRENT totals queue PENDING as autoscaler demand
        # instead of failing fast (reference:
        # gcs_placement_group_manager keeps infeasible PGs pending).
        self.autoscaling_hint = False

        # Sharded object directory (object_plane/directory.py): the
        # dict facade keeps every existing call site; refcount batches
        # enqueue to per-shard flush queues and apply OFF this process's
        # dispatch threads. Free candidates come back through
        # _free_candidates, which re-checks under this lock.
        from .object_plane.directory import ShardedObjectDirectory

        self.objects: ShardedObjectDirectory = ShardedObjectDirectory(
            ObjectEntry, free_callback=self._free_candidates
        )
        self.objects.unpin_callback = self._release_converted_pins
        self.functions: Dict[bytes, bytes] = {}
        self.kv: Dict[str, Dict[bytes, bytes]] = {}
        self.actors: Dict[bytes, ActorState] = {}
        self.named_actors: Dict[str, bytes] = {}
        # Method specs for reserved-but-not-yet-created named actors.
        self._orphan_actor_tasks: Dict[bytes, List[TaskSpec]] = {}
        self.workers: Dict[bytes, WorkerHandle] = {}
        self.nodes: Dict[bytes, NodeState] = {}
        # Client id -> control conn, for borrow-edge relays to owners
        # (object plane); maintained by _h_hello/_on_peer_close.
        self.client_conns: Dict[bytes, PeerConn] = {}
        # Live node-daemon control conns, upper bound (see
        # _broadcast_free): re-registrations may double-count briefly,
        # which only costs the slow path, never skips a real daemon.
        self._daemon_conn_count = 0
        # Borrower client -> owner clients it has borrowed from: lets a
        # borrower's death notify exactly the owners that track it,
        # without per-object holder state on the head.
        self.borrow_edges: Dict[bytes, Set[bytes]] = {}
        # Dead nodes purge from the live table (tombstones would bloat
        # every persistence cut and scheduler/listing scan — 1k churned
        # nodes made registrations 10x slower); a bounded history ring
        # keeps them visible to the state API (reference:
        # maximum_gcs_dead_node_cached_count, gcs_node_manager.cc).
        self.dead_nodes: deque = deque(maxlen=1000)
        # Incarnation grants are unique per head lifetime (one global
        # monotonic counter): a node_id that dies, purges, and tries to
        # re-register can never mint a number equal to a live one.
        self._incarnation_seq = 0
        # node_ids the death sweeper fenced: a register_node carrying
        # one is a zombie and gets FENCED — it must rejoin through the
        # normal join path with a fresh node_id (bounded with the ring).
        self._fenced_node_ids: Set[bytes] = set()
        # Clients already told they are fenced (one push per zombie:
        # every dropped message repeating it would spam a healed link).
        self._fence_pushed: Set[bytes] = set()
        self.placement_groups: Dict[bytes, PlacementGroupState] = {}
        self._pending = _PendingQueue()
        # Per-task state transitions for the state API, `ray_tpu_torch
        # timeline` (chrome://tracing) and the dashboard equivalent
        # (reference: GcsTaskManager task-event store,
        # gcs_task_manager.h:85). Bounded: oldest events roll off.
        self.task_events: deque = deque(maxlen=100_000)
        # Flight-recorder aggregator (reference: GcsTaskManager's
        # task-event store generalized to every layer boundary —
        # events.py): workers/raylets ship ring batches piggybacked on
        # their existing flushes; this process's own ring (driver +
        # GCS + spawner share it) drains in-process on reads.
        self.events = _events.EventAggregator()
        # The aggregator drains this process's own ring ahead of every
        # shipped batch it indexes: locally-recorded submission and
        # scheduling events happen-before the execution events workers
        # ship for the same tasks, so this keeps per-task transition
        # order right without cross-process synchronization.
        self.events.local_recorder = _events.get_recorder()
        # Last-reported blocked backlog per scheduling class: BLOCKED
        # sched events record only on change, so an unplaceable class
        # can't flood the ring at the scheduler pass rate.
        self._last_blocked: Dict[Any, int] = {}
        # Outstanding flush barriers for read-your-writes state listings
        # (token -> {"need", "got", "ev"}); see _barrier_flush_events.
        self._flush_waits: Dict[int, Dict[str, Any]] = {}
        self._flush_token = 0
        # Streaming-generator state per task (reference: streaming
        # return handling, task_manager.h:208): item count as the
        # executor seals yields, total+error once the generator ends,
        # parked stream_next requests awaiting the next item.
        self.streams: Dict[bytes, Dict[str, Any]] = {}
        self._store = ObjectStore()
        self._peers: List[PeerConn] = []
        self._shutdown = False
        self._worker_counter = 0
        # Fork-server worker spawning (spawn.py): warm zygote forks
        # workers in ~5 ms instead of ~0.5 s interpreter cold starts
        # (reference: worker_pool.cc prestarted workers).
        from .spawn import WorkerSpawner

        pythonpath = (
            os.getcwd() + os.pathsep + sys.path[0] + os.pathsep
            + os.environ.get("PYTHONPATH", "")
        )
        self._spawner = WorkerSpawner(
            {
                "RAY_TPU_TORCH_SESSION_ADDR": address,
                "RAY_TPU_TORCH_AUTHKEY": authkey.hex(),
                "PYTHONPATH": pythonpath,
            }
        )
        # Per-type control-plane message counts (head-load observability;
        # the local-dispatch tests assert intra-node chains stay off the
        # head with these).
        self.msg_counts: Dict[str, int] = {}
        # Entries promoted on owner death, awaiting their grace expiry:
        # (monotonic deadline, oid), appended in deadline order and
        # drained by the health loop (re-running _maybe_free so an
        # unborrowed promoted object still frees — just not before an
        # in-flight borrow edge could land).
        self._promoted_graves: deque = deque()
        # Dead clients scheduled for a second holder sweep: the first
        # sweep can race a shard applier already past its dead-client
        # check; the re-sweep (one grace period later) retires anything
        # that slipped through the crack.
        self._dead_resweeps: deque = deque()
        # --- gray-failure tolerance (straggler layer) ---
        # Per-task-name recent execution durations (head-measured,
        # dispatch→done), the percentile baseline the hedger compares
        # running tasks against. Bounded per name and in names.
        self._exec_durations: Dict[str, deque] = {}
        # Speculative execution: task_id -> hedge entry
        # {"seqs": {wid: seq-or-None}, "winner": wid-or-None,
        #  "pending": set(wids)}. The primary dispatch predates the
        # hedge so its expected seq is None; twins get 1, 2, ....
        # Guarded by self._lock like every scheduler table.
        self._hedges: Dict[bytes, Dict[str, Any]] = {}
        # Hedge counters for Prometheus + list_cluster_nodes.
        self._hedge_stats = {"launched": 0, "won": 0, "cancelled": 0}
        self._quarantine_stats = {"quarantined": 0, "readmitted": 0}
        # transfer_addr -> node_id for PULL_RELEAD attribution (a
        # re-lead names the slow provider by its transfer address).
        self._transfer_addr_nodes: Dict[str, bytes] = {}
        # Prometheus gauges/counters, built lazily (first sweep).
        self._straggler_gauges = None
        # Scorer/metrics faults swallowed by the health sweep (counted,
        # never silent).
        self._scorer_errors = 0
        # Pick up a chaos/delay spec configured for this head (the
        # standalone head process path never runs worker.init's
        # refresh; redundant on the in-driver path, and cheap).
        _chaos.refresh()

        head = NodeState(
            node_id=NodeID.from_random(),
            total=dict(head_resources),
            available=dict(head_resources),
            label="head",
            transfer_addr=head_transfer_addr,
        )
        self.head_node = head
        self.nodes[head.node_id.binary()] = head

        # Control-plane fault tolerance (reference: the Redis-backed
        # gcs store_client + NotifyGCSRestart): durable tables snapshot
        # to the session dir and reload on head restart; daemons
        # reconnect and re-register, actors restart from their creation
        # specs, queued tasks re-dispatch.
        self._version = 0
        self._persisted_version = 0
        # Segmented persistence (reference: the Redis store is keyed
        # per table): each durable table carries its own version, and
        # the persist loop rewrites ONLY dirty tables — a KV put no
        # longer re-serializes every actor and sealed object. Within-
        # table writes stay O(table); cross-table write amplification
        # is gone.
        self._table_versions = {t: 0 for t in self._TABLES}
        self._persisted_table_versions = dict(self._table_versions)
        self._state_path = os.path.join(session_dir, "gcs_state.pkl")
        self._state_dir = os.path.join(session_dir, "gcs_state.d")
        # manifest table -> persisted filename; replaced atomically
        # LAST each persist tick, so restarts always see a consistent
        # cross-table cut (table files are versioned, never rewritten
        # in place).
        self._manifest: Dict[str, str] = {}
        # Head-failover recovery window (reference: NotifyGCSRestart —
        # bearers of truth re-report after a GCS restart). While
        # monotonic() < _recovering_until, reconnecting owners
        # re-advertise owned objects/borrow edges (_h_reconcile),
        # workers re-claim their hosted actors and running tasks
        # (_h_hello reconnect), and unacked done batches replay.
        # _finish_recovery sweeps whatever nobody reclaimed through
        # the owner-death/lineage path.
        self._recovering_until = 0.0
        #: Dispatched-but-unfinished specs restored from the snapshot,
        #: parked here until a surviving worker claims them or the
        #: window closes (then they re-queue and re-execute).
        self._recover_inflight: Dict[bytes, TaskSpec] = {}
        #: Actor ids restored A_RESTARTING whose hosting worker may
        #: still be alive; claimed via hello reconnect, else restarted
        #: (or declared dead) at window close.
        self._recover_actors: Set[bytes] = set()
        #: Of those, the actors restored A_PENDING: a creation whose
        #: finish the old head never persisted. The worker that ran it
        #: may re-claim it; else its creation is queued at window close,
        #: consuming no restart (it never ran as far as the head knows).
        self._recover_pending: Set[bytes] = set()
        #: Object ids restored from the snapshot, awaiting an owner
        #: re-claim; unclaimed ones free at window close (no leak).
        self._restored_unclaimed: Set[bytes] = set()
        #: Return oids workers reported as mid-execution at reconnect.
        #: Leased/direct-dispatched tasks have NO head-side spec, so
        #: without this their in-flight returns would read as
        #: producer-less to the lost-producer sweeps and go LOST while
        #: the task still runs. Bounded by executing-at-reconcile size.
        self._reconcile_expected: Set[bytes] = set()
        #: (deadline, oid) for PENDING entries conjured by a question
        #: (get/wait on an unknown id) or an owner re-claim without a
        #: local copy — in a session that went through a head restart.
        #: If no known producer exists when the deadline passes, the
        #: health loop answers LOST so the parked get resolves into
        #: lineage reconstruction instead of wedging on a submit that
        #: died with the old head. Never armed in sessions that never
        #: restored (no behavior change for healthy heads).
        self._ghost_watch: deque = deque()
        self._restored_session = False
        try:
            restored_legacy = self._restore_state()
            if restored_legacy:
                # Seed the segmented store from the legacy snapshot:
                # every table is dirty, so the first persist tick
                # writes the full set (otherwise a later restart would
                # prefer a PARTIAL gcs_state.d and drop the rest).
                self._version += 1
                for t in self._TABLES:
                    self._table_versions[t] += 1
            # Restored from a previous head's snapshot: open the
            # recovery grace window for reconnecting bearers of truth.
            self._restored_session = True
            self._recovering_until = (
                time.monotonic() + RayConfig.head_recovery_grace_s
            )
            _events.record(
                _events.HEAD, "gcs", "RECONCILE_BEGIN",
                {
                    "grace_s": RayConfig.head_recovery_grace_s,
                    "actors": len(self._recover_actors),
                    "inflight": len(self._recover_inflight),
                    "objects": len(self._restored_unclaimed),
                },
            )
        except FileNotFoundError:
            pass
        except Exception as e:  # noqa: BLE001 - corrupt snapshot
            sys.stderr.write(f"gcs: state restore failed: {e}\n")

        try:
            os.unlink(address)  # stale socket from a previous head
        except OSError:
            pass
        # authkey=None: auth is deferred to each peer's reader thread
        # (transport.server_handshake) so a worker connect storm never
        # serializes its HMAC round-trips through the accept loop.
        self._authkey = authkey
        self._listener = Listener(address, family="AF_UNIX", authkey=None)
        # Optional network control plane: remote node daemons, their
        # workers and remote drivers connect here (reference: the GCS
        # gRPC server, src/ray/rpc/grpc_server.h).
        self.tcp_address: Optional[str] = None
        self._tcp_listener = None
        if tcp_port is not None:
            from . import transport

            self._tcp_listener = transport.make_listener(
                f"0.0.0.0:{tcp_port}", authkey
            )
            port = self._tcp_listener.address[1]
            self.tcp_address = f"{transport.node_ip()}:{port}"
            self._tcp_accept_thread = threading.Thread(
                target=self._accept_loop_on,
                args=(self._tcp_listener, True),
                name="gcs-accept-tcp",
                daemon=True,
            )
            self._tcp_accept_thread.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gcs-accept", daemon=True
        )
        self._sched_thread = threading.Thread(
            target=self._sched_loop, name="gcs-sched", daemon=True
        )
        self._health_thread = threading.Thread(
            target=self._health_loop, name="gcs-health", daemon=True
        )
        # Top-k tie-break for the hybrid scheduling policy.
        self._sched_rng = random.Random(0xC0FFEE)
        # In-flight worker stack-dump requests: token -> (peer, msg, ts).
        self._stack_waiters: Dict[str, Tuple] = {}
        # Channelized pubsub (reference: src/ray/pubsub/publisher.h —
        # per-channel subscriber lists; delivery is push over the
        # already-persistent duplex conns instead of long-poll).
        # channel -> list of peers; key filtering is client-side;
        # fan-out runs on its own thread (never under the GCS lock).
        self._pubsub: Dict[str, List] = {}
        self._pub_queue: "queue.Queue" = queue.Queue()
        self._pub_thread: Optional[threading.Thread] = None
        # Memory-pressure ladder: background spilling of cold sealed
        # objects at high pool utilization (reference:
        # local_object_manager.h:41-110) + a host-memory monitor that
        # kills the newest retriable task first under pressure
        # (reference: memory_monitor.h:52,
        # worker_killing_policy_retriable_fifo.h).
        self.spill_dir = RayConfig.object_spilling_directory or os.path.join(
            session_dir, "spill"
        )
        os.environ["RAY_TPU_TORCH_SPILL_DIR"] = self.spill_dir
        # Disk trouble (ENOSPC, EIO after retries) parks the spiller
        # until this deadline instead of hot-looping a failing disk;
        # objects stay resident and puts ride the backpressure rung.
        # One pass at a time: the monitor thread and the synchronous
        # spill_tick hook must not race each other onto the same
        # candidates (they'd double-spill and collide on writes).
        self._spill_blocked_until = 0.0
        self._spill_pass_lock = threading.Lock()
        self._spill_thread = threading.Thread(
            target=self._spill_loop, name="gcs-spill", daemon=True
        )
        self._memory_thread = threading.Thread(
            target=self._memory_loop, name="gcs-memory", daemon=True
        )
        self._persist_thread = threading.Thread(
            target=self._persist_loop, name="gcs-persist", daemon=True
        )
        # Log pipeline (reference: _private/log_monitor.py +
        # ray_logging dedup): tail this node's worker logs, keep a
        # bounded ring of recent lines, push to subscribed drivers.
        from .log_monitor import LogDeduplicator, LogMonitor

        self.log_buffer: deque = deque(maxlen=10_000)
        self._log_subscribers: List[PeerConn] = []
        self._log_dedup = LogDeduplicator()
        self._log_monitor = LogMonitor(
            os.path.join(session_dir, "logs"),
            lambda entries: self._ingest_logs("head", entries),
        )
        self._accept_thread.start()
        self._sched_thread.start()
        self._health_thread.start()
        self._spill_thread.start()
        self._memory_thread.start()
        self._persist_thread.start()
        # Prestart a few workers so the first task doesn't pay spawn latency
        # (reference: worker_pool.cc:1323 PrestartWorkers).
        with self._lock:
            for _ in range(
                min(RayConfig.num_prestart_workers, int(head.total.get("CPU", 1)))
            ):
                self._spawn_worker(head)

    # ------------------------------------------------------------------ accept

    def _accept_loop(self):
        self._accept_loop_on(self._listener)

    def _accept_loop_on(self, listener, tcp: bool = False):
        while not self._shutdown:
            try:
                conn = listener.accept()
            except (OSError, EOFError):
                break
            except Exception:  # noqa: BLE001 - failed auth handshake etc.
                continue
            state: Dict[str, Any] = {}
            from . import transport

            peer = PeerConn(
                conn,
                push_handler=lambda msg, s=state: self._dispatch(s, msg),
                on_close=lambda s=state: self._on_peer_close(s),
                name="gcs-peer",
                autostart=False,
                handshake=lambda c: transport.server_handshake(
                    c, self._authkey, tcp=tcp
                ),
            )
            state["peer"] = peer
            with self._lock:
                self._peers.append(peer)
            peer.start()

    def _on_peer_close(self, state: Dict[str, Any]):
        # Release any worker leases the departing client still holds.
        for leased_wid in state.pop("held_leases", set()):
            self._release_lease(leased_wid)
        cid = state.get("client_id")
        if cid is not None:
            with self._lock:
                if self.client_conns.get(cid) is state.get("peer"):
                    self.client_conns.pop(cid, None)
                owners = self.borrow_edges.pop(cid, None)
            self._sweep_client_refs(cid)
            if owners:
                # Owners tracking this client as a borrower sweep its
                # borrow edges (otherwise their objects never release).
                self._notify_borrower_died(cid, owners)
        wid = state.get("worker_id")
        if wid is not None:
            self._handle_worker_death(wid, "worker connection closed")
        nid = state.get("node_id")
        if nid is not None and state.get("role") in ("raylet", "driver"):
            # Identity check: a daemon that already re-registered (head
            # restart, asymmetric conn failure) has a fresh NodeState
            # with a new conn — the STALE conn's close must not kill it.
            node = self.nodes.get(nid)
            if node is None or node.conn is state.get("peer") or node.conn is None:
                self._handle_node_death(nid, "node daemon connection closed")

    # ---------------------------------------------------------------- dispatch

    def _dispatch(self, state: Dict[str, Any], msg: Dict[str, Any]):
        mtype = msg["type"]
        self.msg_counts[mtype] = self.msg_counts.get(mtype, 0) + 1
        # Chaos: head death at the dispatch boundary — a message was
        # received (possibly acked by transport) but its handler never
        # ran; every client-side at-least-once path must absorb it.
        _chaos.kill_point("gcs.dispatch")
        # Fault injection (including the legacy testing_rpc_delay_us
        # delays) happens at the transport boundary now — PeerConn's
        # deliver side runs the chaos schedule before dispatch.
        handler = getattr(self, f"_h_{mtype}", None)
        if handler is None:
            peer: PeerConn = state["peer"]
            if "req_id" in msg:
                peer.reply(msg, ok=False, error=f"unknown message type {mtype}")
            return
        if _objdir.GUARD:
            # Test instrumentation: flag this dispatch thread so the
            # directory can assert no per-object holder mutation runs
            # on the dispatch loop (object-plane acceptance criterion).
            _objdir.mark_dispatch(True)
        try:
            handler(state, msg)
            if mtype in self._DURABLE_TYPES:
                # After the handler, under the lock: a snapshot taken
                # mid-handler records the pre-bump version and will be
                # retaken; unlocked bumps could lose increments.
                with self._lock:
                    self._version += 1
                    for t in self._TABLES_OF_TYPE.get(
                        mtype, self._TABLES
                    ):
                        self._table_versions[t] += 1
        except Exception as e:  # noqa: BLE001
            peer = state["peer"]
            if "req_id" in msg:
                try:
                    peer.reply(msg, ok=False, error=f"{type(e).__name__}: {e}")
                except ConnectionLost:
                    pass
            else:
                sys.stderr.write(f"gcs: error handling {mtype}: {e}\n")
        finally:
            if _objdir.GUARD:
                _objdir.mark_dispatch(False)

    # ---------------------------------------------------------------- handlers

    def _h_hello(self, state, msg):
        peer: PeerConn = state["peer"]
        role = msg["role"]
        state["role"] = role
        peer.peer_role = role
        node_id = self.head_node.node_id.binary()
        reply_extra: Dict[str, Any] = {}
        if role == "worker":
            wid = msg["worker_id"]
            state["worker_id"] = wid
            with self._lock:
                w = self.workers.get(wid)
                if w is not None and w.state == W_DEAD:
                    # Membership fence: this worker was declared dead
                    # (its node timed out, OOM kill, crash sweep). A
                    # zombie re-hello must NOT resurrect the handle —
                    # its actor may already be restarting elsewhere
                    # under a new epoch. The process exits on the
                    # fenced reply.
                    self._record_fence("worker", wid, "dead worker hello")
                    peer.reply(msg, ok=False, fenced=True)
                    return
                if w is None:
                    # Raylet-local or externally started worker: bind to
                    # its declared node (object locations must resolve
                    # to the node whose store/transfer server holds
                    # them), defaulting to the head.
                    hello_nid = msg.get("node_id")
                    node = (
                        self.nodes.get(hello_nid) if hello_nid else None
                    )
                    if node is None and hello_nid and msg.get("reconnect"):
                        # Failover: this worker outlived the old head
                        # and reconnected BEFORE its raylet re-registered
                        # the node. A placeholder keeps its object
                        # locations bound to the right node id; the
                        # raylet's register_node replaces it (same key)
                        # with the real NodeState moments later.
                        node = NodeState(
                            node_id=NodeID(hello_nid),
                            total={},
                            available={},
                            label="rejoining",
                            schedulable=False,
                        )
                        self.nodes[hello_nid] = node
                    node = node or self.head_node
                    w = WorkerHandle(
                        worker_id=WorkerID(wid), node_id=node.node_id
                    )
                    self.workers[wid] = w
                else:
                    node = self.nodes[w.node_id.binary()]
                w.conn = peer
                w.pid = msg.get("pid", 0)
                w.direct_addr = msg.get("direct_addr", "")
                if msg.get("local_only"):
                    # Raylet-leased worker: the daemon owns its dispatch
                    # (reference: raylet local task manager authority,
                    # cluster_task_manager.cc:44); the GCS only keeps
                    # the directory/worker bookkeeping — never schedules
                    # onto it.
                    w.state = W_LEASED
                    w.local_only = True
                else:
                    w.state = W_IDLE
                    node.pool.add(wid)
                node_id = node.node_id.binary()
                if msg.get("reconnect"):
                    reply_extra = self._reconcile_worker(w, node, msg)
                _events.record(
                    _events.WORKER, w.worker_id.hex(), "REGISTERED",
                    {"pid": w.pid, "reconnect": bool(msg.get("reconnect"))},
                )
                self._work.notify_all()
        elif role == "driver" and msg.get("transfer_addr"):
            # Remote driver: its objects live in its own store, served by
            # its transfer server. Register a zero-resource node for it so
            # the object directory can point pulls at it (reference: every
            # driver's core worker owns the objects it puts).
            with self._lock:
                dnode = NodeState(
                    node_id=NodeID.from_random(),
                    total={},
                    available={},
                    label="driver",
                    transfer_addr=msg["transfer_addr"],
                    schedulable=False,
                )
                self.nodes[dnode.node_id.binary()] = dnode
                node_id = dnode.node_id.binary()
                state["node_id"] = node_id  # dies with this connection
        # Where this peer's sealed objects live (put_object routing), and
        # its identity for refcount bookkeeping.
        state["obj_node_id"] = node_id
        state["client_id"] = msg["worker_id"]
        with self._lock:
            # Borrow-update relays resolve owners through this map.
            self.client_conns[msg["worker_id"]] = peer
        peer.reply(
            msg, ok=True, session_dir=self.session_dir, node_id=node_id,
            **reply_extra,
        )

    def _reconcile_worker(self, w: WorkerHandle, node: NodeState,
                          msg: Dict[str, Any]) -> Dict[str, Any]:
        """A worker that outlived the old head re-registered: re-bind
        what it authoritatively hosts (reference: bearers of truth
        re-report after NotifyGCSRestart). Caller holds the lock.

        - hosted actors re-bind to this worker instead of being
          recreated at window close (state survives the failover);
        - tasks mid-execution move back into the inflight table so
          their completion (and death) accounting works;
        - sealed store-backed results it still holds rebuild their
          directory locations.

        Returns reply extras; ``drop_actors`` names instances the head
        refused to re-bind (unknown, dead, or already recreated) so the
        worker can discard them."""
        wid = w.worker_id.binary()
        drop: List[bytes] = []
        hosted = list(msg.get("actors", ()) or ())
        shared = bool(msg.get("shared_host")) or len(hosted) > 1
        claimed_actors = 0
        for aid in hosted:
            actor = self.actors.get(aid)
            if (
                actor is None
                or actor.state == A_DEAD
                or aid not in self._recover_actors
            ):
                # Unknown, dead, or already recreated elsewhere (the
                # recovery window closed without this claim): the
                # worker must drop its orphan instance.
                drop.append(aid)
                continue
            self._recover_actors.discard(aid)
            self._recover_pending.discard(aid)
            actor.state = A_ALIVE
            actor.worker_id = w.worker_id
            if shared:
                w.actor_host = True
                w.packed[aid] = actor.spec
                node.actor_hosts.add(wid)
            else:
                w.actor_id = actor.actor_id
                w.state = W_ACTOR
            node.pool.discard(wid)
            # Re-acquire the creation-lifetime resources on the fresh
            # node view (best-effort: PG bundles re-reserve on their
            # own path).
            if actor.spec.placement_group_id is None:
                _acquire(node.available, self._task_resources(actor.spec))
            while actor.pending:
                self._route_actor_task(actor.pending.popleft(), requeued=True)
            self._notify_direct_waiters(actor)
            self._publish("ACTOR", aid.hex(), {"state": "ALIVE"})
            claimed_actors += 1
        claimed_tasks = 0
        for ent in msg.get("executing", ()) or ():
            if isinstance(ent, (tuple, list)):
                tid, roids = ent[0], ent[1]
            else:  # bare task id (older worker)
                tid, roids = ent, ()
            # Reported returns are expected regardless of whether the
            # head knows the spec: leased/direct tasks are dispatched
            # worker-to-worker and must not have their in-flight
            # returns swept LOST.
            self._reconcile_expected.update(roids)
            spec = self._recover_inflight.pop(tid, None)
            if spec is None:
                continue
            w.inflight[tid] = spec
            if spec.actor_id is None and not spec.actor_creation:
                if w.state == W_IDLE:
                    w.state = W_BUSY
                    w.current_task = spec
                    w.task_started_at = time.time()
                if spec.placement_group_id is None:
                    _acquire(node.available, self._task_resources(spec))
            claimed_tasks += 1
        claimed_objects = 0
        for oid, loc in msg.get("sealed", ()) or ():
            entry = self.objects.setdefault(oid, ObjectEntry())
            if entry.status == PENDING and loc:
                entry.status = READY
                entry.segment = loc
                entry.node_id = node.node_id
                entry.last_access = time.time()
                self._notify_object(entry)
                claimed_objects += 1
                if entry.owner is None and not entry.holders:
                    # Location known but nobody claims ownership (yet):
                    # the owner's reconcile or the window-close sweep
                    # decides its fate — never a silent leak.
                    self._restored_unclaimed.add(oid)
        if _events.enabled() and (
            claimed_actors or claimed_tasks or claimed_objects or drop
        ):
            _events.record(
                _events.HEAD, w.worker_id.hex()[:12], "RECONCILE_CLAIM",
                {
                    "actors": claimed_actors,
                    "tasks": claimed_tasks,
                    "sealed": claimed_objects,
                    "dropped": len(drop),
                },
            )
        return {"drop_actors": drop} if drop else {}

    def _h_register_function(self, state, msg):
        with self._lock:
            self.functions[msg["function_id"]] = msg["blob"]
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _h_get_function(self, state, msg):
        with self._lock:
            blob = self.functions.get(msg["function_id"])
        state["peer"].reply(msg, ok=blob is not None, blob=blob)

    def _record_task_event(self, task_id: bytes, name: str, event: str,
                           worker_id: bytes = b""):
        self.task_events.append(
            (task_id, name, event, time.time(), worker_id)
        )

    def _h_submit_task(self, state, msg):
        spec: TaskSpec = msg["spec"]
        # Submitting job identity (head-side only, never pickled): the
        # OOM kill ladder groups victims by it so one job's burst can't
        # starve another (worker_killing_policy_group_by_owner.h).
        spec.owner_client = state.get("client_id")
        with self._lock:
            self._record_task_event(
                spec.task_id.binary(), spec.name, "PENDING"
            )
            if spec.function_blob is not None:
                self.functions.setdefault(spec.function_id, spec.function_blob)
                spec.function_blob = None
            for oid in spec.return_object_ids():
                entry = self.objects.setdefault(oid.binary(), ObjectEntry())
                if entry.owner is None:
                    # The submitter owns the returns (reference: the
                    # caller's core worker owns task outputs); its
                    # process keeps the authoritative refcounts.
                    entry.owner = state.get("client_id")
                if entry.status in (READY, LOST):
                    # Owner resubmission after loss (lineage
                    # reconstruction): the task will reseal its returns.
                    entry.status = PENDING
                    entry.inline = None
                    entry.segment = None
                    entry.error = None
            # Pin dependencies AND nested (borrowed) arg refs for the
            # task's lifetime so a holderless intermediate can't be
            # reclaimed mid-flight — for nested refs this closes the
            # window between the caller's release and the executing
            # worker's batched badd (chaos-soak wedge).
            for dep in spec.dependencies:
                self.objects.setdefault(dep.binary(), ObjectEntry()).task_pins += 1
            for dep in getattr(spec, "borrowed_refs", None) or ():
                self.objects.setdefault(dep.binary(), ObjectEntry()).task_pins += 1
            if spec.actor_id is not None and not spec.actor_creation:
                self._route_actor_task(spec)
            else:
                if spec.actor_creation:
                    aid = spec.actor_id.binary()
                    actor = ActorState(
                        actor_id=spec.actor_id, spec=spec, name=spec.actor_name
                    )
                    self.actors[aid] = actor
                    if spec.actor_name:
                        holder = self.named_actors.get(spec.actor_name)
                        if holder is not None and holder != aid:
                            self._fail_task_returns(
                                spec,
                                ValueError(
                                    f"actor name '{spec.actor_name}' already taken"
                                ),
                            )
                            self.actors.pop(aid, None)
                            return
                        self.named_actors[spec.actor_name] = aid
                    for orphan in self._orphan_actor_tasks.pop(aid, []):
                        actor.pending.append(orphan)
                self._pending.append(spec)
                if _events.enabled():
                    _events.record(
                        _events.TASK, spec.task_id.hex(), "QUEUED",
                        {"depth": len(self._pending)},
                    )
                self._work.notify_all()

    def _creation_queued(self, aid: bytes) -> bool:
        """Whether actor `aid`'s creation spec waits in the pending queue.
        Caller holds the lock."""
        return any(
            s.actor_creation
            and s.actor_id is not None
            and s.actor_id.binary() == aid
            for s in self._pending
        )

    def _route_actor_task(self, spec: TaskSpec, requeued: bool = False):
        """Dispatch an actor method to its pinned worker (ordered FIFO).
        `requeued`: the call comes from its actor's own queue, where it
        was already recorded as QUEUED."""
        aid = spec.actor_id.binary()
        actor = self.actors.get(aid)
        if actor is None and aid not in self.named_actors.values():
            self._fail_task_returns(spec, None, actor_error="actor not found")
            return
        if actor is not None and actor.state == A_DEAD:
            self._fail_task_returns(spec, None, actor_error=actor.death_reason)
            return
        if _events.enabled() and not requeued:
            _events.record(
                _events.TASK, spec.task_id.hex(), "QUEUED", {"route": "actor"}
            )
        if actor is None:
            # Name reserved but the creation spec hasn't arrived yet
            # (get_if_exists race window); buffer until it does.
            self._orphan_actor_tasks.setdefault(aid, []).append(spec)
            return
        if actor.state in (A_PENDING, A_RESTARTING):
            actor.pending.append(spec)
            return
        w = self.workers[actor.worker_id.binary()]
        w.inflight[spec.task_id.binary()] = spec
        try:
            # The epoch rides the dispatch and comes back on the done
            # record: results from a superseded incarnation of this
            # actor (false death → restart) can then never seal.
            w.conn.send({
                "type": "execute_task", "spec": spec,
                "actor_epoch": actor.epoch,
                "t_grant": time.time(),
            })
            self._record_task_event(
                spec.task_id.binary(), spec.name, "RUNNING",
                actor.worker_id.binary(),
            )
            if _events.enabled():
                _events.record(
                    _events.TASK, spec.task_id.hex(), "LEASED",
                    {"worker": actor.worker_id.hex(), "route": "actor"},
                )
        except ConnectionLost:
            w.inflight.pop(spec.task_id.binary(), None)
            actor.pending.append(spec)

    # ------------------------------------------------- streaming generators

    def _stream_state(self, task_id: bytes) -> Dict[str, Any]:
        st = self.streams.get(task_id)
        if st is None:
            st = self.streams[task_id] = {
                "count": 0, "total": None, "error": None, "waiters": [],
            }
        return st

    def _stream_notify(self, st: Dict[str, Any]) -> None:
        """Answer parked stream_next requests that can now resolve.
        Caller holds self._lock."""
        still_waiting = []
        for peer, req_id, index in st["waiters"]:
            if index < st["count"]:
                reply = {"type": "reply", "req_id": req_id, "ok": True,
                         "available": True}
            elif st["total"] is not None:
                reply = {"type": "reply", "req_id": req_id, "ok": True,
                         "ended": True, "total": st["total"],
                         "error": st["error"]}
            else:
                still_waiting.append((peer, req_id, index))
                continue
            try:
                peer.send(reply)
            except ConnectionLost:
                pass
        st["waiters"] = still_waiting

    def _h_stream_item(self, state, msg):
        """One yield from a streaming task: seal it as its own object
        and wake consumers parked on its index."""
        wid = msg["worker_id"]
        with self._lock:
            w = self.workers.get(wid)
            r = msg["result"]
            entry = self.objects.setdefault(r["object_id"], ObjectEntry())
            was_ready = entry.status == READY
            entry.status = READY
            entry.inline = r.get("inline")
            entry.segment = r.get("segment")
            entry.size = r.get("size", 0)
            if not was_ready:  # fresh seal (not a dup) supersedes spill
                _drop_spill_file(entry)
            entry.node_id = w.node_id if w else None
            entry.last_access = time.time()
            for child in r.get("children", []):
                entry.children.append(child)
                self.objects.setdefault(child, ObjectEntry()).child_pins += 1
            self._notify_object(entry)
            st = self._stream_state(msg["task_id"])
            st["count"] = max(st["count"], msg["index"] + 1)
            self._stream_notify(st)

    def _h_stream_next(self, state, msg):
        peer: PeerConn = state["peer"]
        task_id = msg["task_id"]
        index = msg["index"]
        with self._lock:
            st = self._stream_state(task_id)
            if index < st["count"]:
                peer.reply(msg, ok=True, available=True)
                return
            if st["total"] is not None:
                peer.reply(
                    msg, ok=True, ended=True, total=st["total"],
                    error=st["error"],
                )
                # Consumer walked past the end: drop the stream state
                # (unbounded growth otherwise — one entry per serve
                # request). A generator is single-consumer and never
                # rewinds, so nothing re-asks after this.
                if index >= st["total"] and not st["waiters"]:
                    self.streams.pop(task_id, None)
                return
            st["waiters"].append((peer, msg["req_id"], index))

    def _end_stream(self, task_id: bytes, total: int,
                    error_blob: Optional[bytes]) -> None:
        """Caller holds self._lock."""
        st = self._stream_state(task_id)
        st["total"] = max(total, st["count"])
        st["error"] = error_blob
        self._stream_notify(st)

    def _h_task_done(self, state, msg):
        freed: List[bytes] = []
        borrow_notify: List[Tuple[bytes, bytes, bytes]] = []
        with self._lock:
            self._apply_task_done(msg["worker_id"], msg, freed, borrow_notify)
            self._work.notify_all()
        self._broadcast_free(freed)
        self._relay_borrow_adds(borrow_notify)
        self._ingest_peer_events(msg)

    def _h_task_done_batch(self, state, msg):
        """Coalesced direct-path completions (one message per worker per
        flush interval instead of one per call — the GCS lives in the
        driver process, so per-call handling steals driver GIL time at
        the aggregate cluster call rate).

        Sequenced at-least-once (mirror of ref_flush): the worker's
        batcher numbers every item-carrying batch and retransmits until
        acked — completions are the bearer-of-truth record a head crash
        must not lose — and a per-conn sequencer dedups/reorders here
        so re-deliveries apply once, in submission order. Un-numbered
        batches (old peers, pure event piggybacks) apply directly."""
        seq = msg.get("seq")
        if seq is not None and msg.get("items"):
            try:
                state["peer"].send({"type": "task_done_ack", "seq": seq})
            except ConnectionLost:
                pass
            seqr = state.get("done_seq")
            if seqr is None:
                # start_seq=1: the batcher numbers from 1 per
                # connection; a dropped FIRST batch must read as a gap,
                # never as an already-applied duplicate.
                seqr = state["done_seq"] = _chaos.InOrderSequencer(
                    start_seq=1
                )
            batches = seqr.offer(seq, msg)
        else:
            batches = [msg]
        for m in batches:
            self._apply_task_done_batch(m)

    def _apply_task_done_batch(self, msg):
        wid = msg["worker_id"]
        freed: List[bytes] = []
        borrow_notify: List[Tuple[bytes, bytes, bytes]] = []
        with self._lock:
            for item in msg["items"]:
                self._apply_task_done(wid, item, freed, borrow_notify)
            self._work.notify_all()
        self._broadcast_free(freed)
        self._relay_borrow_adds(borrow_notify)
        self._ingest_peer_events(msg)

    def _ingest_peer_events(self, msg: Dict[str, Any],
                            source: Optional[str] = None) -> None:
        """Flight-recorder batch piggybacked on another message
        (task_done/task_done_batch/node_heartbeat/event_batch)."""
        items = msg.get("events")
        dropped = msg.get("events_dropped", 0)
        if not items and not dropped:
            return
        if source is None:
            wid = msg.get("worker_id")
            source = (
                f"worker-{wid.hex()[:12]}"
                if isinstance(wid, bytes)
                else str(msg.get("source", "?"))
            )
        for item in items or ():
            # Health signal: a PULL_RELEAD names the slow provider by
            # transfer address — charge the node it belongs to. One
            # string compare per item on the ingest path; the indexer
            # does the heavy lifting elsewhere.
            if len(item) >= 6 and item[4] == "PULL_RELEAD":
                attrs = item[5] or {}
                nid = self._transfer_addr_nodes.get(attrs.get("addr", ""))
                if nid is not None:
                    with self._lock:
                        node = self.nodes.get(nid)
                        if node is not None:
                            node.releads += 1
        self.events.ingest(items or [], source, dropped)

    def _h_event_batch(self, state, msg):
        """Standalone flight-recorder shipment (processes with no other
        flush to piggyback on)."""
        self._ingest_peer_events(msg)
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _drain_local_events(self) -> None:
        """This process's own ring (driver + GCS + spawner share it)
        into the aggregator — read-time, never on a hot path. The ring
        goes to the FRONT of the indexing backlog: locally-recorded
        submit-side events happen-before the worker batches a read
        barrier may have just parked there."""
        self.events.drain_local_front()

    def _apply_task_done(self, wid: bytes, msg: Dict[str, Any],
                         freed: List[bytes],
                         borrow_notify: Optional[List] = None) -> None:
        """Apply one completion record. Caller holds self._lock."""
        if borrow_notify is None:
            borrow_notify = []
        results = msg["results"]  # list of dicts per return
        error_blob = msg.get("error")
        w = self.workers.get(wid)
        task_id = msg["task_id"]
        if w is not None and w.state == W_DEAD:
            # Membership fence: this worker was declared dead (node
            # heartbeat timeout, OOM, crash sweep) — its in-flight work
            # was already failed or requeued, and its results must NOT
            # seal now: the retry may be running (or finished) under
            # the live incarnation, and a zombie's late seal would
            # resurrect freed/LOST entries.
            self._fence_dead_client(wid, "task_done from fenced worker")
            return
        spec: Optional[TaskSpec] = w.inflight.pop(task_id, None) if w else None
        if self._recover_inflight:
            # A completion IS the strongest re-claim: the task must not
            # be re-queued at recovery-window close (it already ran —
            # possibly finishing during the head outage, with this
            # batch retransmitted to the restarted head).
            rec_spec = self._recover_inflight.pop(task_id, None)
            if spec is None:
                spec = rec_spec
        done_epoch = msg.get("actor_epoch")
        if (
            done_epoch is not None
            and spec is not None
            and spec.actor_id is not None
        ):
            actor = self.actors.get(spec.actor_id.binary())
            if actor is not None and actor.epoch != done_epoch:
                # Epoch fence: this record was produced by a superseded
                # incarnation of the actor (false death → restart). Its
                # returns were already resolved when that incarnation
                # died (failed with RayActorError, or re-run under the
                # live epoch) — applying it would let a caller observe
                # results from two incarnations of one actor.
                if _events.enabled():
                    _events.record(
                        _events.HEAD, spec.actor_id.hex(),
                        "ACTOR_EPOCH_FENCED",
                        {
                            "stale": done_epoch, "current": actor.epoch,
                            "task": task_id.hex()[:12],
                        },
                    )
                # A hedged actor task's stale twin takes this fence
                # path — drop its hedge bookkeeping so the entry
                # doesn't outlive the race.
                self._hedge_drop_reporter(task_id, wid)
                return
        if task_id in self._hedges and not self._hedge_adjudicate(
            task_id, wid, w, msg
        ):
            # Speculative twin lost the race (or is a stale echo): its
            # lease came home and its results must NOT seal — the
            # winner's already did (or is about to, earlier in this
            # same batch). Exactly-one-side-effect mirrors the actor
            # epoch fence above.
            return
        name = spec.name if spec else msg.get("name", "?")
        t_start = msg.get("t_start")
        if t_start:
            # A direct or leased call: the head never dispatched it, so
            # it recorded no RUNNING. The worker's own start stamp takes
            # its place, or the timeline (state.timeline) would drop the
            # task's span for want of a start.
            self.task_events.append((task_id, name, "RUNNING", t_start, wid))
        self.task_events.append(
            (
                task_id,
                name,
                "FAILED" if error_blob is not None else "FINISHED",
                time.time(),
                wid,
            )
        )
        if w is not None:
            node = self.nodes.get(w.node_id.binary())
            if node is not None:
                glat = msg.get("grant_lat")
                if glat is not None and glat > node.grant_lat_max:
                    # Health signal: worst lease-grant→receive transit
                    # this sweep (echoed by the worker's push handler).
                    node.grant_lat_max = float(glat)
            if w.state == W_BUSY:
                if (
                    w.task_started_at
                    and spec is not None
                    and error_blob is None
                    and (
                        node is None
                        or not (node.suspect or node.quarantined)
                    )
                ):
                    # Percentile baseline for the hedger: head-measured
                    # dispatch→done durations per task name, bounded
                    # both per-name and in names (hot names win slots).
                    dq = self._exec_durations.get(spec.name)
                    if dq is None and len(self._exec_durations) < 512:
                        dq = self._exec_durations[spec.name] = deque(
                            maxlen=256
                        )
                    if dq is not None:
                        dq.append(time.time() - w.task_started_at)
                w.state = (
                    W_ACTOR
                    if (w.actor_id is not None or w.packed)
                    else W_IDLE
                )
                if w.current_task is not None:
                    # Actors hold their creation resources for their
                    # lifetime (released on death), unless creation failed.
                    if not w.current_task.actor_creation or error_blob is not None:
                        self._release_task_resources(w.current_task, w.node_id)
                w.current_task = None
        total = msg.get("streaming_total")
        if total is not None:
            self._end_stream(task_id, total, error_blob)
        # Application-level retry (reference: TaskManager::RetryTaskIfPossible
        # task_manager.h:468 — app errors retry only with retry_exceptions).
        # Streaming tasks never retry: items already consumed can't be
        # un-yielded.
        if (
            error_blob is not None
            and spec is not None
            and not spec.actor_creation
            and spec.actor_id is None
            and spec.retry_exceptions
            and spec.max_retries > 0
            and total is None
        ):
            spec.max_retries -= 1
            self._pending.append(spec)
            return
        # Borrow piggyback (reference: borrowed refs ride the task
        # reply, reference_count.h): arg refs this worker still holds
        # past the task's lifetime convert their dependency pins into
        # borrow edges. The pin is NOT released here — the shard
        # applier adds the borrow under the shard lock first, then
        # hands the pin back through _release_converted_pins, so there
        # is no window where a task-retained ref is neither pinned nor
        # held.
        borrowed: Optional[Set[bytes]] = None
        borrow_ops: Optional[List[tuple]] = None
        for oid in msg.get("borrows", ()):
            if borrowed is not None and oid in borrowed:
                continue
            de = self.objects.get(oid)
            if de is not None and de.owner == wid:
                # The executing worker OWNS this dep: its tracker
                # governs the lifetime (release on drain). A holder
                # shadow here could never be retracted — the owner
                # sends release, not bdel — and would pin the entry
                # forever. Let the pin release normally below.
                continue
            if borrowed is None:
                borrowed, borrow_ops = set(), []
            if de is None:
                # No entry (submit always pins dep entries, so this is
                # a defensive branch): nothing to convert — land a
                # plain holder shadow so a racing release can't free
                # an object this worker retains (its eventual bdel
                # clears it), and leave the pin-release loop alone.
                borrow_ops.append(("badd", oid, wid))
                continue
            borrowed.add(oid)
            borrow_ops.append(("pin2b", oid, wid))
            if de.owner is not None:
                borrow_notify.append((de.owner, wid, oid))
        if borrow_ops:
            # One enqueue for the whole record: per-oid calls would pay
            # a shard split + wake check each inside the serialized
            # GCS-lock region (10k-arg tasks are a supported envelope).
            self.objects.enqueue(borrow_ops)
        for r in results:
            entry, early_dropped = self.objects.seal_lookup(
                r["object_id"], ObjectEntry()
            )
            if early_dropped:
                # The owner already released before this (batched)
                # completion created the entry: the _maybe_free below
                # reclaims the result immediately.
                entry.owner_released = True
                entry.had_holder = True
            if error_blob is not None:
                entry.status = FAILED
                entry.error = error_blob
            else:
                was_ready = entry.status == READY
                entry.status = READY
                entry.inline = r.get("inline")
                entry.segment = r.get("segment")
                entry.size = r.get("size", 0)
                if not was_ready:  # fresh seal (not a dup) supersedes spill
                    _drop_spill_file(entry)
                entry.node_id = w.node_id if w else None
                entry.last_access = time.time()
                for child in r.get("children", []):
                    entry.children.append(child)
                    self.objects.setdefault(
                        child, ObjectEntry()
                    ).child_pins += 1
            self._notify_object(entry)
            # Refs already dropped before the result sealed: reclaim.
            self._maybe_free(r["object_id"], entry, freed)
        # Task terminal: release its dependency + borrowed-ref pins.
        # One pin per retained (borrowed) oid stays held — the shard
        # applier releases it once the borrow edge has landed (above).
        if spec is not None:
            pinned = list(spec.dependencies) + list(
                getattr(spec, "borrowed_refs", None) or ()
            )
            for dep in pinned:
                db = dep.binary()
                if borrowed is not None and db in borrowed:
                    borrowed.discard(db)
                    continue
                de = self.objects.get(db)
                if de is not None:
                    de.task_pins = max(0, de.task_pins - 1)
                    self._maybe_free(db, de, freed)
        if msg.get("actor_creation"):
            self._on_actor_created(msg["actor_id"], wid, ok=error_blob is None,
                                   error_blob=error_blob)

    def _hedge_drop_reporter(self, task_id: bytes, wid: bytes) -> None:
        """Forget one twin's pending report; drops the entry once every
        twin has reported (or died). Caller holds self._lock."""
        hedge = self._hedges.get(task_id)
        if hedge is None:
            return
        hedge["pending"].discard(wid)
        if not hedge["pending"]:
            del self._hedges[task_id]

    def _hedge_adjudicate(self, task_id: bytes, wid: bytes, w,
                          msg: Dict[str, Any]) -> bool:
        """First-done-wins for a hedged task. Caller holds self._lock.

        True → this record is the winner, apply it normally. False →
        loser/stale twin: worker state and resources are restored HERE
        (its lease comes home), results are discarded by the caller.
        The hedge_seq echo fences the same way a stale actor epoch
        does: a done whose (worker, seq) doesn't match what the head
        dispatched can never seal, even if it's the first to arrive."""
        hedge = self._hedges[task_id]
        seq = msg.get("hedge_seq")
        known = wid in hedge["seqs"]
        authentic = known and seq == hedge["seqs"][wid]
        if hedge["winner"] is None and authentic:
            hedge["winner"] = wid
            self._hedge_stats["won"] += 1
            if w is not None:
                node = self.nodes.get(w.node_id.binary())
                if node is not None:
                    node.hedges_won += 1
            if _events.enabled():
                _events.record(
                    _events.HEAD, task_id.hex()[:12], "HEDGE_WIN",
                    {"worker": wid.hex()[:12], "seq": seq},
                )
            # Cancel the twin(s) still running: Python can't preempt
            # user code, but the mark makes their done skip value
            # sealing (no pool bytes committed for rejected results).
            for other in hedge["seqs"]:
                if other == wid:
                    continue
                ow = self.workers.get(other)
                if ow is not None and ow.conn is not None:
                    try:
                        ow.conn.send(
                            {"type": "cancel_task", "task_id": task_id}
                        )
                    except ConnectionLost:
                        pass
            self._hedge_drop_reporter(task_id, wid)
            return True
        # Loser (winner already chosen) or stale echo (unknown worker /
        # seq mismatch): restore the lease, reject the results.
        self._hedge_stats["cancelled"] += 1
        if w is not None:
            node = self.nodes.get(w.node_id.binary())
            if node is not None:
                node.hedges_lost += 1
            if w.state == W_BUSY:
                w.state = (
                    W_ACTOR
                    if (w.actor_id is not None or w.packed)
                    else W_IDLE
                )
                if w.current_task is not None:
                    self._release_task_resources(
                        w.current_task, w.node_id
                    )
                w.current_task = None
        if _events.enabled():
            _events.record(
                _events.HEAD, task_id.hex()[:12], "HEDGE_CANCEL",
                {
                    "worker": wid.hex()[:12], "seq": seq,
                    "stale": not authentic,
                },
            )
        self._hedge_drop_reporter(task_id, wid)
        return False

    def _on_actor_created(self, aid: bytes, wid: bytes, ok: bool, error_blob=None):
        actor = self.actors.get(aid)
        if actor is None:
            return
        w = self.workers.get(wid)
        if ok:
            actor.state = A_ALIVE
            actor.worker_id = WorkerID(wid)
            if w is not None:
                w.state = W_ACTOR
                if w.actor_host:
                    w.packed[aid] = actor.spec
                else:
                    w.actor_id = actor.actor_id
                node = self.nodes[w.node_id.binary()]
                node.pool.discard(wid)  # no longer fungible
            while actor.pending:
                self._route_actor_task(actor.pending.popleft(), requeued=True)
            self._notify_direct_waiters(actor)
            self._publish("ACTOR", aid.hex(), {"state": "ALIVE"})
        else:
            actor.state = A_DEAD
            actor.death_reason = "creation task failed"
            if error_blob is not None:
                # The constructor's own error (a GPU worker that sees no
                # card, say) reaches the caller, not just the fact.
                from . import serialization

                try:
                    err = serialization.unpack(error_blob)
                    actor.death_reason += f": {type(err).__name__}: {err}"
                except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- the death reason keeps the fact of the failure without the error's text
                    pass
            self._publish(
                "ACTOR", aid.hex(),
                {"state": "DEAD", "reason": "creation task failed"},
            )
            if actor.name:
                self.named_actors.pop(actor.name, None)
            while actor.pending:
                self._fail_task_returns(
                    actor.pending.popleft(), None, actor_error=actor.death_reason
                )
            self._notify_direct_waiters(actor)
            if w is not None and w.state != W_DEAD and w.actor_host:
                # Shared host: the failed creation's resources were
                # acquired at scheduling and (unlike the dedicated path)
                # never released through current_task bookkeeping. The
                # host itself survives — co-hosted actors keep running,
                # and a host left EMPTY by the failure re-pools (a
                # stranded warm interpreter would otherwise idle forever
                # while plain tasks boot fresh workers).
                self._release_task_resources(actor.spec, w.node_id)
                self._maybe_repool_host(w)
                return
            # The worker that failed construction is pinned but useless; let
            # it exit rather than leak one process per failed creation.
            if w is not None and w.state != W_DEAD:
                w.state = W_DEAD
                if w.conn is not None:
                    try:
                        w.conn.send({"type": "exit"})
                    except ConnectionLost:
                        pass
                if w.proc is not None:
                    threading.Thread(target=_reap, args=(w.proc,), daemon=True).start()

    def _h_put_object(self, state, msg):
        with self._lock:
            cid = state.get("client_id")
            fw = self.workers.get(cid) if cid is not None else None
            if fw is not None and fw.state == W_DEAD:
                # Fenced putter: a zombie's advert lands AFTER its death
                # was processed (objects freed, actors restarted) — the
                # setdefault below would resurrect a freed id as a ghost
                # READY entry pointing at a segment nobody pins.
                self._fence_dead_client(cid, "object advert from fenced client")
                if "req_id" in msg:
                    state["peer"].reply(msg, ok=False, fenced=True)
                return
            entry = self.objects.setdefault(msg["object_id"], ObjectEntry())
            was_ready = entry.status == READY
            entry.status = READY
            # Born OWNED by the putter (object plane): the owner keeps
            # the authoritative refcount in its own process and sends
            # one release edge when it drains; no holder registration
            # happens here or on any later instance churn.
            if cid is not None:
                entry.owner = cid
                entry.had_holder = True
            if not (was_ready and entry.spilled_path is not None):
                # Skip the data-field overwrite on a DUPLICATE delivery
                # of an already-spilled object: the replayed message's
                # segment name points at the pool copy the spill
                # deleted, and re-pointing the entry there would defeat
                # the corrupt-spill -> LOST transition (which gates on
                # segment is None).
                entry.inline = msg.get("inline")
                entry.segment = msg.get("segment")
                entry.size = msg.get("size", 0)
            entry.last_access = time.time()
            if not was_ready:
                # A genuinely fresh seal (PENDING/LOST -> READY, e.g. a
                # reconstruction replacing a corrupt spill file)
                # supersedes any stale spill copy: reads must hit the
                # new bytes, and the old file unlinks now, not never.
                # A DUPLICATE delivery (put_object rides the
                # at-least-once request path across failovers) must NOT
                # touch the spill copy — after a spill it is the only
                # bytes left, and the replayed message's segment name
                # may no longer be backed by the pool.
                _drop_spill_file(entry)
            if entry.segment is not None:
                nid = state.get("obj_node_id")
                entry.node_id = NodeID(nid) if nid else self.head_node.node_id
            for child in msg.get("children", []):
                entry.children.append(child)
                self.objects.setdefault(child, ObjectEntry()).child_pins += 1
            self._notify_object(entry)
        # Fire-and-forget adverts (the shm put fast path: the value is
        # already sealed in the putter's node segment) carry no req_id;
        # only the synchronous path gets an ack.
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _object_reply_fields(self, entry: ObjectEntry) -> Dict[str, Any]:
        if entry.status == FAILED:
            return {"ok": True, "status": FAILED, "error": entry.error}
        if entry.status == LOST:
            return {"ok": True, "status": LOST}
        entry.last_access = time.time()
        fields = {
            "ok": True,
            "status": READY,
            "inline": entry.inline,
            "segment": entry.segment,
            "size": entry.size,
        }
        if entry.spilled_path is not None:
            fields["spilled_path"] = entry.spilled_path
        if (
            entry.segment is not None or entry.spilled_path is not None
        ) and entry.node_id is not None:
            # Location for cross-node pulls (reference: the ownership-based
            # object directory resolving a copy's node + transfer endpoint).
            node = self.nodes.get(entry.node_id.binary())
            fields["node_id"] = entry.node_id.binary()
            fields["transfer_addr"] = node.transfer_addr if node else ""
        return fields

    def _notify_object(self, entry: ObjectEntry):
        waiters, entry.waiters = entry.waiters, []
        fields = self._object_reply_fields(entry)
        for peer, req_id in waiters:
            try:
                peer.send({"type": "reply", "req_id": req_id, **fields})
            except ConnectionLost:
                pass
        if entry.subscribers:
            subs, entry.subscribers = entry.subscribers, []
            for peer, oid in subs:
                try:
                    peer.send(("RDY", (oid,)))
                except ConnectionLost:
                    pass

    def _h_get_object(self, state, msg):
        peer: PeerConn = state["peer"]
        with self._lock:
            entry = self.objects.get(msg["object_id"])
            if entry is None and self.objects.is_tombstoned(
                msg["object_id"]
            ):
                # Already freed: answer LOST now — parking a waiter on
                # a resurrected PENDING ghost would wedge this get
                # forever (the getter reconstructs from lineage or
                # surfaces ObjectLostError).
                peer.reply(msg, ok=True, status=LOST)
                return
            if entry is None:
                entry = self.objects.setdefault(
                    msg["object_id"], ObjectEntry()
                )
                # Born from a question, not a fact: if no producer or
                # owner ever claims it, it goes LOST after a grace
                # (the parked get must not wedge on a submit that died
                # with a previous head).
                self._note_ghost(msg["object_id"])
            if entry.status == PENDING:
                entry.waiters.append((peer, msg["req_id"]))
                return
            fields = self._object_reply_fields(entry)
        peer.reply(msg, **fields)

    def _h_check_ready(self, state, msg):
        with self._lock:
            ready = [
                oid
                for oid in msg["object_ids"]
                if self.objects.get(oid) is not None
                and self.objects[oid].status != PENDING
            ]
        state["peer"].reply(msg, ok=True, ready=ready)

    def _h_wait_subscribe(self, state, msg):
        """One-shot readiness subscription: already-sealed ids come back
        in the reply, the rest are pushed as ("RDY", [oid]) on seal —
        the client never polls (reference: raylet/wait_manager.h)."""
        peer: PeerConn = state["peer"]
        with self._lock:
            ready = []
            for oid in msg["object_ids"]:
                entry = self.objects.get(oid)
                if entry is None:
                    entry = self.objects.setdefault(oid, ObjectEntry())
                    self._note_ghost(oid)  # see _h_get_object
                if entry.status != PENDING:
                    ready.append(oid)
                else:
                    entry.subscribers.append((peer, oid))
        peer.reply(msg, ok=True, ready=ready)

    def _h_wait_any(self, state, msg):
        """Block until any of object_ids is sealed (client enforces timeout)."""
        peer: PeerConn = state["peer"]
        with self._lock:
            for oid in msg["object_ids"]:
                entry = self.objects.get(oid)
                if entry is None:
                    entry = self.objects.setdefault(oid, ObjectEntry())
                    self._note_ghost(oid)  # see _h_get_object
                if entry.status != PENDING:
                    peer.reply(msg, ok=True)
                    return
            for oid in msg["object_ids"]:
                self.objects[oid].waiters.append((peer, msg["req_id"]))

    def _free_entry(self, oid: bytes, freed: List[bytes]) -> None:
        """Drop an entry, cascading child unpins (must hold the lock)."""
        entry = self.objects.pop(oid, None)
        if entry is None:
            return
        self._dispose_entry(oid, entry, freed)

    def _dispose_entry(self, oid: bytes, entry: ObjectEntry,
                       freed: List[bytes]) -> None:
        """Post-pop cleanup: store/spill reclaim + child-pin cascade
        (must hold the lock)."""
        # Tombstone: late refcount traffic / gets for this oid must
        # fail fast, never resurrect a forever-PENDING ghost.
        self.objects.note_tombstone(oid)
        if entry.segment:
            self._store.delete(ObjectID(oid))
        if entry.spilled_path:
            try:
                os.unlink(entry.spilled_path)
            except OSError:
                pass
        freed.append(oid)
        for child in entry.children:
            ce = self.objects.get(child)
            if ce is not None:
                ce.child_pins = max(0, ce.child_pins - 1)
                self._maybe_free(child, ce, freed)

    def _maybe_free(self, oid: bytes, entry: ObjectEntry, freed: List[bytes]) -> None:
        """Auto-free when nothing references the entry (must hold the
        lock). Owned entries free on the owner's release edge; ownerless
        (fallback/promoted) entries free when their holder set drains
        having been non-empty — a fresh result whose advertisement
        hasn't landed yet must not be reclaimed. Either way, live
        borrower shadows, pins, waiters, and PENDING status hold it."""
        if entry.status == PENDING or entry.waiters:
            return
        if entry.task_pins > 0 or entry.child_pins > 0:
            return
        if entry.holders:
            return
        if (
            entry.promoted_hold_until
            and time.monotonic() < entry.promoted_hold_until
        ):
            # Dead-owner grace: a borrow edge buffered in an unflushed
            # ref_flush batch may still land. The health loop re-checks
            # once the hold expires (_drain_promoted_graves).
            return
        if entry.owner_released or (
            entry.owner is None and entry.had_holder
        ):
            self._free_entry(oid, freed)

    def _broadcast_free(self, freed: List[bytes]) -> None:
        if not freed:
            return
        # Upper-bound counter (bumped at daemon registration, dropped at
        # daemon death): the common single-host case skips the lock +
        # node scan entirely — at release-storm rates that contention
        # was measurable against the dispatch threads.
        if not self._daemon_conn_count:
            return
        with self._lock:
            daemons = [
                n.conn for n in self.nodes.values() if n.alive and n.conn is not None
            ]
        for conn in daemons:
            try:
                # raylint: disable=raw-send-on-gcs-path -- head->daemon push: a lost conn means the daemon died and its store (holding the freed copies) died with it
                conn.send({"type": "free_objects", "object_ids": freed})
            except ConnectionLost:
                pass

    def _h_update_refs(self, state, msg):
        """Legacy centralized 0<->1 holder transitions (LegacyRefTracker
        / head-fallback semantics). The dispatch loop only splits the
        batch onto the shard flush queues; per-object holder mutation
        and the early-drop ledger run on the shard appliers."""
        cid = msg["client"]
        ops: List[tuple] = []
        for oid in msg.get("add", ()):
            ops.append(("add", oid, cid))
        for oid in msg.get("remove", ()):
            ops.append(("remove", oid, cid))
        if ops:
            counts = self.objects.enqueue(ops)
            if _events.enabled():
                _events.record(
                    _events.REFS, cid.hex()[:12], "SHARD_ENQUEUE",
                    {"ops": len(ops), "shards": len(counts)},
                )

    def _h_ref_flush(self, state, msg):
        """One client's batched ownership-edge transitions (object
        plane). Sequenced at-least-once: the tracker numbers every
        batch and retransmits until acked; this side acks on receipt
        and runs a per-conn reorder/dedup buffer so batches apply in
        submission order even when the transport (or the chaos engine)
        drops, duplicates, or reorders them. Legacy un-numbered batches
        (client proxy, old peers) apply directly."""
        seq = msg.get("seq")
        if seq is None:
            self._apply_ref_flush(state, msg)
            return
        try:
            state["peer"].send({"type": "ref_flush_ack", "seq": seq})
        except ConnectionLost:
            pass
        seqr = state.get("ref_seq")
        if seqr is None:
            # start_seq=1: the tracker numbers from 1 per connection, so
            # a dropped FIRST batch must read as a gap (await/accept the
            # retransmit), never as an already-applied duplicate.
            seqr = state["ref_seq"] = _chaos.InOrderSequencer(start_seq=1)
        for m in seqr.offer(seq, msg):
            self._apply_ref_flush(state, m)

    def _apply_ref_flush(self, state, msg):
        """Apply one in-order batch: owner releases, borrow edges
        (relayed to the owning client), and head-fallback add/removes
        for ownerless refs. NOTHING here mutates per-object state —
        releases and holder shadows enqueue to the shard flush queues;
        borrow edges relay as one send per owner."""
        cid = msg["client"]
        with self._lock:
            fw = self.workers.get(cid)
            if fw is not None and fw.state == W_DEAD:
                # Fenced refcount traffic: the death sweep already
                # retracted this client's edges; replaying its buffered
                # batch would plant borrow edges that are never removed.
                self._fence_dead_client(cid, "ref_flush from fenced client")
                return
        ops: List[tuple] = []
        for oid in msg.get("release", ()):
            ops.append(("release", oid, cid))
        badd = msg.get("badd", ())
        bdel = msg.get("bdel", ())
        for _owner, oid in badd:
            ops.append(("badd", oid, cid))
        for _owner, oid in bdel:
            ops.append(("bdel", oid, cid))
        for oid in msg.get("add", ()):
            ops.append(("add", oid, cid))
        for oid in msg.get("remove", ()):
            ops.append(("remove", oid, cid))
        if ops:
            counts = self.objects.enqueue(ops)
            if _events.enabled():
                _events.record(
                    _events.REFS, cid.hex()[:12], "SHARD_ENQUEUE",
                    {"ops": len(ops), "shards": len(counts)},
                )
        if badd or bdel:
            groups: Dict[bytes, Tuple[List[bytes], List[bytes]]] = {}
            for owner, oid in badd:
                groups.setdefault(owner, ([], []))[0].append(oid)
            for owner, oid in bdel:
                groups.setdefault(owner, ([], []))[1].append(oid)
            with self._lock:
                targets = [
                    (owner, self.client_conns.get(owner), a, r)
                    for owner, (a, r) in groups.items()
                ]
                for owner, conn, a, _r in targets:
                    if a and conn is not None:
                        self.borrow_edges.setdefault(cid, set()).add(owner)
            for owner, conn, a, r in targets:
                if conn is None:
                    # Owner gone: the entry was (or will be) promoted to
                    # head-fallback; the shard-applied holder shadow
                    # carries the borrow from here.
                    continue
                try:
                    conn.send(
                        {
                            "type": "borrow_update", "borrower": cid,
                            "add": a, "remove": r,
                        }
                    )
                except ConnectionLost:
                    pass

    def _relay_borrow_adds(self, notify: List[Tuple[bytes, bytes, bytes]]):
        """Task-done piggybacked borrows: tell each owner about its new
        borrower (one send per owner). Called without the GCS lock."""
        if not notify:
            return
        groups: Dict[Tuple[bytes, bytes], List[bytes]] = {}
        for owner, borrower, oid in notify:
            if self.objects.is_dead_client(borrower):
                # Died between task_done dispatch and this relay: a
                # borrow add for it would never be retracted.
                continue
            groups.setdefault((owner, borrower), []).append(oid)
        with self._lock:
            targets = [
                (owner, borrower, self.client_conns.get(owner), oids)
                for (owner, borrower), oids in groups.items()
            ]
            for owner, borrower, conn, _o in targets:
                if conn is not None:
                    self.borrow_edges.setdefault(borrower, set()).add(owner)
        for owner, borrower, conn, oids in targets:
            if conn is None:
                continue
            try:
                conn.send(
                    {
                        "type": "borrow_update", "borrower": borrower,
                        "add": oids, "remove": [],
                    }
                )
            except ConnectionLost:
                pass

    def _notify_borrower_died(self, cid: bytes, owners) -> None:
        """A borrowing client died without retracting: each owner sweeps
        its borrow edges so owned objects can still release."""
        with self._lock:
            conns = [self.client_conns.get(o) for o in owners]
        for conn in conns:
            if conn is None:
                continue
            try:
                conn.send({"type": "borrower_died", "client": cid})
            except ConnectionLost:
                pass

    #: Frees per GCS-lock acquisition on the applier path: a release
    #: flood (a driver dropping 50k refs at once) must not hold the
    #: lock for seconds — that stalls lease_worker replies past the
    #: client-side idle-return window and wedges lease growth.
    _FREE_CHUNK = 512

    def _free_candidates(self, oids: List[bytes]) -> None:
        """Shard-applier callback: entries that drained. Re-check and
        free under the GCS lock (waiters/pins/store are coherent only
        here); the applier holds no locks when calling. Chunked so a
        flood shares the lock with the dispatch threads."""
        freed: List[bytes] = []
        pop_reclaimable = self.objects.pop_reclaimable
        for start in range(0, len(oids), self._FREE_CHUNK):
            chunk = oids[start:start + self._FREE_CHUNK]
            n0 = len(freed)
            with self._lock:
                for oid in chunk:
                    # check+pop fused into one shard-lock acquisition:
                    # this loop runs inside the serialized region the
                    # dispatch hot path waits on.
                    entry = pop_reclaimable(oid)
                    if entry is not None:
                        self._dispose_entry(oid, entry, freed)
                if len(freed) > n0:
                    # Only chunks that actually freed dirty the table.
                    self._version += 1
                    self._table_versions["objects"] += 1
        self._broadcast_free(freed)

    def _release_converted_pins(self, oids: List[bytes]) -> None:
        """Shard-applier callback: pin->borrow conversions have landed;
        hand back the dependency pins held through the conversion."""
        freed: List[bytes] = []
        with self._lock:
            for oid in oids:
                entry = self.objects.get(oid)
                if entry is not None:
                    entry.task_pins = max(0, entry.task_pins - 1)
                    self._maybe_free(oid, entry, freed)
            if freed:
                # Frees are durable objects-table state (same contract
                # as _free_candidates).
                self._version += 1
                self._table_versions["objects"] += 1
        self._broadcast_free(freed)

    def _sweep_client_refs(self, cid: bytes) -> None:
        """A client process is gone: drop the fallback holds it had and
        promote the objects it OWNED to head-fallback management (the
        holder shadow — its live borrowers — keeps them alive; an
        unborrowed dead-owner object frees once its pins drain).

        Promoted entries get a grace window before they become
        reclaimable: a borrower's badd for this object may still sit in
        an unflushed/in-retransmit ref_flush batch, and freeing before
        it lands would drop a live borrow edge (the unflushed-batch
        owner-death race). The health loop revisits them on expiry."""
        freed: List[bytes] = []
        promoted = 0
        hold_until = time.monotonic() + RayConfig.owner_death_grace_s
        # BEFORE touching holder sets: queued-but-unapplied holder ops
        # for this client must not resurrect after the sweep below.
        self.objects.note_dead_client(cid)
        self._dead_resweeps.append((hold_until, cid))
        with self._lock:
            for oid, entry in self.objects.items():
                if entry.owner == cid:
                    entry.owner = None
                    entry.had_holder = True
                    entry.promoted_hold_until = hold_until
                    promoted += 1
                    self._promoted_graves.append((hold_until, oid))
                if cid in entry.holders:
                    entry.holders.discard(cid)
                self._maybe_free(oid, entry, freed)
        if promoted and _events.enabled():
            _events.record(
                _events.REFS, cid.hex()[:12], "OWNER_FALLBACK",
                {"promoted": promoted, "freed": len(freed)},
            )
        self._broadcast_free(freed)

    def _h_reconcile(self, state, msg):
        """A reconnecting owner re-advertises the objects it OWNS plus
        their live borrow edges (head failover: the restarted head's
        object soft state is rebuilt from bearers of truth, not
        persisted). Each item is (oid, location-or-None, [borrowers],
        inline-or-None); a location means the owner's local store still
        holds the sealed bytes, and inline bytes are an inline-only put
        the owner kept, so the entry can answer gets immediately."""
        _chaos.kill_point("gcs.recovery")
        cid = msg["client"]
        claimed = 0
        borrow_ops: List[tuple] = []
        with self._lock:
            nid = state.get("obj_node_id")
            node_id = NodeID(nid) if nid else self.head_node.node_id
            for oid, loc, borrowers, *rest in msg.get("owned", ()):
                inline = rest[0] if rest else None
                entry = self.objects.setdefault(oid, ObjectEntry())
                if entry.owner is None:
                    entry.owner = cid
                if entry.owner == cid:
                    # The owner lives: whatever promoted/released state
                    # a racing sweep left behind is superseded.
                    entry.owner_released = False
                    entry.promoted_hold_until = 0.0
                entry.had_holder = True
                for b in borrowers:
                    if not self.objects.is_dead_client(b):
                        # Holder shadows apply on the shard appliers
                        # (never on this dispatch thread).
                        borrow_ops.append(("badd", oid, b))
                if loc and entry.status == PENDING:
                    entry.status = READY
                    entry.segment = loc
                    entry.node_id = node_id
                    entry.last_access = time.time()
                    self._notify_object(entry)
                elif inline is not None and entry.status == PENDING:
                    # An inline-only put this head never persisted (or
                    # knows only as a dependency of a task resubmitted
                    # since): its owner's bytes. Left PENDING, a task
                    # pinning it waited forever.
                    entry.status = READY
                    entry.inline = inline
                    entry.size = len(inline)
                    entry.last_access = time.time()
                    self._notify_object(entry)
                elif entry.status == PENDING:
                    # Claimed but data-less (a return ref whose result
                    # lives elsewhere): if no producer re-claims it
                    # either, it must expire to LOST, not wedge gets.
                    self._note_ghost(oid)
                self._restored_unclaimed.discard(oid)
                claimed += 1
        if borrow_ops:
            self.objects.enqueue(borrow_ops)
        if _events.enabled() and claimed:
            _events.record(
                _events.HEAD, cid.hex()[:12], "RECONCILE_CLAIM",
                {"owned": claimed, "borrow_edges": len(borrow_ops)},
            )
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _h_free_objects(self, state, msg):
        freed: List[bytes] = []
        with self._lock:
            for oid in msg["object_ids"]:
                self._free_entry(oid, freed)
        self._broadcast_free(list(set(freed) | set(msg["object_ids"])))
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    # KV (reference: gcs_kv_manager.cc; python facade experimental/internal_kv.py)
    def _h_kv_put(self, state, msg):
        ns = self.kv.setdefault(msg.get("ns", ""), {})
        with self._lock:
            existed = msg["key"] in ns
            if not existed or msg.get("overwrite", True):
                ns[msg["key"]] = msg["value"]
        state["peer"].reply(msg, ok=True, added=not existed)

    def _h_kv_get(self, state, msg):
        with self._lock:
            val = self.kv.get(msg.get("ns", ""), {}).get(msg["key"])
        state["peer"].reply(msg, ok=True, value=val)

    def _h_kv_del(self, state, msg):
        with self._lock:
            existed = self.kv.get(msg.get("ns", ""), {}).pop(msg["key"], None)
        state["peer"].reply(msg, ok=True, deleted=existed is not None)

    def _h_kv_exists(self, state, msg):
        with self._lock:
            exists = msg["key"] in self.kv.get(msg.get("ns", ""), {})
        state["peer"].reply(msg, ok=True, exists=exists)

    def _h_kv_keys(self, state, msg):
        with self._lock:
            keys = [
                k
                for k in self.kv.get(msg.get("ns", ""), {})
                if k.startswith(msg.get("prefix", b""))
            ]
        state["peer"].reply(msg, ok=True, keys=keys)

    def _h_reserve_actor_name(self, state, msg):
        """Atomic get-or-reserve for named actors: returns the existing
        actor id if the name is taken, else records name -> proposed id.
        Eliminates the create/get race in get_if_exists (reference:
        GcsActorManager named-actor registration)."""
        with self._lock:
            existing = self.named_actors.get(msg["name"])
            if existing is not None:
                state["peer"].reply(msg, ok=True, actor_id=existing, created=False)
                return
            self.named_actors[msg["name"]] = msg["actor_id"]
        state["peer"].reply(msg, ok=True, actor_id=msg["actor_id"], created=True)

    def _h_release_actor_name(self, state, msg):
        """Undo a reservation whose creation never materialized (client-side
        failure between reserve and submit)."""
        with self._lock:
            aid = self.named_actors.get(msg["name"])
            if aid == msg["actor_id"] and aid not in self.actors:
                self.named_actors.pop(msg["name"], None)
                for spec in self._orphan_actor_tasks.pop(aid, []):
                    self._fail_task_returns(
                        spec, None, actor_error="actor creation never submitted"
                    )
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _h_get_actor(self, state, msg):
        with self._lock:
            aid = msg.get("actor_id")
            if aid is None:
                aid = self.named_actors.get(msg["name"])
            actor = self.actors.get(aid) if aid else None
            if actor is None:
                state["peer"].reply(msg, ok=False, error="actor not found")
                return
            state["peer"].reply(
                msg,
                ok=True,
                actor_id=actor.actor_id.binary(),
                state=actor.state,
                spec_function_id=actor.spec.function_id,
                max_concurrency=actor.spec.max_concurrency,
            )

    def _h_lease_worker(self, state, msg):
        """Grant an idle CPU worker to a client for direct task pushes
        (reference: RequestWorkerLease, node_manager.cc:1794 — here at
        burst granularity instead of per task). Resources stay acquired
        until return_lease or worker death."""
        res = {k: v for k, v in msg.get("resources", {}).items() if v > 0}
        with self._lock:
            rid = state.get("client_id")
            rw = self.workers.get(rid) if rid is not None else None
            if rw is not None and rw.state == W_DEAD:
                # Fenced lessee: granting to a declared-dead client would
                # strand the worker until its conn (already presumed
                # gone) closes — and a zombie must not run new work.
                self._fence_dead_client(rid, "lease request from fenced client")
                state["peer"].reply(msg, ok=False, fenced=True)
                return
            lessee_node = self.nodes.get(state.get("obj_node_id", b""))
            for node in self.nodes.values():
                if not node.alive or not node.schedulable:
                    continue
                # Direct sockets are per-machine (unix paths): grant only
                # workers the lessee can actually reach — its own node, or
                # anywhere in the head's single-machine process tree
                # (head + virtual nodes, conn is None).
                reachable = lessee_node is not None and (
                    node.node_id == lessee_node.node_id
                    or (
                        node.conn is None
                        and lessee_node.conn is None
                        and lessee_node.schedulable
                    )
                )
                if not reachable:
                    continue
                if not _fits(node.available, res):
                    continue
                for wid in list(node.pool):
                    w = self.workers.get(wid)
                    if (
                        w is not None
                        and w.state == W_IDLE
                        and w.conn is not None
                        and not w.gpus
                        and w.direct_addr
                    ):
                        _acquire(node.available, res)
                        w.state = W_LEASED
                        w.lease_resources = dict(res)
                        # Tie the lease to the lessee's connection so a
                        # dead client can't strand leased workers.
                        state.setdefault("held_leases", set()).add(wid)
                        _events.record(
                            _events.LEASE, w.worker_id.hex(), "GRANTED",
                            {"node": node.node_id.hex()[:12]},
                        )
                        state["peer"].reply(
                            msg, ok=True, worker_id=wid, addr=w.direct_addr
                        )
                        return
                # No idle worker here: prestart one for the next attempt.
                starting = sum(
                    1
                    for w in self.workers.values()
                    if w.node_id == node.node_id
                    and w.state == W_STARTING
                    and not w.gpus
                )
                pool_cpu = sum(
                    1
                    for wid in node.pool
                    if (w := self.workers.get(wid)) is not None and not w.gpus
                )
                if pool_cpu + starting < max(int(node.total.get("CPU", 1)), 1):
                    self._spawn_worker(node)
            state["peer"].reply(msg, ok=True, addr=None)

    def _h_return_lease(self, state, msg):
        state.get("held_leases", set()).discard(msg["worker_id"])
        self._release_lease(msg["worker_id"])

    def _release_lease(self, wid: bytes):
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.state != W_LEASED:
                return
            _events.record(_events.LEASE, w.worker_id.hex(), "RETURNED")
            node = self.nodes.get(w.node_id.binary())
            if node is not None and w.lease_resources:
                _release(node.available, w.lease_resources)
            w.lease_resources = None
            w.state = W_IDLE
            self._work.notify_all()

    def _h_get_actor_direct(self, state, msg):
        """Resolve an actor's direct-call socket. Restartable actors stay
        on the GCS route (the direct conn can't survive a restart
        transparently); lookups for PENDING actors park until the actor
        is ALIVE or dead (the client buffers calls meanwhile)."""
        with self._lock:
            actor = self.actors.get(msg["actor_id"])
            if actor is None or actor.state == A_DEAD:
                state["peer"].reply(msg, ok=True, fallback=True)
                return
            if actor.spec.max_restarts > 0:
                state["peer"].reply(msg, ok=True, fallback=True)
                return
            if actor.state != A_ALIVE or actor.worker_id is None:
                actor.direct_waiters.append((state["peer"], msg["req_id"]))
                return
            self._answer_direct_waiter(actor, state["peer"], msg["req_id"])

    def _answer_direct_waiter(self, actor: "ActorState", peer, req_id):
        fields: Dict[str, Any] = {"ok": True}
        w = (
            self.workers.get(actor.worker_id.binary())
            if actor.worker_id is not None
            else None
        )
        if actor.state == A_ALIVE and w is not None and w.direct_addr:
            fields["addr"] = w.direct_addr
        else:
            fields["fallback"] = True
        try:
            peer.send({"type": "reply", "req_id": req_id, **fields})
        except ConnectionLost:
            pass

    def _notify_direct_waiters(self, actor: "ActorState"):
        waiters, actor.direct_waiters = actor.direct_waiters, []
        for peer, req_id in waiters:
            self._answer_direct_waiter(actor, peer, req_id)

    def _h_cancel_task(self, state, msg):
        """Cancels a task still queued here, before any worker took it:
        its returns fail with TaskCancelledError. A task already placed,
        or not queued at the head, is left alone; the reply says which."""
        from ..exceptions import TaskCancelledError

        with self._lock:
            spec = self._pending.remove_returning(msg["object_id"])
            if spec is not None:
                self._version += 1
                self._table_versions["pending"] += 1
                self._fail_task_returns(
                    spec, TaskCancelledError(f"task {spec.name} was cancelled")
                )
        state["peer"].reply(msg, ok=True, cancelled=spec is not None)

    def _h_kill_actor(self, state, msg):
        with self._lock:
            self._kill_actor(msg["actor_id"], reason=msg.get("reason", "ray.kill"))
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _kill_actor(self, aid: bytes, reason: str):
        actor = self.actors.get(aid)
        if actor is None or actor.state == A_DEAD:
            return
        actor.state = A_DEAD
        actor.death_reason = reason
        self._publish("ACTOR", aid.hex(), {"state": "DEAD", "reason": reason})
        if actor.name:
            self.named_actors.pop(actor.name, None)
        while actor.pending:
            self._fail_task_returns(actor.pending.popleft(), None, actor_error=reason)
        self._notify_direct_waiters(actor)
        if actor.worker_id is not None:
            wid = actor.worker_id.binary()
            w = self.workers.get(wid)
            if w is not None and w.state != W_DEAD and aid in w.packed:
                # Packed actor on a shared host: terminate JUST this
                # actor — co-hosted actors keep running. In-flight calls
                # for it fail fast; an emptied host returns to the
                # fungible pool as a warm prestarted worker.
                self._release_task_resources(actor.spec, w.node_id)
                w.packed.pop(aid, None)
                for tid, s in list(w.inflight.items()):
                    if s.actor_id is not None and s.actor_id.binary() == aid:
                        w.inflight.pop(tid)
                        self._fail_task_returns(s, None, actor_error=reason)
                if w.conn is not None:
                    try:
                        w.conn.send(
                            {"type": "terminate_actor", "actor_id": aid}
                        )
                    except ConnectionLost:
                        pass
                self._maybe_repool_host(w)
                return
            if w is not None and w.state != W_DEAD:
                # Creation-lifetime resources: the death handler's actor
                # branch skips them for already-A_DEAD actors.
                self._release_task_resources(actor.spec, w.node_id)
                if w.conn is not None:
                    try:
                        w.conn.send({"type": "exit"})
                    except ConnectionLost:
                        pass
                if w.proc is not None:
                    # Force-kill semantics (reference: ray.kill is
                    # SIGKILL, no graceful drain): without this the
                    # worker keeps serving direct-transport calls until
                    # it notices the polite exit, and a call racing the
                    # kill can still succeed.
                    try:
                        w.proc.kill()
                    except Exception:  # noqa: BLE001
                        pass
                # Full worker teardown — fails the worker's in-flight
                # GCS-routed tasks (callers would otherwise park on
                # their returns forever), releases lease resources,
                # drops it from the node pool, reaps the process. The
                # actor is already A_DEAD above, so no restart is
                # attempted.
                self._handle_worker_death(wid, f"actor killed: {reason}")

    def _h_actor_exit(self, state, msg):
        # Graceful self-exit (__ray_terminate__).
        with self._lock:
            self._kill_actor(msg["actor_id"], reason="actor exited")

    def _h_msg_counts(self, state, msg):
        with self._lock:
            state["peer"].reply(msg, ok=True, counts=dict(self.msg_counts))

    def _h_cluster_info(self, state, msg):
        with self._lock:
            total: Dict[str, float] = {}
            avail: Dict[str, float] = {}
            nodes = []
            for n in self.nodes.values():
                if not n.alive:
                    continue
                for k, v in n.total.items():
                    total[k] = total.get(k, 0.0) + v
                for k, v in n.available.items():
                    avail[k] = avail.get(k, 0.0) + v
                nodes.append(
                    {
                        "node_id": n.node_id.binary(),
                        "label": n.label,
                        "alive": n.alive,
                        "incarnation": n.incarnation,
                        "total": dict(n.total),
                        "available": dict(n.available),
                        "health_score": round(n.health_score, 3),
                        "quarantined": n.quarantined,
                        "hedges_won": n.hedges_won,
                        "hedges_lost": n.hedges_lost,
                    }
                )
            stragglers = {
                "hedges": dict(self._hedge_stats),
                "quarantine": dict(self._quarantine_stats),
                "scorer_errors": self._scorer_errors,
            }
        state["peer"].reply(msg, ok=True, total=total, available=avail,
                            nodes=nodes, stragglers=stragglers)

    def _h_ping(self, state, msg):
        state["peer"].reply(msg, ok=True, ts=time.time())

    # ------------------------------------------------------- placement groups

    def _h_create_placement_group(self, state, msg):
        peer = state["peer"]
        with self._lock:
            pg = PlacementGroupState(
                pg_id=PlacementGroupID(msg["pg_id"]),
                bundles=[
                    BundleState(resources=dict(b), available=dict(b))
                    for b in msg["bundles"]
                ],
                strategy=msg["strategy"],
                name=msg.get("name", ""),
            )
            ok, err = self._try_reserve_pg(pg)
            if ok:
                pg.state = "CREATED"
            else:
                # Not placeable right now. Reference semantics
                # (gcs_placement_group_manager): a PG that fits the
                # cluster's TOTAL capacity queues PENDING and places
                # when resources free up (e.g. leased workers return);
                # only structurally infeasible requests fail fast.
                total_ok, _ = self._try_reserve_pg(pg, dry_totals=True)
                if not total_ok and not self.autoscaling_hint:
                    peer.reply(msg, ok=False, error=err)
                    return
                pg.state = "PENDING"
            self.placement_groups[pg.pg_id.binary()] = pg
            self._work.notify_all()
        peer.reply(msg, ok=True)

    def _try_reserve_pg(
        self, pg: PlacementGroupState, dry_totals: bool = False
    ) -> Tuple[bool, str]:
        """Reserve all bundles atomically (the reference needs 2PC across
        raylets — gcs_placement_group_scheduler.h:113; with the resource
        authority centralized here, reserve-all-or-nothing is one
        transaction under the table lock). ``dry_totals`` answers "could
        this EVER place on an idle cluster" without committing."""
        nodes = [n for n in self.nodes.values() if n.alive]
        placement: List[Tuple[BundleState, NodeState]] = []
        scratch = {
            n.node_id.binary(): dict(n.total if dry_totals else n.available)
            for n in nodes
        }
        strategy = pg.strategy

        def try_place(bundle: BundleState, candidates: List[NodeState]) -> bool:
            for n in candidates:
                if _fits(scratch[n.node_id.binary()], bundle.resources):
                    _acquire(scratch[n.node_id.binary()], bundle.resources)
                    placement.append((bundle, n))
                    return True
            return False

        if strategy in ("PACK", "STRICT_PACK"):
            # Fill one node first; STRICT_PACK fails if one node can't hold all.
            for bundle in pg.bundles:
                order = sorted(
                    nodes,
                    key=lambda n: -sum(
                        1 for b, pn in placement if pn.node_id == n.node_id
                    ),
                )
                if strategy == "STRICT_PACK" and placement:
                    order = [placement[0][1]]
                if not try_place(bundle, order):
                    return False, f"cannot place bundle {bundle.resources} ({strategy})"
        elif strategy in ("SPREAD", "STRICT_SPREAD"):
            for bundle in pg.bundles:
                used = {pn.node_id.binary() for b, pn in placement}
                fresh = [n for n in nodes if n.node_id.binary() not in used]
                candidates = fresh if strategy == "STRICT_SPREAD" else fresh + [
                    n for n in nodes if n.node_id.binary() in used
                ]
                if not try_place(bundle, candidates):
                    return False, f"cannot place bundle {bundle.resources} ({strategy})"
        else:
            return False, f"unknown strategy {strategy}"

        if dry_totals:
            return True, ""
        for bundle, node in placement:
            _acquire(node.available, bundle.resources)
            bundle.node_id = node.node_id
        return True, ""

    def _h_remove_placement_group(self, state, msg):
        with self._lock:
            pg = self.placement_groups.pop(msg["pg_id"], None)
            if pg is not None:
                for bundle in pg.bundles:
                    if bundle.node_id is not None:
                        node = self.nodes.get(bundle.node_id.binary())
                        if node is not None:
                            # Return only the bundle's free headroom now;
                            # resources held by still-running tasks flow back
                            # to the node when those tasks finish (the PG is
                            # gone, so _release_task_resources falls through
                            # to the node pool).
                            _release(node.available, bundle.available)
                pg.state = "REMOVED"
            self._work.notify_all()
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True)

    def _h_wait_placement_group(self, state, msg):
        """Park until the PG reserves (or is removed); the client's
        request timeout bounds the wait — no polling."""
        with self._lock:
            pg = self.placement_groups.get(msg["pg_id"])
            if pg is None:
                state["peer"].reply(msg, ok=False, error="no such pg")
                return
            if pg.state != "PENDING":
                state["peer"].reply(msg, ok=True, state=pg.state)
                return
            pg.waiters.append((state["peer"], msg["req_id"]))

    def _notify_pg_waiters(self, pg) -> None:
        """Caller holds the lock; answers everyone parked on this PG."""
        waiters, pg.waiters = pg.waiters, []
        for peer, req_id in waiters:
            try:
                peer.send(
                    {"type": "reply", "req_id": req_id, "ok": True,
                     "state": pg.state}
                )
            except Exception:  # noqa: BLE001 - waiter gone
                pass

    def _h_placement_group_info(self, state, msg):
        with self._lock:
            pg = self.placement_groups.get(msg["pg_id"])
            if pg is None:
                state["peer"].reply(msg, ok=False, error="placement group not found")
                return
            state["peer"].reply(
                msg,
                ok=True,
                state=pg.state,
                bundles=[
                    {
                        "resources": dict(b.resources),
                        "available": dict(b.available),
                        "node_id": b.node_id.binary() if b.node_id else None,
                    }
                    for b in pg.bundles
                ],
            )

    # ------------------------------------------------------------ state API

    #: A read barrier waits this long for a worker whose completions the
    #: reader does not hold (best effort: they are not its writes).
    _READ_BARRIER_BRIEF_S = 0.25
    #: ... and up to this long, while the worker lives, for one whose
    #: completions it holds (they are its writes).
    _READ_BARRIER_HELD_S = 30.0

    def _barrier_flush_events(self, state, msg) -> None:
        """Read-your-writes for task/object listings. Completions from
        direct/leased calls are coalesced by each worker's _DoneBatcher
        (worker_main.py) for a few ms before the GCS sees them, so a
        list issued right after get() could miss tasks the caller knows
        finished. Ask every live worker to flush and wait for acks — the
        submit hot path stays batched; the rare observability read pays
        one round-trip (reference: the state API forces a task-event
        buffer flush on read, task_event_buffer.h). A worker's ack
        follows its flushed batch on one connection, so once it is in,
        so are that worker's completions.

        The reader names the workers and actors it pushed calls to since
        its last read (``flush_workers``, ``flush_actors``;
        client.state_read): their completions are results it already
        holds. The read waits for each of those workers' acks while the
        worker lives (a loaded host can take longer than the brief window
        to answer, and the read then missed completions its caller had
        seen); for the rest it waits ``_READ_BARRIER_BRIEF_S``. A held
        worker that has not answered within ``_READ_BARRIER_HELD_S`` is
        recorded (READ_BARRIER_INCOMPLETE), never silently skipped.

        When the listing request came FROM a worker, its conn reader
        thread is the one blocked in this barrier — pinging it would
        deadlock until timeout (its ack could never be dispatched), so
        it is left out. The worker flushes its own batcher client-side
        before sending the request instead (state/api.py _list)."""
        exclude_wid = state.get("worker_id")
        held = set(msg.get("flush_workers") or ())
        with self._lock:
            for aid in msg.get("flush_actors") or ():
                actor = self.actors.get(aid)
                if actor is not None and actor.worker_id is not None:
                    held.add(actor.worker_id.binary())
            targets = [
                (w.worker_id.binary(), w.conn)
                for w in self.workers.values()
                if w.conn is not None
                and w.state != W_STARTING
                and w.worker_id.binary() != exclude_wid
            ]
            if not targets:
                return
            self._flush_token += 1
            token = self._flush_token
            pending = {wid for wid, _ in targets}
            entry: Dict[str, Any] = {
                "pending": pending,
                "held": pending & held,
                "all": threading.Event(),
                "held_in": threading.Event(),
            }
            if not entry["held"]:
                entry["held_in"].set()
            self._flush_waits[token] = entry
        for wid, conn in targets:
            try:
                conn.send({"type": "flush_events", "token": token})
            except ConnectionLost:
                with self._lock:
                    self._barrier_acked(entry, wid)
        entry["all"].wait(self._READ_BARRIER_BRIEF_S)
        deadline = time.monotonic() + self._READ_BARRIER_HELD_S
        while not entry["held_in"].wait(0.1):
            with self._lock:
                for wid in list(entry["held"]):
                    w = self.workers.get(wid)
                    if w is None or w.state == W_DEAD or w.conn is None \
                            or w.conn.closed:
                        self._barrier_acked(entry, wid)
                missing = list(entry["held"])
            if missing and time.monotonic() >= deadline:
                _events.record(
                    _events.HEAD, "read_barrier", "READ_BARRIER_INCOMPLETE",
                    {"workers": [wid.hex()[:12] for wid in missing]},
                )
                break
        with self._lock:
            self._flush_waits.pop(token, None)

    @staticmethod
    def _barrier_acked(entry: Dict[str, Any], wid: bytes) -> None:
        """Caller holds self._lock."""
        entry["pending"].discard(wid)
        entry["held"].discard(wid)
        if not entry["pending"]:
            entry["all"].set()
        if not entry["held"]:
            entry["held_in"].set()

    def _h_events_flushed(self, state, msg):
        with self._lock:
            entry = self._flush_waits.get(msg.get("token"))
            if entry is not None:
                self._barrier_acked(entry, state.get("worker_id"))

    def _h_list_state(self, state, msg):
        """Typed state listing for ray_tpu_torch.util.state (reference:
        util/state/api.py backed by the GCS + state aggregator)."""
        kind = msg["kind"]
        limit = msg.get("limit", 1000)
        filters = msg.get("filters") or []
        if kind in ("tasks", "objects"):
            self._barrier_flush_events(state, msg)
        with self._lock:
            if kind == "actors":
                items = [
                    {
                        "actor_id": a.actor_id.hex(),
                        "name": a.name or "",
                        "state": a.state,
                        "class_name": (
                            a.spec.name.split(".")[0] if a.spec else ""
                        ),
                        "worker_id": a.worker_id.hex() if a.worker_id else "",
                        "death_reason": a.death_reason or "",
                    }
                    for a in self.actors.values()
                ]
            elif kind == "nodes":
                items = [
                    {
                        "node_id": n.node_id.hex(),
                        "alive": n.alive,
                        "label": n.label,
                        "total": dict(n.total),
                        "available": dict(n.available),
                        "health_score": round(n.health_score, 3),
                        "quarantined": n.quarantined,
                        "hedges_won": n.hedges_won,
                        "hedges_lost": n.hedges_lost,
                    }
                    for n in self.nodes.values()
                ] + list(self.dead_nodes)
            elif kind == "workers":
                items = [
                    {
                        "worker_id": w.worker_id.hex(),
                        "state": w.state,
                        "pid": w.proc.pid if w.proc else None,
                        "node_id": w.node_id.hex(),
                        "is_actor": w.actor_id is not None,
                        "num_inflight": len(w.inflight),
                    }
                    for w in self.workers.values()
                ]
            elif kind == "objects":
                items = [
                    {
                        "object_id": oid.hex(),
                        "status": e.status,
                        "size": e.size,
                        "inline": e.inline is not None,
                    }
                    for oid, e in self.objects.items()
                ]
            elif kind == "placement_groups":
                items = [
                    {
                        "placement_group_id": pg.pg_id.hex(),
                        "state": pg.state,
                        "bundles": [dict(b.resources) for b in pg.bundles],
                        "strategy": pg.strategy,
                    }
                    for pg in self.placement_groups.values()
                ]
            elif kind == "tasks":
                # Latest event per task id wins (state transitions are
                # appended in order).
                latest: Dict[bytes, Dict[str, Any]] = {}
                for tid, name, event, ts, wid in self.task_events:
                    latest[tid] = {
                        "task_id": tid.hex(),
                        "name": name,
                        "state": event,
                        "timestamp": ts,
                        "worker_id": wid.hex() if wid else "",
                    }
                items = list(latest.values())
            else:
                state["peer"].reply(msg, ok=False, error=f"unknown kind {kind}")
                return
            # Filter BEFORE truncating, or matches past `limit` vanish.
            for key, op, value in filters:
                if op == "=":
                    items = [i for i in items if i.get(key) == value]
                elif op == "!=":
                    items = [i for i in items if i.get(key) != value]
        state["peer"].reply(msg, ok=True, items=items[:limit],
                            total=len(items))

    def _h_set_autoscaling(self, state, msg):
        with self._lock:
            self.autoscaling_hint = bool(msg.get("enabled", True))
        state["peer"].reply(msg, ok=True)

    def _h_get_pending_demand(self, state, msg):
        """Resource shapes the scheduler can't currently place — the
        autoscaler's input (reference: autoscaler v2 reads cluster
        resource state from the GCS AutoscalerStateService,
        autoscaler.proto:315). Polling this IS the autoscaler
        announcing itself: capacity becomes elastic, so over-capacity
        PGs queue as demand (self-healing across head restarts,
        unlike a one-shot flag).

        A node that holds the primary copy of a live object (in its
        store or spilled to its disk) is not idle, as in upstream Ray:
        scaling it down would lose the object under its owner, who
        could only rebuild it by running its task again. The reference
        counts such a node idle."""
        with self._lock:
            self.autoscaling_hint = True
            demands = [dict(spec.resources) for spec in self._pending]
            pg_demands = [
                [dict(b.resources) for b in pg.bundles]
                for pg in self.placement_groups.values()
                if pg.state == "PENDING"
            ]
            # The objects that die with their node (_handle_node_death).
            holding = {
                e.node_id.binary()
                for e in self.objects.values()
                if e.status == READY
                and e.node_id is not None
                and (e.segment is not None or e.spilled_path is not None)
            }
            idle_nodes = []
            for n in self.nodes.values():
                if not n.alive or n.label == "head":
                    continue
                busy = any(
                    w.node_id == n.node_id and (w.inflight or w.actor_id)
                    for w in self.workers.values()
                ) or n.node_id.binary() in holding
                if not busy and _fits(n.available, n.total):
                    idle_nodes.append(n.node_id.binary())
        state["peer"].reply(
            msg, ok=True, task_demands=demands, pg_demands=pg_demands,
            idle_nodes=idle_nodes,
        )

    def _h_list_events(self, state, msg):
        """Flight-recorder read: barrier-flush the workers (their rings
        piggyback on the done-batcher flush the barrier forces), drain
        this process's ring, then filter the aggregator."""
        self._barrier_flush_events(state, msg)
        self._drain_local_events()
        items = self.events.list(
            entity=msg.get("entity"),
            category=msg.get("category"),
            job=msg.get("job"),
            event=msg.get("event"),
            limit=msg.get("limit", 1000),
        )
        state["peer"].reply(msg, ok=True, events=items)

    def _h_set_events_recording(self, state, msg):
        """Cluster-wide runtime toggle of flight-recorder capture: flip
        this process (head + driver share the global recorder) and
        broadcast to every live worker and node daemon, and workers
        spawned later inherit the current state via their spawn env.
        No restart — the obs-smoke overhead test A/Bs with this so both
        windows run in ONE cluster under identical host conditions, and
        an operator can rule recording out while triaging a perf
        regression. Remote drivers are the one surface NOT reached:
        their submission-side recording stays driver-local
        (RAY_TPU_TORCH_events_enabled in the driver's own env)."""
        on = bool(msg.get("enabled", True))
        _events.get_recorder().enabled = on
        with self._lock:
            conns = [
                w.conn for w in self.workers.values() if w.conn is not None
            ]
            conns += [
                n.conn for n in self.nodes.values() if n.conn is not None
            ]
        for conn in conns:
            try:
                conn.send({"type": "set_events_recording", "enabled": on})
            except ConnectionLost:
                pass
        if "req_id" in msg:
            state["peer"].reply(msg, ok=True, enabled=on)

    def _h_events_summary(self, state, msg):
        """Derived flight-recorder metrics for the Prometheus scrape:
        per-phase latency histograms, drop counters, live queue depth."""
        self._drain_local_events()
        summary = self.events.summary()
        with self._lock:
            summary["queue_depth"] = len(self._pending)
            summary["queue_classes"] = len(self._pending.classes)
        state["peer"].reply(msg, ok=True, summary=summary)

    def _h_get_task_events(self, state, msg):
        # Timeline/summary reads the same batched deque as list_state:
        # same read-your-writes barrier.
        self._barrier_flush_events(state, msg)
        with self._lock:
            events = [
                {
                    "task_id": tid.hex(),
                    "name": name,
                    "event": event,
                    "timestamp": ts,
                    "worker_id": wid.hex() if wid else "",
                }
                for tid, name, event, ts, wid in self.task_events
            ]
        state["peer"].reply(msg, ok=True, events=events)

    # ------------------------------------------------------------- node admin

    def _h_register_node(self, state, msg):
        """A node daemon (raylet.py) joined over the network control
        plane (reference: GcsNodeManager::HandleRegisterNode)."""
        peer: PeerConn = state["peer"]
        peer.peer_role = "raylet"
        with self._lock:
            # Reconnecting daemons keep their node id (head restart —
            # reference: raylets re-register after NotifyGCSRestart).
            nid = msg.get("node_id")
            if nid and nid in self._fenced_node_ids:
                # Zombie: this node_id was declared dead by the sweeper.
                # It must NOT resurrect — the daemon self-fences (kills
                # leased workers, drops shm adverts) and rejoins with a
                # fresh node_id through the normal join path.
                self._record_fence(
                    "node", nid, "dead node_id re-registration"
                )
                peer.reply(msg, ok=False, fenced=True)
                return
            node = NodeState(
                node_id=NodeID(nid) if nid else NodeID.from_random(),
                total=dict(msg["resources"]),
                available=dict(msg["resources"]),
                label=msg.get("label", ""),
                conn=peer,
                transfer_addr=msg.get("transfer_addr", ""),
                last_heartbeat=time.monotonic(),
            )
            self._incarnation_seq += 1
            node.incarnation = self._incarnation_seq
            prev = self.nodes.get(node.node_id.binary()) if nid else None
            if prev is not None:
                # Workers of this node that reconnected BEFORE their
                # daemon (head failover) registered pool membership and
                # re-acquired actor/task resources on a zero-capacity
                # placeholder — carry both over, or the claimed work
                # becomes invisible/oversubscribed (the heartbeat sync
                # only adjusts local-lease deltas, never this).
                node.pool = prev.pool
                node.actor_hosts = prev.actor_hosts
                for k, v in prev.available.items():
                    if v < 0:  # acquired against the empty placeholder
                        node.available[k] = node.available.get(k, 0.0) + v
            self.nodes[node.node_id.binary()] = node
            if node.transfer_addr:
                # PULL_RELEAD attribution: a slow-pull re-lead names
                # the provider by transfer address; map it back to the
                # node so the scorer can charge the right machine.
                self._transfer_addr_nodes[node.transfer_addr] = (
                    node.node_id.binary()
                )
            self._daemon_conn_count += 1
            state["role"] = "raylet"
            state["node_id"] = node.node_id.binary()
            # Restored placement groups re-reserve as capacity returns.
            for pg in self.placement_groups.values():
                if pg.state == "PENDING" and self._try_reserve_pg(pg)[0]:
                    pg.state = "CREATED"
                    self._notify_pg_waiters(pg)
            self._work.notify_all()
        peer.reply(
            msg,
            ok=True,
            node_id=node.node_id.binary(),
            incarnation=node.incarnation,
            session_dir=self.session_dir,
        )
        self._publish(
            "NODE_INFO",
            node.node_id.hex(),
            {"state": "ALIVE", "label": node.label,
             "incarnation": node.incarnation,
             "resources": dict(node.total)},
        )

    def _record_fence(self, kind: str, entity: bytes, reason: str) -> None:
        """One NODE_FENCED flight-recorder event per rejection site
        (cheap: fencing is the exception path by construction)."""
        if _events.enabled():
            _events.record(
                _events.HEAD, f"{kind}-{entity.hex()[:12]}",
                "NODE_FENCED", {"kind": kind, "reason": reason},
            )

    def _fence_push(self, state, kind: str, entity: bytes,
                    reason: str) -> None:
        """Reject a stale-incarnation message: record the fence and tell
        the sender ONCE per connection (the zombie self-fences on
        receipt; repeating the push per dropped message would spam a
        healed link)."""
        self._record_fence(kind, entity, reason)
        if state.get("fence_sent"):
            return
        state["fence_sent"] = True
        try:
            state["peer"].send(
                {"type": "fenced", "kind": kind, "reason": reason}
            )
        except ConnectionLost:
            pass

    def _fence_dead_client(self, wid: bytes, reason: str) -> None:
        """Caller holds the lock: a message arrived from a client whose
        handle is W_DEAD (zombie past false death). Record the fence
        and push one ``fenced`` notice on its conn so it self-fences."""
        self._record_fence("worker", wid, reason)
        if wid in self._fence_pushed:
            return
        self._fence_pushed.add(wid)
        conn = self.client_conns.get(wid)
        if conn is not None:
            try:
                conn.send(
                    {"type": "fenced", "kind": "worker", "reason": reason}
                )
            except ConnectionLost:
                pass

    def _h_node_heartbeat(self, state, msg):
        self._ingest_peer_events(
            msg, source=f"node-{msg['node_id'].hex()[:12]}"
        )
        with self._lock:
            node = self.nodes.get(msg["node_id"])
            inc = msg.get("incarnation")
            stale = node is None or not node.alive or (
                inc is not None
                and node.incarnation
                and inc != node.incarnation
            )
        if stale:
            # Unknown, dead, or stale-incarnation node: a heartbeat
            # must not refresh liveness (a zombie would never be
            # declared dead) — fence the sender instead.
            self._fence_push(
                state, "node", msg["node_id"], "stale heartbeat"
            )
            return
        with self._lock:
            node = self.nodes.get(msg["node_id"])
            if node is not None:
                now_mono = time.monotonic()
                if node.prev_heartbeat:
                    # Health signal: worst inter-arrival gap since the
                    # last scoring sweep (jitter, not just absence —
                    # a throttled link stretches gaps long before the
                    # death sweeper's threshold).
                    gap = now_mono - node.prev_heartbeat
                    if gap > node.hb_gap_max:
                        node.hb_gap_max = gap
                node.prev_heartbeat = now_mono
                node.last_heartbeat = now_mono
                # Periodic resource-view sync (reference: ray_syncer.h
                # resource broadcasting): CPUs the daemon leased out
                # locally come off this node's schedulable view,
                # eventually-consistently.
                for field_name, res in (
                    ("local_cpus_in_use", "CPU"),
                    ("local_gpus_in_use", "GPU"),
                ):
                    local = msg.get(field_name)
                    if local is None:
                        continue
                    delta = local - getattr(node, field_name)
                    if delta:
                        setattr(node, field_name, local)
                        node.available[res] = (
                            node.available.get(res, 0.0) - delta
                        )
                        if delta < 0:
                            self._work.notify_all()

    # ----------------------------------------------------------- persistence

    # Message types that mutate durable state; _dispatch bumps the
    # version so the persist loop knows to re-snapshot.
    #: Durable tables; each persists to its own file under
    #: gcs_state.d/ and rewrites only when its version moves.
    _TABLES = (
        "kv", "functions", "named_actors", "actors", "pending",
        "orphans", "placement_groups", "objects",
    )
    #: Which tables each durable message type can touch; unmapped
    #: types conservatively dirty everything.
    _TABLES_OF_TYPE = {
        "kv_put": ("kv",),
        "kv_del": ("kv",),
        "register_function": ("functions",),
        "put_object": ("objects",),
        "free_objects": ("objects",),
        "stream_item": ("objects",),
        "create_placement_group": ("placement_groups",),
        "remove_placement_group": ("placement_groups",),
        "reserve_actor_name": ("named_actors", "actors"),
        # release/exit/kill fail queued tasks -> FAILED object entries
        # and popped orphans/pending ride along.
        "release_actor_name": (
            "named_actors", "actors", "objects", "orphans", "pending",
        ),
        "actor_exit": (
            "actors", "named_actors", "orphans", "objects", "pending",
        ),
        "kill_actor": (
            "actors", "named_actors", "orphans", "objects", "pending",
        ),
        # submit_task also extracts spec-embedded function blobs into
        # the functions table and can reserve actor names.
        "submit_task": (
            "pending", "actors", "objects", "orphans", "functions",
            "named_actors",
        ),
        # A failed actor-creation task_done also drops the actor's
        # name binding.
        "task_done": ("objects", "actors", "pending", "named_actors"),
        "task_done_batch": (
            "objects", "actors", "pending", "named_actors",
        ),
    }

    _DURABLE_TYPES = frozenset(
        (
            "kv_put", "kv_del", "register_function", "submit_task",
            "task_done", "task_done_batch", "stream_item", "put_object",
            "free_objects", "reserve_actor_name", "release_actor_name",
            "actor_exit", "kill_actor",
            # update_refs/ref_flush apply asynchronously on the shard
            # queues; the frees they cause bump the objects table
            # version inside _free_candidates instead.
            "create_placement_group", "remove_placement_group",
        )
    )

    def _snapshot_table(self, table: str) -> Any:
        """One durable table's persistable view. Caller holds the lock.

        Worker/node bindings are deliberately excluded: daemons
        re-register on reconnect, actors restart from their creation
        specs (state is lost across a head failover unless the actor
        checkpoints — same contract the reference documents for
        non-persistent actors)."""
        if table == "kv":
            return {ns: dict(d) for ns, d in self.kv.items()}
        if table == "functions":
            return dict(self.functions)
        if table == "named_actors":
            return dict(self.named_actors)
        if table == "actors":
            return {
                aid: {
                    "spec": a.spec,
                    "state": a.state,
                    "name": a.name,
                    "restarts_used": a.restarts_used,
                    "death_reason": a.death_reason,
                    "pending": list(a.pending),
                }
                for aid, a in self.actors.items()
            }
        if table == "pending":
            # Dispatched-but-unfinished specs persist alongside the
            # queue: a head crash must not lose in-flight tasks (they
            # park in the recovery window for their worker to re-claim;
            # unclaimed ones re-queue and re-execute — at-least-once,
            # like lineage reconstruction). Actor methods ride too;
            # creations are governed by the actors table.
            return {
                "queued": list(self._pending),
                "inflight": [
                    spec
                    for w in self.workers.values()
                    if w.state != W_DEAD
                    for spec in w.inflight.values()
                    if not spec.actor_creation
                ]
                + list(self._recover_inflight.values()),
            }
        if table == "orphans":
            return {
                aid: list(specs)
                for aid, specs in self._orphan_actor_tasks.items()
            }
        if table == "placement_groups":
            # Bundle reservations are node-bound and die with the old
            # head's node table; persist the PG definitions and restore
            # them PENDING so the reservation loop re-places them on
            # the re-registered nodes.
            return {
                pid: {
                    "bundles": [dict(b.resources) for b in pg.bundles],
                    "strategy": pg.strategy,
                    "state": pg.state,
                    "name": pg.name,
                }
                for pid, pg in self.placement_groups.items()
            }
        if table == "objects":
            return {
                oid: (e.status, e.inline, e.spilled_path, e.size, e.error)
                for oid, e in self.objects.items()
                if e.inline is not None
                or e.spilled_path is not None
                or e.status == FAILED
            }
        raise KeyError(table)

    def _snapshot_state(self) -> Dict[str, Any]:
        """All durable tables (tests/full snapshots); caller holds the
        lock."""
        return {t: self._snapshot_table(t) for t in self._TABLES}

    def _persist_loop(self):
        import pickle as _pickle

        while not self._shutdown:
            time.sleep(0.2)
            if self._version == self._persisted_version:
                continue
            with self._lock:
                version = self._version
                dirty = {
                    t: v
                    for t, v in self._table_versions.items()
                    if v != self._persisted_table_versions[t]
                }
                snaps = {t: self._snapshot_table(t) for t in dirty}
            try:
                os.makedirs(self._state_dir, exist_ok=True)
                # Versioned table files first, manifest swap LAST: a
                # crash anywhere leaves the previous manifest pointing
                # at a complete, mutually-consistent file set (one
                # mutation's multi-table dirt lands in one manifest).
                for t, payload in snaps.items():
                    name = f"{t}.{dirty[t]}.pkl"
                    tmp = os.path.join(self._state_dir, name + ".tmp")
                    with open(tmp, "wb") as f:
                        f.write(_pickle.dumps(payload))
                    os.replace(tmp, os.path.join(self._state_dir, name))
                    self._manifest[t] = name
                # Chaos: crash-consistency point — new table files are
                # on disk but the manifest still names the previous
                # generation. A kill here must leave a restart loading
                # the last COMPLETE cut (the .tmp + rename ordering is
                # what this kill point exists to prove).
                if snaps:
                    _chaos.kill_point("gcs.mid_persist")
                mtmp = os.path.join(self._state_dir, "manifest.pkl.tmp")
                with open(mtmp, "wb") as f:
                    f.write(_pickle.dumps(dict(self._manifest)))
                os.replace(
                    mtmp, os.path.join(self._state_dir, "manifest.pkl")
                )
                for t, v in dirty.items():
                    self._persisted_table_versions[t] = v
                self._persisted_version = version
                # GC superseded table files.
                live = set(self._manifest.values()) | {"manifest.pkl"}
                for f in os.listdir(self._state_dir):
                    if f not in live and not f.endswith(".tmp"):
                        try:
                            os.unlink(os.path.join(self._state_dir, f))
                        except OSError:
                            pass
            except FileNotFoundError:
                return  # session dir removed: shutting down
            except Exception as e:  # noqa: BLE001
                sys.stderr.write(f"gcs: persist failed: {e}\n")

    def _restore_state(self):
        """Head restart: reload durable tables. Every restored actor
        lost its worker with the old head — re-queue its creation spec
        so the scheduler recreates it (and then flushes its buffered
        method calls) once nodes re-register."""
        import pickle as _pickle

        manifest_path = os.path.join(self._state_dir, "manifest.pkl")
        restored_legacy = False
        if os.path.exists(manifest_path):
            with open(manifest_path, "rb") as f:
                manifest = _pickle.load(f)
            snap = {}
            for t in self._TABLES:
                name = manifest.get(t)
                if name is None:
                    snap[t] = [] if t == "pending" else {}
                    continue
                with open(
                    os.path.join(self._state_dir, name), "rb"
                ) as f:
                    snap[t] = _pickle.load(f)
        elif os.path.exists(self._state_path):
            # Legacy single-file snapshot from an older head (or a
            # crash before the first manifest landed).
            with open(self._state_path, "rb") as f:
                snap = _pickle.load(f)
            restored_legacy = True
        else:
            raise FileNotFoundError(self._state_dir)
        self.kv = snap["kv"]
        self.functions = snap["functions"]
        self.named_actors = snap["named_actors"]
        for oid, (status, inline, spilled, size, error) in snap[
            "objects"
        ].items():
            e = ObjectEntry()
            e.status = status
            e.inline = inline
            e.spilled_path = spilled
            e.size = size
            e.error = error
            if spilled is not None:
                # Spill files live with this head; remote clients need
                # the node binding to route through the transfer plane.
                e.node_id = self.head_node.node_id
            self.objects[oid] = e
            # Awaiting an owner's reconcile re-claim; swept (freed)
            # at recovery-window close if nobody claims it.
            self._restored_unclaimed.add(oid)
        pend = snap["pending"]
        if isinstance(pend, dict):
            queued, inflight = pend["queued"], pend["inflight"]
        else:  # legacy list-only snapshot
            queued, inflight = pend, []
        # Creations of actors recorded PENDING are held for the recovery
        # window (see the actors loop below), not queued.
        held = {aid for aid, rec in snap["actors"].items() if rec["state"] == A_PENDING}
        for spec in queued:
            if spec.actor_creation and spec.actor_id is not None \
                    and spec.actor_id.binary() in held:
                continue
            self._pending.append(spec)
        for spec in inflight:
            if spec.actor_creation:
                continue  # the actors table governs creations
            # Parked for the recovery window: a surviving worker
            # re-claims it (hello reconnect "executing"), else it
            # re-queues at window close and re-executes.
            self._recover_inflight[spec.task_id.binary()] = spec
        for aid, specs in snap["orphans"].items():
            self._orphan_actor_tasks[aid] = list(specs)
        for pid, rec in snap.get("placement_groups", {}).items():
            if rec["state"] == "REMOVED":
                continue
            self.placement_groups[pid] = PlacementGroupState(
                pg_id=PlacementGroupID(pid),
                bundles=[
                    BundleState(resources=dict(b), available=dict(b))
                    for b in rec["bundles"]
                ],
                strategy=rec["strategy"],
                state="PENDING",  # re-reserved as nodes re-register
                name=rec["name"],
            )
        for aid, rec in snap["actors"].items():
            actor = ActorState(
                actor_id=ActorID(aid),
                spec=rec["spec"],
                name=rec["name"],
                restarts_used=rec["restarts_used"],
            )
            spec: TaskSpec = rec["spec"]
            was_scheduled = rec["state"] not in (A_PENDING,)
            if rec["state"] == A_DEAD:
                actor.state = A_DEAD
                actor.death_reason = rec["death_reason"]
            elif was_scheduled:
                # Live failover: the hosting worker may have OUTLIVED
                # the head and will re-claim this actor during the
                # recovery grace window (hello reconnect) — state
                # intact, no restart consumed. Only at window close
                # does an unclaimed actor restart from its creation
                # spec (or die when its budget is spent);
                # _finish_recovery applies the same at-most-once limit
                # _handle_worker_death enforces.
                actor.state = A_RESTARTING
                for m in rec["pending"]:
                    actor.pending.append(m)
                if not self._creation_queued(aid):
                    self._recover_actors.add(aid)
                # else: the OLD head had already re-queued this actor's
                # creation (its worker died pre-crash) and the queued
                # spec was restored with the pending table — recreating
                # via that spec is the only correct path (no live
                # worker can claim it, and offering a claim AND keeping
                # the queued spec would create the actor twice).
            else:
                # The old head may have dispatched this creation and
                # seen it finish after its last persist tick: the worker
                # that hosts the actor then outlives the head and
                # re-claims it in the recovery window (hello reconnect),
                # as for a scheduled actor. Queuing the creation now
                # would make a second instance and the claim would be
                # refused, dropping the first: the worker keeps
                # answering that the actor is gone. So the creation waits
                # for the window; unclaimed, it is queued at its close
                # (`_finish_recovery`) without consuming a restart.
                actor.state = A_PENDING
                for m in rec["pending"]:
                    actor.pending.append(m)
                self._recover_actors.add(aid)
                self._recover_pending.add(aid)
            self.actors[aid] = actor
        sys.stderr.write(
            f"gcs: restored state — {len(self.actors)} actors, "
            f"{len(self._pending)} pending tasks, "
            f"{sum(len(d) for d in self.kv.values())} kv keys\n"
        )
        return restored_legacy

    # ------------------------------------------------------------ log pipeline

    def _ingest_logs(self, node_label: str, entries) -> None:
        """entries: [(worker_tag, line)] from a node's LogMonitor."""
        tagged = [(node_label, w, line) for w, line in entries]
        with self._lock:
            # Dedup state is shared across the head monitor thread and
            # raylet log_batch handler threads.
            emit = self._log_dedup.filter(tagged)
            if not emit:
                return
            self.log_buffer.extend(emit)
            subs = list(self._log_subscribers)
        self._push_log_lines(emit, subs)

    def _push_log_lines(self, emit, subs) -> None:
        msg = {"type": "log_lines", "entries": emit}
        for peer in subs:
            try:
                peer.send(msg)
            except ConnectionLost:
                with self._lock:
                    if peer in self._log_subscribers:
                        self._log_subscribers.remove(peer)

    def _flush_log_repeats(self) -> None:
        """Periodic (health loop): emit '[repeated Nx]' summaries for
        lines suppressed inside the dedup window."""
        with self._lock:
            emit = self._log_dedup.flush_repeats()
            if not emit:
                return
            self.log_buffer.extend(emit)
            subs = list(self._log_subscribers)
        self._push_log_lines(emit, subs)

    def _h_log_batch(self, state, msg):
        # A raylet's monitor shipping its node's worker lines.
        self._ingest_logs(msg.get("node", "?"), msg["entries"])

    def _h_subscribe_logs(self, state, msg):
        with self._lock:
            self._log_subscribers.append(state["peer"])
        state["peer"].reply(msg, ok=True)

    # ------------------------------------------------------------- pubsub
    def _h_pubsub_subscribe(self, state, msg):
        # Per-peer registration is channel-granular; key filtering is
        # client-side (one process may hold several subscriptions with
        # different prefixes on the same channel).
        with self._lock:
            subs = self._pubsub.setdefault(msg["channel"], [])
            if state["peer"] not in subs:
                subs.append(state["peer"])
        state["peer"].reply(msg, ok=True)

    def _h_pubsub_unsubscribe(self, state, msg):
        with self._lock:
            subs = self._pubsub.get(msg["channel"], [])
            self._pubsub[msg["channel"]] = [
                p for p in subs if p is not state["peer"]
            ]
        state["peer"].reply(msg, ok=True)

    def _h_pubsub_publish(self, state, msg):
        self._publish(msg["channel"], msg.get("key", ""), msg.get("data"))
        state["peer"].reply(msg, ok=True)

    def _publish(self, channel: str, key: str, data) -> None:
        """Enqueue a fan-out; delivery happens on a dedicated publisher
        thread so a wedged subscriber socket can never stall a handler
        holding the GCS lock (reference: publisher.h per-subscriber
        delivery with connection GC)."""
        with self._lock:
            if not self._pubsub.get(channel):
                return
        self._pub_queue.put((channel, key, data))
        if self._pub_thread is None:
            self._pub_thread = threading.Thread(
                target=self._publish_loop, name="gcs-pubsub", daemon=True
            )
            self._pub_thread.start()

    def _publish_loop(self) -> None:
        while True:
            item = self._pub_queue.get()
            if item is None:
                return
            channel, key, data = item
            with self._lock:
                subs = list(self._pubsub.get(channel, ()))
            if not subs:
                continue
            dead = []
            out = {
                "type": "pubsub", "channel": channel, "key": key,
                "data": data,
            }
            for peer in subs:
                try:
                    peer.send(out)
                except ConnectionLost:
                    dead.append(peer)
            if dead:
                with self._lock:
                    self._pubsub[channel] = [
                        p
                        for p in self._pubsub.get(channel, ())
                        if p not in dead
                    ]

    def _h_worker_stacks(self, state, msg):
        """Live thread-stack capture from a worker (reference: the
        dashboard's py-spy profiling, reporter/profile_manager.py —
        here via sys._current_frames inside the worker, no ptrace)."""
        wid = msg["worker_id"]
        with self._lock:
            w = self.workers.get(wid)
            conn = w.conn if w is not None else None
            if conn is None:
                state["peer"].reply(
                    msg, ok=False, error="no such worker (or not connected)"
                )
                return
            token = f"{wid.hex()[:8]}-{time.time():.6f}"
            self._stack_waiters[token] = (state["peer"], msg, time.time())
        try:
            conn.send({"type": "dump_stacks", "token": token})
        except ConnectionLost:
            with self._lock:
                self._stack_waiters.pop(token, None)
            state["peer"].reply(msg, ok=False, error="worker connection lost")

    def _h_worker_profile(self, state, msg):
        """Sampling profile from a worker: folded flamegraph stacks
        over `duration` seconds (reference: reporter/profile_manager.py
        py-spy capture; statistical, not a single snapshot)."""
        wid = msg["worker_id"]
        try:
            duration = float(msg.get("duration", 5.0))
        except (TypeError, ValueError):
            duration = 5.0
        if not (duration == duration):  # NaN would un-expire the waiter
            duration = 5.0
        duration = min(max(duration, 0.1), 60.0)
        with self._lock:
            w = self.workers.get(wid)
            conn = w.conn if w is not None else None
            if conn is None:
                state["peer"].reply(
                    msg, ok=False, error="no such worker (or not connected)"
                )
                return
            token = f"p-{wid.hex()[:8]}-{time.time():.6f}"
            # Waiter expiry must outlive the sampling window.
            self._stack_waiters[token] = (
                state["peer"], msg, time.time() + duration,
            )
        try:
            conn.send(
                {
                    "type": "profile_stacks",
                    "token": token,
                    "duration": duration,
                    "interval": float(msg.get("interval", 0.01)),
                }
            )
        except ConnectionLost:
            with self._lock:
                self._stack_waiters.pop(token, None)
            state["peer"].reply(msg, ok=False, error="worker connection lost")

    def _h_stack_dump(self, state, msg):
        with self._lock:
            waiter = self._stack_waiters.pop(msg.get("token"), None)
        if waiter is None:
            return
        peer, orig, _ = waiter
        try:
            peer.reply(
                orig, ok=True, text=msg.get("text", ""),
                samples=msg.get("samples"),
            )
        except ConnectionLost:
            pass

    def _sweep_stack_waiters(self, now: float) -> None:
        with self._lock:
            expired = [
                t
                for t, (_, _, ts) in self._stack_waiters.items()
                if now - ts > 10.0
            ]
            waiters = [self._stack_waiters.pop(t) for t in expired]
        for peer, orig, _ in waiters:
            try:
                peer.reply(orig, ok=False, error="stack dump timed out")
            except ConnectionLost:
                pass

    def _h_get_logs(self, state, msg):
        prefix = msg.get("worker_prefix") or ""
        n = msg.get("tail", 1000)
        with self._lock:
            lines = [
                e for e in self.log_buffer if e[1].startswith(prefix)
            ][-n:]
        state["peer"].reply(msg, ok=True, lines=lines)

    # ------------------------------------------------ memory-pressure ladder

    def _spill_loop(self):
        """Evict→spill rung: at high pool utilization, write the coldest
        sealed, unpinned head-node objects to disk and free their pool
        space; gets fall back to the spill file (same node) or restore
        through the transfer plane (cross-node)."""
        pool = getattr(self._store, "_pool", None)
        if pool is None:
            return  # segment-fallback store: no bounded arena to manage
        while not self._shutdown:
            time.sleep(0.2)
            try:
                self._spill_pass()
            except Exception:  # noqa: BLE001 - store closed (shutdown)
                return

    def _spill_pass(self) -> int:
        """One spill tick: returns bytes freed from the pool. Split out
        of the monitor loop so tests (and the `spill_tick` control
        message) can drive spilling deterministically instead of
        sleep-polling the 0.2s monitor cadence. Serialized: concurrent
        passes would select the same LRU candidates and race their
        writes."""
        pool = getattr(self._store, "_pool", None)
        if pool is None or self._shutdown:
            return 0
        with self._spill_pass_lock:
            return self._spill_pass_locked(pool)

    def _spill_pass_locked(self, pool) -> int:
        if time.monotonic() < self._spill_blocked_until:
            return 0  # disk trouble: parked, objects stay resident
        st = pool.stats()
        cap = st.get("pool_size") or st.get("arena_size") or 0
        if not cap:
            return 0
        frac = st["bytes_in_use"] / cap
        threshold = RayConfig.object_spilling_threshold
        if frac < threshold:
            return 0
        target = max(0.0, threshold - 0.1)
        to_free = int((frac - target) * cap)
        with self._lock:
            head = self.head_node.node_id
            candidates = sorted(
                (
                    (e.last_access, oid, e)
                    for oid, e in self.objects.items()
                    if e.status == READY
                    and e.segment == "pool"
                    and e.spilled_path is None
                    and e.task_pins == 0
                    and e.node_id == head
                ),
                key=lambda t: t[0],
            )
        freed = 0
        for _, oid, entry in candidates:
            if freed >= to_free:
                break
            freed += self._spill_one(oid, entry)
            if time.monotonic() < self._spill_blocked_until:
                # A write just failed through its whole retry budget:
                # stop the pass NOW — retrying the remaining candidates
                # against the same sick disk would turn one park into
                # candidates × retry-budget of stall.
                break
        return freed

    def _h_spill_tick(self, state, msg):
        """Run one synchronous spill pass (testing/ops hook): makes
        spill-dependent tests deterministic — trigger, don't poll.
        Deliberately ON the dispatch thread (unlike spill_corrupt
        validation): the tests need the pass complete when the reply
        lands, and callers are test harnesses, not production cadence —
        the stall is the caller's to own."""
        freed = self._spill_pass()
        state["peer"].reply(msg, ok=True, freed=freed)

    def _spill_one(self, oid: bytes, entry: ObjectEntry) -> int:
        """Write one sealed object to the spill dir, then free its pool
        copy. Ordering matters: the file + directory update land before
        the delete so a concurrent directory lookup always finds one
        valid copy (a get reply already in flight falls back to a
        re-request on store miss — client._materialize).

        The write itself is crash-atomic with a validated header
        (object_store.write_spill_file); transient IO errors and
        disk-full retry on the shared backoff policy, and a write that
        still fails DEGRADES — the object stays resident, the spiller
        parks briefly, and puts feel backpressure — instead of crashing
        the daemon or silently dropping the copy."""
        from .object_store import write_spill_file

        raw = self._store.get_raw(ObjectID(oid))
        if raw is None:
            return 0
        try:
            path = _chaos.retry_call(
                lambda: write_spill_file(self.spill_dir, ObjectID(oid), raw),
                retry_on=(OSError,),
                backoff=_chaos.Backoff(
                    base_s=0.02, cap_s=0.25, budget_s=1.0
                ),
            )
            n = len(raw)
        except OSError as e:
            if _events.enabled():
                _events.record(
                    _events.REFS, ObjectID(oid).hex()[:12], "SPILL_FAIL",
                    {"error": f"{type(e).__name__}: {e}",
                     "errno": getattr(e, "errno", None)},
                )
            self._spill_blocked_until = time.monotonic() + 2.0
            return 0
        finally:
            self._store.release_raw(ObjectID(oid))
        with self._lock:
            if self.objects.get(oid) is not entry:
                # Freed while we were writing: nothing will ever unlink
                # the file through the directory — do it ourselves.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return 0
            entry.spilled_path = path
            entry.segment = None
            self._version += 1  # spilled location is durable state
            self._table_versions["objects"] += 1
            if _events.enabled():
                # Spill is an ownership-edge transition: surfaced so
                # the timeline can attribute spill-backed get stalls.
                _events.record(
                    _events.OBJECT, ObjectID(oid).hex(), "SPILLED",
                    {"size": n},
                )
        self._store.delete(ObjectID(oid))
        return n

    def _h_spill_corrupt(self, state, msg):
        """A reader found a spill file that fails header/checksum
        validation. Re-validate (the report may be stale — the entry
        may have re-sealed since), then drop the bad file and answer
        LOST when it was the only copy, so gets resolve into lineage
        reconstruction instead of re-reading garbage forever. The
        checksum pass streams the whole file, so it runs on its own
        short-lived thread — never on the dispatch loop."""
        oid = msg["object_id"]
        with self._lock:
            entry = self.objects.get(oid)
            path = entry.spilled_path if entry is not None else None
        if path is None:
            return
        threading.Thread(
            target=self._validate_spill_report, args=(oid, path),
            name="gcs-spill-validate", daemon=True,
        ).start()

    def _validate_spill_report(self, oid: bytes, path: str) -> None:
        from .object_store import SpillCorruptionError, verify_spill_file

        try:
            verify_spill_file(path)
            return  # validates fine now: stale/racy report
        except (OSError, SpillCorruptionError):
            pass
        # The entry stops naming the file before the file goes, so a
        # reader that finds the path finds the file too (the reference
        # unlinks first, and a reader can see a path with no file). The
        # file is moved to a name of its own under the lock and unlinked
        # there after it: a spill of the object reconstructed meanwhile
        # writes the same path, and that new file stays.
        tombstone = f"{path}.corrupt-{uuid.uuid4().hex}"
        with self._lock:
            entry = self.objects.get(oid)
            if entry is None or entry.spilled_path != path:
                return
            entry.spilled_path = None
            if entry.segment is None and entry.inline is None:
                entry.status = LOST
                self._notify_object(entry)
            self._version += 1
            self._table_versions["objects"] += 1
            try:
                os.rename(path, tombstone)
            except OSError:
                tombstone = None
        if tombstone is not None:
            try:
                os.unlink(tombstone)
            except OSError:
                pass
        if _events.enabled():
            _events.record(
                _events.REFS, ObjectID(oid).hex()[:12], "SPILL_FAIL",
                {"error": "corrupt spill file dropped", "lost": True},
            )

    def _memory_usage_fraction(self) -> Optional[float]:
        test_file = RayConfig.testing_memory_usage_file
        if test_file:
            try:
                with open(test_file) as f:
                    return float(f.read().strip())
            except (OSError, ValueError):
                return None
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, rest = line.partition(":")
                    info[k] = int(rest.split()[0])
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", 0)
            if not total:
                return None
            return 1.0 - avail / total
        except OSError:
            return None

    def _memory_loop(self):
        """OOM rung: above the usage threshold, kill one task-running
        worker per tick — newest retriable task first (it resubmits),
        then newest non-retriable (fails with OutOfMemoryError)."""
        while not self._shutdown:
            time.sleep(RayConfig.memory_monitor_refresh_ms / 1000.0)
            frac = self._memory_usage_fraction()
            if frac is None or frac < RayConfig.memory_usage_threshold:
                continue
            with self._lock:
                victims = [
                    w
                    for w in self.workers.values()
                    if w.proc is not None
                    and (
                        (
                            w.state == W_BUSY
                            and w.current_task is not None
                            and not w.current_task.actor_creation
                        )
                        # Leased (direct-transport) workers run tasks the
                        # GCS can't see; their clients decide retry on
                        # the conn-loss they observe.
                        or w.state == W_LEASED
                    )
                ]
                if not victims:
                    continue
                victim = sort_oom_victims(victims)[0]
                name = (
                    victim.current_task.name
                    if victim.current_task is not None
                    else "<leased>"
                )
                # Under the lock so the racing conn-close handler
                # reports OOM, not a generic crash.
                victim.death_reason_hint = (
                    f"out-of-memory: host usage {frac:.2f}"
                )
                try:
                    victim.proc.kill()
                except Exception:  # noqa: BLE001
                    pass
            sys.stderr.write(
                f"gcs: memory pressure {frac:.2f} >= "
                f"{RayConfig.memory_usage_threshold}: killed worker running "
                f"'{name}'\n"
            )
            self._handle_worker_death(
                victim.worker_id.binary(),
                f"out-of-memory: host usage {frac:.2f}",
            )

    def _health_loop(self):
        """Declare daemon nodes dead when their heartbeats stop, even if
        the TCP connection stays established (partition, SIGSTOP, hang)
        (reference: GcsHealthCheckManager, gcs_health_check_manager.h:39)."""
        period = RayConfig.health_check_period_ms / 1000.0
        threshold = RayConfig.health_check_failure_threshold
        while not self._shutdown:
            time.sleep(period)
            self._flush_log_repeats()
            now = time.time()
            self._drain_tick(now)
            self._sweep_stack_waiters(now)
            # Reap workers that died between fork and registration
            # (crash during bootstrap): a stuck W_STARTING entry would
            # block pool-growth accounting forever.
            with self._lock:
                stuck = [
                    w.worker_id.binary()
                    for w in self.workers.values()
                    if w.state == W_STARTING
                    and (
                        (w.proc is not None and w.proc.poll() is not None)
                        # Register-timeout deadline for EVERY starting
                        # worker: remote spawns (proc=None, raylet gone
                        # or message lost) and local pipelined forks a
                        # wedged-but-alive zygote never resolves (their
                        # poll() stays None forever) — either would hold
                        # a startup-cap slot indefinitely.
                        or now - w.spawned_at
                        > RayConfig.worker_register_timeout_s
                    )
                ]
            for wid in stuck:
                self._handle_worker_death(wid, "died during startup")
            with self._lock:
                stale = stale_node_ids(
                    self.nodes.values(), time.monotonic(),
                    period, threshold,
                )
            for nid in stale:
                self._handle_node_death(
                    nid, "node heartbeat timed out (unreachable or hung)"
                )
            if (
                self._recovering_until
                and time.monotonic() >= self._recovering_until
            ):
                self._finish_recovery()
            self._drain_ghosts()
            self._drain_promoted_graves()
            # Gray-failure layer: score every live node from the
            # sweep's signals, move the quarantine state machine, and
            # launch hedges for tasks overrunning on suspect nodes.
            try:
                self._score_nodes(period)
                self._launch_hedges()
            except Exception:  # noqa: BLE001 - scorer must never
                # take down the liveness sweep it rides on (counted,
                # never silent).
                self._scorer_errors += 1

    def _score_nodes(self, period: float) -> None:
        """Gray-failure scorer: fold the sweep's signals (heartbeat
        inter-arrival jitter, lease-grant→ack transit, pull re-leads,
        exec overruns) into each daemon node's health EWMA and move
        the suspect/quarantine/readmit state machine. Quarantine is
        probation, NOT the fence path: the node keeps heartbeating,
        keeps its workers, and readmits after sustained health — only
        true silence still reaches _handle_node_death."""
        alpha = RayConfig.health_score_alpha
        jitter_s = RayConfig.health_hb_jitter_factor * period
        grant_cap = RayConfig.health_grant_lat_s
        readmit_windows = RayConfig.health_readmit_windows
        now_mono = time.monotonic()
        with self._lock:
            for node in self.nodes.values():
                if not node.alive or node.conn is None:
                    # The head's own node and virtual/driver nodes have
                    # no heartbeat stream to score.
                    continue
                bad = 0
                if node.hb_gap_max > jitter_s or (
                    node.prev_heartbeat
                    and now_mono - node.last_heartbeat > jitter_s
                ):
                    bad += 1
                if node.grant_lat_max > grant_cap:
                    bad += 1
                if node.releads > 0:
                    bad += 1
                if node.overruns > 0:
                    bad += 1
                node.hb_gap_max = 0.0
                node.grant_lat_max = 0.0
                node.releads = 0
                node.overruns = 0
                sample = max(0.0, 1.0 - 0.5 * bad)
                prev = node.health_score
                score = (1.0 - alpha) * prev + alpha * sample
                node.health_score = score
                ent = node.node_id.hex()[:12]
                if _events.enabled() and round(score, 2) != round(prev, 2):
                    _events.record(
                        _events.HEAD, ent, "HEALTH_SCORE",
                        {"score": round(score, 3), "bad_signals": bad},
                    )
                was_suspect = node.suspect
                node.suspect = score < RayConfig.health_suspect_score
                if node.suspect and not was_suspect and _events.enabled():
                    _events.record(
                        _events.HEAD, ent, "NODE_SUSPECT",
                        {"score": round(score, 3)},
                    )
                if (
                    not node.quarantined
                    and score < RayConfig.health_quarantine_score
                ):
                    # The EWMA alone is the hysteresis: one bad sweep
                    # moves a healthy node to ~(1-alpha/2), nowhere
                    # near this threshold — only sustained degradation
                    # decays far enough.
                    node.quarantined = True
                    node.quarantined_at = time.time()
                    node.healthy_windows = 0
                    self._quarantine_stats["quarantined"] += 1
                    if _events.enabled():
                        _events.record(
                            _events.HEAD, ent, "NODE_QUARANTINE",
                            {"score": round(score, 3)},
                        )
                elif node.quarantined:
                    if score >= RayConfig.health_readmit_score:
                        node.healthy_windows += 1
                        if node.healthy_windows >= readmit_windows:
                            node.quarantined = False
                            node.suspect = False
                            node.healthy_windows = 0
                            self._quarantine_stats["readmitted"] += 1
                            if _events.enabled():
                                _events.record(
                                    _events.HEAD, ent, "NODE_READMIT",
                                    {"score": round(score, 3)},
                                )
                            # Capacity returned: wake the scheduler.
                            self._work.notify_all()
                    else:
                        # Readmission needs CONSECUTIVE healthy windows.
                        node.healthy_windows = 0
        self._update_straggler_metrics()

    def _update_straggler_metrics(self) -> None:
        """Prometheus surface for the straggler layer; built lazily,
        disabled forever on the first failure (mirrors PullManager's
        gauge pattern)."""
        if self._straggler_gauges is False:
            return
        try:
            if self._straggler_gauges is None:
                from ..util.metrics import Counter, Gauge

                self._straggler_gauges = {
                    "score": Gauge(
                        "ray_tpu_torch_node_health_score",
                        "Per-node gray-failure health score (1 = healthy)",
                        tag_keys=("node_id",),
                    ),
                    "quarantined": Gauge(
                        "ray_tpu_torch_nodes_quarantined",
                        "Nodes currently quarantined by the health scorer",
                    ),
                    "hedges": Counter(
                        "ray_tpu_torch_hedges_total",
                        "Hedged (speculative) task executions by outcome",
                        tag_keys=("outcome",),
                    ),
                    "transitions": Counter(
                        "ray_tpu_torch_quarantine_transitions_total",
                        "Quarantine state transitions",
                        tag_keys=("transition",),
                    ),
                    "_last": {},
                }
            g = self._straggler_gauges
            last = g["_last"]
            with self._lock:
                rows = [
                    (n.node_id.hex(), n.health_score, n.quarantined)
                    for n in self.nodes.values()
                    if n.alive and n.conn is not None
                ]
                counters = dict(self._hedge_stats)
                counters.update(self._quarantine_stats)
            nq = 0
            for nid_hex, score, quarantined in rows:
                g["score"].set(score, {"node_id": nid_hex[:12]})
                nq += 1 if quarantined else 0
            g["quarantined"].set(nq)
            for key, metric, tag_key in (
                ("launched", "hedges", "outcome"),
                ("won", "hedges", "outcome"),
                ("cancelled", "hedges", "outcome"),
                ("quarantined", "transitions", "transition"),
                ("readmitted", "transitions", "transition"),
            ):
                delta = counters[key] - last.get(key, 0)
                if delta > 0:
                    g[metric].inc(delta, {tag_key: key})
                    last[key] = counters[key]
        except Exception:  # noqa: BLE001 - metrics must never take
            # down the health sweep (counted, never silent).
            self._scorer_errors += 1
            self._straggler_gauges = False

    def _launch_hedges(self) -> None:
        """Speculative execution: a GCS-routed plain task that has been
        running on a suspect/quarantined node for longer than
        hedge_overrun_factor x its name's recorded p99 gets a duplicate
        lease on a healthy node. First task_done wins (hedge_seq
        fencing in _apply_task_done); the loser is cancelled and its
        results never seal. Actor tasks are never hedged from here —
        duplicating actor-state mutations is exactly what the epoch
        fence exists to prevent."""
        k = RayConfig.hedge_overrun_factor
        if not k:
            return
        min_samples = RayConfig.hedge_min_samples
        now = time.time()
        with self._lock:
            budget = RayConfig.hedge_max_inflight - len(self._hedges)
            for w in list(self.workers.values()):
                if w.state != W_BUSY or w.current_task is None:
                    continue
                spec = w.current_task
                if (
                    spec.actor_id is not None
                    or spec.actor_creation
                    or spec.num_returns == -1  # streaming: items already
                    # consumed can't be un-yielded by a losing twin
                    or spec.placement_group_id is not None
                    or spec.scheduling_strategy is not None
                ):
                    continue
                node = self.nodes.get(w.node_id.binary())
                if node is None:
                    continue
                tid = spec.task_id.binary()
                dq = self._exec_durations.get(spec.name)
                if dq is None or len(dq) < min_samples:
                    continue
                ordered = sorted(dq)
                p99 = ordered[
                    min(len(ordered) - 1, int(len(ordered) * 0.99))
                ]
                if now - w.task_started_at <= k * p99:
                    continue
                # The overrun is a scorer SIGNAL on any node (this is
                # how slow execution alone makes a node suspect); the
                # duplicate lease is dispatched only once the node has
                # already decayed to suspect/quarantined — one genuine
                # long task on a healthy node never hedges.
                node.overruns += 1
                if (
                    budget <= 0
                    or tid in self._hedges
                    or not (node.suspect or node.quarantined)
                ):
                    continue
                if self._dispatch_hedge(spec, w, node, now):
                    budget -= 1

    def _dispatch_hedge(self, spec, primary, primary_node,
                        now: float) -> bool:
        """Grant the duplicate lease on a healthy node with a warm idle
        worker (hedges never spawn processes — a speculative copy is
        not worth a cold interpreter boot). Caller holds self._lock."""
        res = self._task_resources(spec)
        candidates = [
            n
            for n in self.nodes.values()
            if n.alive and n.schedulable and not n.quarantined
            and not n.suspect
            and n.node_id.binary() != primary_node.node_id.binary()
            and _fits(n.available, res)
        ]
        tid = spec.task_id.binary()
        for node in sorted(
            candidates, key=lambda n: self._node_util(n, res)
        ):
            worker = self._pick_worker(node, spec)
            if worker is None:
                continue
            _acquire(node.available, res)
            worker.state = W_BUSY
            worker.current_task = spec
            worker.task_started_at = now
            worker.inflight[tid] = spec
            try:
                worker.conn.send(
                    {
                        "type": "execute_task", "spec": spec,
                        "hedge_seq": 1, "t_grant": time.time(),
                    }
                )
            except ConnectionLost:
                self._release_task_resources(spec, node.node_id)
                worker.inflight.pop(tid, None)
                worker.current_task = None
                worker.state = W_IDLE
                continue
            self._hedges[tid] = {
                # The primary's dispatch predates the hedge, so its
                # done carries no hedge_seq (expected: None); the twin
                # echoes 1. Anything else is a stale echo and fences.
                "seqs": {primary.worker_id.binary(): None,
                         worker.worker_id.binary(): 1},
                "winner": None,
                "pending": {primary.worker_id.binary(),
                            worker.worker_id.binary()},
            }
            self._hedge_stats["launched"] += 1
            if _events.enabled():
                _events.record(
                    _events.HEAD, tid.hex()[:12], "HEDGE_LAUNCH",
                    {
                        "name": spec.name,
                        "from": primary_node.node_id.hex()[:12],
                        "to": node.node_id.hex()[:12],
                    },
                )
            return True
        return False

    def _note_ghost(self, oid: bytes) -> None:
        """Caller holds the lock: watch an entry created by a question
        (get/wait on an unknown id) — see _ghost_watch. Armed only in
        sessions that restored from a snapshot."""
        if self._restored_session:
            self._ghost_watch.append(
                (time.monotonic() + RayConfig.pending_ghost_grace_s, oid)
            )

    def _expected_return_oids(self) -> Set[bytes]:
        """Return oids some known producer will still seal: queued,
        dispatched (inflight), recovery-parked, and actor-buffered
        specs. Caller holds the lock. PENDING entries outside this set
        will never seal."""
        expected: Set[bytes] = set()

        def _expect(s: TaskSpec) -> None:
            for o in s.return_object_ids():
                expected.add(o.binary())

        for spec in self._pending:
            _expect(spec)
        for spec in self._recover_inflight.values():
            _expect(spec)
        for w in self.workers.values():
            for s in w.inflight.values():
                _expect(s)
        for a in self.actors.values():
            for s in a.pending:
                _expect(s)
        expected |= self._reconcile_expected
        return expected

    def _drain_ghosts(self) -> None:
        """Ghost expiry: a PENDING entry whose producing task is not in
        any queue a full grace after a get/wait conjured it (or an
        owner re-claimed it without a local copy) will never seal — the
        submit died with a previous head. Answer LOST so parked gets
        resolve into lineage reconstruction. Ownership alone is NOT
        protection: a reconnecting owner's reconcile claims its return
        refs whether or not their producer survived."""
        mono = time.monotonic()
        due: List[bytes] = []
        while self._ghost_watch and self._ghost_watch[0][0] <= mono:
            due.append(self._ghost_watch.popleft()[1])
        if not due:
            return
        freed: List[bytes] = []
        lost = 0
        with self._lock:
            expected = None
            for oid in due:
                entry = self.objects.get(oid)
                if (
                    entry is None
                    or entry.status != PENDING
                    or entry.task_pins > 0
                    or entry.child_pins > 0
                ):
                    continue
                if expected is None:
                    # Lazily: due ghosts are rare (failover aftermath).
                    expected = self._expected_return_oids()
                if oid in expected:
                    continue
                entry.status = LOST
                self._notify_object(entry)
                entry.had_holder = True
                self._maybe_free(oid, entry, freed)
                lost += 1
            if lost:
                self._version += 1
                self._table_versions["objects"] += 1
        if lost and _events.enabled():
            _events.record(
                _events.HEAD, "gcs", "GHOSTS_LOST", {"n": lost}
            )
        self._broadcast_free(freed)

    def _drain_promoted_graves(self) -> None:
        """Owner-death grace expiry: re-run the free check for promoted
        entries whose hold window passed (an unborrowed dead-owner
        object must still free — just not before an in-flight borrow
        edge could land on its holder shadow)."""
        mono = time.monotonic()
        due: List[bytes] = []
        while self._promoted_graves and self._promoted_graves[0][0] <= mono:
            due.append(self._promoted_graves.popleft()[1])
        resweep: List[bytes] = []
        while self._dead_resweeps and self._dead_resweeps[0][0] <= mono:
            resweep.append(self._dead_resweeps.popleft()[1])
        if not due and not resweep:
            return
        freed: List[bytes] = []
        with self._lock:
            for oid in due:
                entry = self.objects.get(oid)
                if entry is None:
                    continue
                entry.promoted_hold_until = 0.0
                self._maybe_free(oid, entry, freed)
            if resweep:
                # Second pass for dead clients: retire holder shadows
                # that raced past the first sweep on a shard applier.
                dead = set(resweep)
                for oid, entry in self.objects.items():
                    if entry.holders and entry.holders & dead:
                        entry.holders.difference_update(dead)
                        self._maybe_free(oid, entry, freed)
            if freed:
                self._version += 1
                self._table_versions["objects"] += 1
        self._broadcast_free(freed)

    def _finish_recovery(self) -> None:
        """Recovery-window close: whatever no bearer of truth
        re-claimed is swept through the existing owner-death/lineage
        machinery — unclaimed actors restart from their creation specs
        (or die when their budget is spent), unclaimed in-flight tasks
        re-queue and re-execute, unclaimed restored objects free, and
        PENDING entries nothing will ever seal go LOST so parked gets
        resolve into lineage reconstruction instead of wedging."""
        _chaos.kill_point("gcs.recovery")
        freed: List[bytes] = []
        stats = {"actors_restarted": 0, "actors_dead": 0,
                 "tasks_requeued": 0, "objects_swept": 0, "lost": 0}
        with self._lock:
            if not self._recovering_until:
                return
            self._recovering_until = 0.0
            # 1. Unclaimed actors: the old worker never came back.
            for aid in list(self._recover_actors):
                actor = self.actors.get(aid)
                if actor is not None and actor.state == A_PENDING \
                        and aid in self._recover_pending:
                    # Unclaimed held creation: it runs now, for the
                    # first time as far as any head knows.
                    self._pending.append(actor.spec)
                    continue
                if actor is None or actor.state != A_RESTARTING:
                    continue
                spec = actor.spec
                detached = spec.lifetime == "detached"
                if not detached and actor.restarts_used >= spec.max_restarts:
                    # At-most-once for non-restartable, non-detached
                    # actors (same limit _handle_worker_death enforces).
                    actor.state = A_DEAD
                    actor.death_reason = (
                        "actor lost in head failover "
                        "(max_restarts exhausted)"
                    )
                    if actor.name:
                        self.named_actors.pop(actor.name, None)
                    while actor.pending:
                        self._fail_task_returns(
                            actor.pending.popleft(), None,
                            actor_error=actor.death_reason,
                        )
                    self._notify_direct_waiters(actor)
                    self._publish(
                        "ACTOR", aid.hex(),
                        {"state": "DEAD", "reason": actor.death_reason},
                    )
                    stats["actors_dead"] += 1
                else:
                    if not detached:
                        actor.restarts_used += 1
                    actor.epoch += 1  # fence the old incarnation
                    actor.worker_id = None
                    if not self._creation_queued(aid):
                        self._pending.append(spec)
                    stats["actors_restarted"] += 1
            self._recover_actors.clear()
            self._recover_pending.clear()
            # 2. Unclaimed in-flight tasks: their workers died with the
            # old head — re-queue (at-least-once, like reconstruction).
            for spec in self._recover_inflight.values():
                if spec.actor_id is not None and not spec.actor_creation:
                    self._route_actor_task(spec)
                else:
                    self._pending.append(spec)
                stats["tasks_requeued"] += 1
            self._recover_inflight.clear()
            # 3. Return oids a queued/claimed/restarting producer will
            # still seal — these stay PENDING legitimately.
            expected = self._expected_return_oids()
            # 4. Restored objects nobody re-claimed: free through the
            # ownerless path (no leak; a late owner claim would have
            # removed them from this set).
            for oid in self._restored_unclaimed:
                e = self.objects.get(oid)
                if e is None or e.owner is not None or oid in expected:
                    continue
                e.had_holder = True
                n0 = len(freed)
                self._maybe_free(oid, e, freed)
                stats["objects_swept"] += len(freed) - n0
            self._restored_unclaimed.clear()
            # 5. PENDING ghosts: entries with no producer left in any
            # queue — the submit died with the old head and every
            # bearer has now reported. Answer LOST; owners reconstruct
            # from lineage instead of wedging forever. (Ownership is
            # NOT protection: a reconnecting owner re-claims its
            # return refs whether or not their producer survived.)
            for oid, e in self.objects.items():
                if (
                    e.status == PENDING
                    and e.task_pins == 0
                    and oid not in expected
                ):
                    e.status = LOST
                    self._notify_object(e)
                    e.had_holder = True
                    self._maybe_free(oid, e, freed)
                    stats["lost"] += 1
            self._version += 1
            for _t in ("objects", "actors", "pending", "named_actors"):
                self._table_versions[_t] += 1
            self._work.notify_all()
        _events.record(_events.HEAD, "gcs", "RECONCILE_END", dict(stats))
        sys.stderr.write(
            "gcs: recovery window closed — "
            f"actors restarted={stats['actors_restarted']} "
            f"dead={stats['actors_dead']} "
            f"tasks requeued={stats['tasks_requeued']} "
            f"objects swept={stats['objects_swept']} "
            f"lost={stats['lost']}\n"
        )
        self._broadcast_free(freed)

    def _handle_node_death(self, nid: bytes, reason: str):
        with self._lock:
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                return
            node.alive = False
            # Arm the membership fence: any message still carrying this
            # incarnation — or this node_id at all — is now stale. The
            # id joins the fenced set so a zombie's re-registration is
            # rejected and it rejoins with a fresh identity.
            node.incarnation += 1
            self._incarnation_seq = max(
                self._incarnation_seq + 1, node.incarnation
            )
            self._fenced_node_ids.add(nid)
            if node.conn is not None:
                self._daemon_conn_count = max(0, self._daemon_conn_count - 1)
            node.conn = None
            # Objects whose primary copy lived on the dead node are LOST
            # — including copies spilled to the node's local disk (the
            # file died with the host); owners reconstruct them from
            # lineage on the next get (reference:
            # object_recovery_manager.h:41).
            for entry in self.objects.values():
                if (
                    entry.status == READY
                    and (
                        entry.segment is not None
                        or entry.spilled_path is not None
                    )
                    and entry.node_id is not None
                    and entry.node_id.binary() == nid
                ):
                    entry.status = LOST
                    entry.spilled_path = None
                    self._notify_object(entry)
            dead_workers = [
                w
                for w in self.workers.values()
                if w.node_id.binary() == nid and w.state != W_DEAD
            ]
        for w in dead_workers:
            self._handle_worker_death(w.worker_id.binary(), reason)
        self._publish(
            "NODE_INFO", nid.hex(), {"state": "DEAD", "reason": reason}
        )
        with self._lock:
            self._purge_dead_node(nid, reason)
            self._work.notify_all()

    def _h_add_node(self, state, msg):
        with self._lock:
            node = NodeState(
                node_id=NodeID.from_random(),
                total=dict(msg["resources"]),
                available=dict(msg["resources"]),
                label=msg.get("label", ""),
            )
            self.nodes[node.node_id.binary()] = node
            self._work.notify_all()
        state["peer"].reply(msg, ok=True, node_id=node.node_id.binary())

    def _h_drain_node(self, state, msg):
        """Graceful drain (reference: node_manager.h:551): stop new
        placements immediately; the health loop finalizes removal once
        the node is quiet (or the deadline passes)."""
        with self._lock:
            node = self.nodes.get(msg["node_id"])
            if node is None or not node.alive:
                state["peer"].reply(msg, ok=False, error="no such node")
                return
            if node is self.head_node:
                # Draining the head would tear down the control plane
                # itself (reference: the head is not drainable either —
                # DrainNode targets raylets).
                state["peer"].reply(
                    msg, ok=False, error="cannot drain the head node"
                )
                return
            node.schedulable = False
            node.draining = True
            node.drain_reason = msg.get("reason", "") or "drain requested"
            node.drain_deadline = time.time() + float(
                msg.get("deadline_s", 30.0)
            )
            node.drain_started = time.monotonic()
            conn = node.conn
        if conn is not None:
            # Tell the daemon so its local-lease authority stops
            # granting workers too.
            try:
                conn.send({"type": "drain"})
            except ConnectionLost:
                pass
        state["peer"].reply(msg, ok=True, accepted=True)

    def _drain_tick(self, now: float):
        """Finalize drains whose nodes went quiet or whose deadline
        passed (called from the health loop)."""
        with self._lock:
            to_finalize = []
            for node in self.nodes.values():
                if not (node.alive and node.draining):
                    continue
                # Busy = dispatched work the GCS can see (W_BUSY or a
                # non-empty inflight map) OR a leased worker, whose
                # tasks ride the direct transport and are invisible
                # here — leases return on client idle timeout, so this
                # converges (or the deadline forces the issue). The
                # daemon's own pool workers stay LEASED here for good,
                # so they count only while its heartbeat, sent after
                # the drain began (no new local grants since), reports
                # a local lease held; the reference counts them always
                # and so waits out every daemon node's deadline.
                local_held = (
                    node.local_cpus_in_use > 0
                    or node.local_gpus_in_use > 0
                    or node.last_heartbeat <= node.drain_started
                )
                busy = any(
                    w.node_id == node.node_id
                    and (
                        w.state == W_BUSY
                        or (w.state == W_LEASED
                            and (local_held or not w.local_only))
                        or w.inflight
                    )
                    for w in self.workers.values()
                    if w.state != W_DEAD
                )
                if not busy or now >= node.drain_deadline:
                    to_finalize.append(node)
        for node in to_finalize:
            conn = node.conn
            self._handle_node_death(
                node.node_id.binary(), f"drained: {node.drain_reason}"
            )
            if conn is not None:
                try:
                    conn.send({"type": "shutdown"})
                except ConnectionLost:
                    pass

    def _h_remove_node(self, state, msg):
        with self._lock:
            node = self.nodes.get(msg["node_id"])
            if node is None:
                state["peer"].reply(msg, ok=False, error="no such node")
                return
            node.alive = False
            dead_workers = [
                w for w in self.workers.values() if w.node_id.binary() == msg["node_id"]
            ]
        for w in dead_workers:
            if w.proc is not None:
                w.proc.terminate()
            self._handle_worker_death(
                w.worker_id.binary(), "node removed", respawn=False
            )
        with self._lock:
            self._purge_dead_node(msg["node_id"], "node removed")
        state["peer"].reply(msg, ok=True)

    def _purge_dead_node(self, nid: bytes, reason: str) -> None:
        """Drop a dead node from the live table into the bounded history
        ring. Caller holds the lock."""
        node = self.nodes.pop(nid, None)
        if node is None:
            return
        self.dead_nodes.append(
            {
                "node_id": node.node_id.hex(),
                "alive": False,
                "label": node.label,
                "total": dict(node.total),
                "available": {},
                "death_reason": reason,
                "died_at": time.time(),
            }
        )
        # No durable-version bump: node bindings are deliberately not
        # persisted (daemons re-register on reconnect) — "nodes" is not
        # a _TABLES member.

    # ------------------------------------------------------------- scheduling

    def _fail_task_returns(self, spec: TaskSpec, exc: Optional[BaseException],
                           actor_error: Optional[str] = None,
                           error_blob: Optional[bytes] = None):
        from . import serialization
        from ..exceptions import ActorDiedError, RayTaskError

        # Terminal state-API/timeline event for tasks that fail outside
        # a worker (worker death, actor death, unschedulable, ...).
        self._record_task_event(spec.task_id.binary(), spec.name, "FAILED")

        if error_blob is None:
            if actor_error is not None:
                exc = ActorDiedError(
                    spec.actor_id.hex() if spec.actor_id else None, actor_error
                )
            if not isinstance(exc, RayTaskError):
                exc = RayTaskError.from_exception(spec.name, exc)
            error_blob = serialization.pack(exc)
        for oid in spec.return_object_ids():
            entry = self.objects.setdefault(oid.binary(), ObjectEntry())
            entry.status = FAILED
            entry.error = error_blob
            self._notify_object(entry)
        if spec.num_returns == -1:
            # Streaming task failed outside the worker: end the stream
            # so parked consumers see the error instead of hanging.
            st = self._stream_state(spec.task_id.binary())
            self._end_stream(spec.task_id.binary(), st["count"], error_blob)
        # Terminal: release dependency + borrowed-ref pins.
        freed: List[bytes] = []
        pinned = list(spec.dependencies) + list(
            getattr(spec, "borrowed_refs", None) or ()
        )
        for dep in pinned:
            de = self.objects.get(dep.binary())
            if de is not None:
                de.task_pins = max(0, de.task_pins - 1)
                self._maybe_free(dep.binary(), de, freed)
        if freed:
            self._broadcast_free(freed)

    def _deps_ready(self, spec: TaskSpec) -> bool:
        return all(
            (e := self.objects.get(d.binary())) is not None and e.status != PENDING
            for d in spec.dependencies
        )

    def _task_resources(self, spec: TaskSpec) -> Dict[str, float]:
        return {k: v for k, v in spec.resources.items() if v > 0}

    def _release_task_resources(self, spec: TaskSpec, node_id: NodeID):
        res = self._task_resources(spec)
        if not res:
            return
        node = self.nodes.get(node_id.binary())
        if spec.placement_group_id is not None:
            pg = self.placement_groups.get(spec.placement_group_id.binary())
            if pg is not None and 0 <= spec.placement_group_bundle_index < len(
                pg.bundles
            ):
                _release(pg.bundles[spec.placement_group_bundle_index].available, res)
                return
        if node is not None:
            _release(node.available, res)

    def _pick_node(self, spec: TaskSpec) -> Optional[NodeState]:
        """Node selection with the reference's policy surface
        (raylet/scheduling/policy/): NodeAffinity (hard/soft),
        task-level SPREAD, and the hybrid default — binpack nodes while
        critical-resource utilization stays under the spread threshold,
        then least-utilized-first, randomized among the top-k
        (hybrid_scheduling_policy.h:29-49).

        Raises _Unschedulable for permanently-unplaceable tasks (bad or
        removed placement group, dead hard-affinity target) so the
        caller fails them instead of requeueing forever."""
        res = self._task_resources(spec)
        if spec.placement_group_id is not None:
            pg = self.placement_groups.get(spec.placement_group_id.binary())
            if pg is None or pg.state == "REMOVED":
                raise _Unschedulable("placement group removed or not found")
            if pg.state != "CREATED":
                # Restoring after a head failover: bundles re-reserve as
                # nodes re-register; hold the task, don't fail it.
                return None
            idx = spec.placement_group_bundle_index
            if idx >= len(pg.bundles):
                raise _Unschedulable(
                    f"bundle index {idx} out of range for "
                    f"{len(pg.bundles)}-bundle placement group"
                )
            bundles = pg.bundles if idx < 0 else [pg.bundles[idx]]
            for i, bundle in enumerate(bundles):
                if _fits(bundle.available, res):
                    spec.placement_group_bundle_index = idx if idx >= 0 else i
                    _acquire(bundle.available, res)
                    return self.nodes.get(bundle.node_id.binary())
            return None
        strat = spec.scheduling_strategy
        if strat is not None and hasattr(strat, "node_id"):
            # NodeAffinity: hard pins (wait while the target is merely
            # busy, fail if it is gone); soft falls through to the
            # default policy when the target can't take the task
            # (reference: scheduling_policy.h NodeAffinitySchedulingPolicy).
            target = bytes(strat.node_id)
            node = self.nodes.get(target)
            if (
                node is not None
                and node.alive
                and node.schedulable
                # Quarantined target: wait, don't fail — quarantine is
                # probation, the node readmits when scores recover
                # (the fence path below stays for truly-gone targets).
                and not node.quarantined
                and _fits(node.available, res)
            ):
                _acquire(node.available, res)
                return node
            if not getattr(strat, "soft", False):
                if node is None or not node.alive:
                    raise _Unschedulable(
                        f"node affinity target {target.hex()[:12]} is not "
                        "in the cluster"
                    )
                if not node.schedulable or not _fits(node.total, res):
                    # The target can NEVER take this task (draining, or
                    # the shape exceeds the node's total) — fail now
                    # instead of requeueing forever.
                    raise _Unschedulable(
                        f"node affinity target {target.hex()[:12]} cannot "
                        f"ever satisfy {res}"
                    )
                return None
        # Quarantine = drain, not fence: a sustained-bad-score node
        # takes no NEW leases; existing work finishes or hedges away,
        # and readmission restores it to this filter.
        # The first demanded resource is tested first and inline: with
        # many nodes most fail it, and every placement scans every node
        # (with 1000 nodes `_fits` alone held a queue drain to 160
        # tasks/s).
        first, need = next(iter(res.items()), ("CPU", 0.0))
        candidates = [
            n
            for n in self.nodes.values()
            if n.available.get(first, 0.0) + 1e-9 >= need
            and n.alive and n.schedulable and not n.quarantined
            and _fits(n.available, res)
        ]
        if not candidates:
            return None
        if strat == "SPREAD":
            # Task-level SPREAD: least-utilized feasible node
            # (reference: scheduling_policy.h SpreadSchedulingPolicy).
            node = min(
                candidates,
                key=lambda n: (self._node_util(n, res), n.node_id.binary()),
            )
        else:
            node = self._hybrid_pick(candidates, res)
        _acquire(node.available, res)
        return node

    def _node_util(self, n: NodeState, res: Dict[str, float]) -> float:
        """Critical-resource utilization of the node if res lands on it."""
        worst = 0.0
        for k, total in n.total.items():
            if total <= 0:
                continue
            used = total - n.available.get(k, 0.0) + res.get(k, 0.0)
            worst = max(worst, used / total)
        return worst

    def _hybrid_pick(
        self, candidates: List[NodeState], res: Dict[str, float]
    ) -> NodeState:
        """The reference hybrid policy: nodes whose post-placement
        utilization stays under the spread threshold all score 0 and
        sort in stable node-id order — successive tasks pack onto the
        same nodes (keeping whole nodes' cards free for gangs) — while
        saturated nodes sort least-utilized-first.
        Randomizing among the top ceil(k_fraction * n) spreads
        herd-arrival bursts (hybrid_scheduling_policy.h:29-49)."""
        threshold = RayConfig.scheduler_spread_threshold
        scored = sorted(
            (
                (
                    (0.0 if u <= threshold else u),
                    n.node_id.binary(),
                    n,
                )
                for n in candidates
                if (u := self._node_util(n, res)) is not None
            ),
            key=lambda t: (t[0], t[1]),
        )
        k = max(
            1, math.ceil(len(scored) * RayConfig.scheduler_top_k_fraction)
        )
        return scored[self._sched_rng.randrange(k)][2]

    def _sched_loop(self):
        while True:
            with self._work:
                if self._shutdown:
                    return
                try:
                    progressed = self._schedule_once()
                except Exception as e:  # noqa: BLE001 — scheduler must survive
                    sys.stderr.write(f"gcs: scheduler error: {e!r}\n")
                    progressed = False
                if not progressed:
                    self._work.wait(timeout=0.2)

    def _schedule_once(self) -> bool:
        """One scheduling pass under the lock; returns True if anything moved."""
        progressed = False
        # Queued placement groups reserve as capacity frees (lease
        # returns, task completions, node re-registration) — reference:
        # gcs_placement_group_manager retry queue.
        for pg in self.placement_groups.values():
            if pg.state == "PENDING" and self._try_reserve_pg(pg)[0]:
                pg.state = "CREATED"
                self._notify_pg_waiters(pg)
                self._version += 1
                self._table_versions["placement_groups"] += 1
                progressed = True
        # Each task that found resources but no worker claims starting
        # workers of its kind; we only spawn when claims exceed workers
        # already starting (reference: worker_pool.cc PopWorker ->
        # StartWorkerProcess). Keyed by (node, cards per worker).
        claims: Dict[Tuple[bytes, int], int] = {}
        # Special queue (PG-pinned / strategy tasks): placement is
        # per-task state, scan them all.
        special_requeue: List[TaskSpec] = []
        for _ in range(len(self._pending.special)):
            spec = self._pending.special.popleft()
            outcome = self._try_place(spec, claims)
            if outcome in ("dispatched", "unschedulable"):
                progressed = True
                if outcome == "dispatched":
                    # Queue -> inflight is durable (see class-queue
                    # branch below).
                    self._version += 1
                    self._table_versions["pending"] += 1
            else:
                special_requeue.append(spec)
        self._pending.special.extend(special_requeue)
        # Class queues: placement feasibility is a function of the
        # resource shape alone, so the first task that can't place
        # blocks its whole class — one O(nodes) probe per class per
        # pass keeps a 200k-deep queue over 1k nodes cheap
        # (_PendingQueue docstring).
        for key in list(self._pending.classes.keys()):
            q = self._pending.classes.get(key)
            if q is None:
                continue
            deferred: List[TaskSpec] = []
            dispatched_any = False
            for _ in range(len(q)):
                spec = q.popleft()
                outcome = self._try_place(
                    spec, claims, backlog=len(q)
                )
                if outcome in ("dispatched", "unschedulable"):
                    progressed = True
                    if outcome == "dispatched":
                        dispatched_any = True
                        # Queue -> inflight is a durable transition now
                        # (inflight specs persist with the pending
                        # table so a head crash can't lose them).
                        self._version += 1
                        self._table_versions["pending"] += 1
                elif outcome == "deferred":
                    deferred.append(spec)  # deps pending: skip, keep going
                else:  # no capacity / no worker: class blocked this pass
                    q.appendleft(spec)
                    # Scheduling-decision visibility: a class that
                    # can't place is the spillback signal. Record only
                    # when the backlog CHANGES — the scheduler re-probes
                    # at pass rate and a steady blocked class must not
                    # flood the ring.
                    backlog = len(q)
                    # Only while recording: updating the change-tracker
                    # with capture off would suppress the BLOCKED signal
                    # after an operator re-enables it mid-stall.
                    if (
                        _events.enabled()
                        and self._last_blocked.get(key) != backlog
                    ):
                        self._last_blocked[key] = backlog
                        _events.record(
                            _events.SCHED, repr(key[0]), "BLOCKED",
                            {"backlog": backlog},
                        )
                    break
            q.extend(deferred)
            if not q:
                self._pending.classes.pop(key, None)
                # A drained class's next stall is a NEW blocked signal;
                # also keeps the dict bounded by live classes.
                self._last_blocked.pop(key, None)
            elif dispatched_any:
                # Round-robin fairness: a class that consumed capacity
                # this pass goes to the back so a saturated cluster
                # can't let one class starve the ones probed after it
                # (the old global FIFO's arrival-order property).
                self._pending.classes.move_to_end(key)
        return progressed

    def _try_place(self, spec: TaskSpec, claims: Dict[Tuple[bytes, bool], int],
                   backlog: int = 0) -> str:
        """Attempt to place one pending task. Returns "dispatched",
        "unschedulable" (terminal failure recorded), "deferred" (deps
        not ready), or "blocked" (no capacity / no idle worker yet —
        spawn claims recorded). Caller holds the lock."""
        if not self._deps_ready(spec):
            return "deferred"
        try:
            node = self._pick_node(spec)
        except _Unschedulable as e:
            from ..exceptions import (
                PlacementGroupSchedulingError,
                TaskUnschedulableError,
            )

            exc_cls = (
                PlacementGroupSchedulingError
                if spec.placement_group_id is not None
                else TaskUnschedulableError
            )
            self._fail_task_returns(spec, exc_cls(str(e)))
            self._version += 1  # FAILED returns are durable state
            for _t in ("objects", "pending", "actors"):
                self._table_versions[_t] += 1
            return "unschedulable"
        if node is None:
            return "blocked"
        worker = self._pick_worker(node, spec)
        if worker is None:
            # resources were acquired in _pick_node; give them back and
            # retry once a worker registers.
            self._release_task_resources(spec, node.node_id)
            needs_gpus = _gpus_needed(spec)
            nid = (node.node_id.binary(), needs_gpus)
            # This probe stands for the whole blocked class behind it:
            # claim enough boots to cover the backlog (the admission cap
            # still bounds concurrent boots).
            claims[nid] = claims.get(nid, 0) + 1 + backlog
            # Pool accounting is per worker kind: GPU workers are gated
            # by GPU resource accounting, CPU workers by core count.
            starting = sum(
                1
                for w in self.workers.values()
                if w.node_id == node.node_id
                and w.state == W_STARTING
                and w.gpus == needs_gpus
            )
            pool_same_kind = sum(
                1
                for wid in node.pool
                if (w := self.workers.get(wid)) is not None
                and w.gpus == needs_gpus
            )
            can_grow = (
                spec.actor_creation
                or needs_gpus
                or pool_same_kind + starting
                < max(int(node.total.get("CPU", 1)), 1)
            )
            # Admission control: never boot more interpreters at
            # once than the host can actually run — queued claims
            # re-spawn as registrations complete (each hello wakes
            # the scheduler), so a storm drains at the boot rate
            # instead of thrashing (reference: worker_pool.cc
            # maximum_startup_concurrency).
            cap = RayConfig.max_starting_workers_per_node or max(
                4, int(node.total.get("CPU", 1))
            )
            while starting < claims[nid] and can_grow and starting < cap:
                self._spawn_worker(node, gpus=needs_gpus)
                starting += 1
                if not (spec.actor_creation or needs_gpus):
                    can_grow = pool_same_kind + starting < max(
                        int(node.total.get("CPU", 1)), 1
                    )
            return "blocked"
        host_packed = worker.actor_host and spec.actor_creation
        if host_packed:
            # Shared host: it may be serving other actors right now —
            # no W_BUSY/current_task claim (that machinery assumes
            # one task at a time); inflight alone carries the spec,
            # like _route_actor_task's method dispatch.
            worker.inflight[spec.task_id.binary()] = spec
        else:
            worker.state = W_BUSY
            worker.current_task = spec
            worker.task_started_at = time.time()
            worker.inflight[spec.task_id.binary()] = spec
            if spec.actor_creation:
                worker.actor_id = spec.actor_id
        try:
            msg_out = {
                "type": "execute_task", "spec": spec,
                # Health signal: the worker echoes how long this grant
                # spent in flight (grant_lat in the done record) — a
                # throttled link stretches it 10-100x.
                "t_grant": time.time(),
            }
            if host_packed:
                msg_out["packed"] = True
            worker.conn.send(msg_out)
            self._record_task_event(
                spec.task_id.binary(), spec.name, "RUNNING",
                worker.worker_id.binary(),
            )
            if _events.enabled():
                _events.record(
                    _events.TASK, spec.task_id.hex(), "LEASED",
                    {
                        "worker": worker.worker_id.hex(),
                        "node": node.node_id.hex()[:12],
                        "route": "gcs",
                    },
                )
            return "dispatched"
        except ConnectionLost:
            self._release_task_resources(spec, node.node_id)
            self._pending.append(spec)
            self._handle_worker_death(
                worker.worker_id.binary(), "send failed", respawn=True
            )
            return "unschedulable"

    @staticmethod
    def _packable(spec: TaskSpec) -> bool:
        """Sub-core, default-environment, serial actors co-host many per
        process (opt-in by declaring 0 < num_cpus < 1). Everything else
        keeps the reference's process-per-actor isolation — including
        default actors (num_cpus=0), whose authors never said sharing a
        process was acceptable."""
        return (
            spec.actor_creation
            and RayConfig.max_actors_per_worker > 1
            and set(spec.resources) <= {"CPU"}
            and 0 < spec.resources.get("CPU", 0) < 1
            and spec.max_concurrency == 1
            and not spec.concurrency_groups
            and spec.runtime_env is None
            and spec.placement_group_id is None
        )

    def _pick_worker(self, node: NodeState, spec: TaskSpec) -> Optional[WorkerHandle]:
        needs_gpus = _gpus_needed(spec)
        if not needs_gpus and self._packable(spec):
            # Pick the least-loaded live host; but while every host is
            # at/over the spread threshold and the node can still open
            # hosts, prefer converting another idle worker — packing
            # density saves boots, spread saves the call path (100
            # actors on 2 processes serialize their storms on 2 GILs).
            cap = RayConfig.max_actors_per_worker
            best, best_load = None, None
            for wid in list(node.actor_hosts):
                w = self.workers.get(wid)
                if w is None or w.state == W_DEAD or not w.actor_host:
                    node.actor_hosts.discard(wid)
                    continue
                if w.conn is None:
                    continue
                load = len(w.packed) + sum(
                    1 for s in w.inflight.values() if s.actor_creation
                )
                if load < cap and (best_load is None or load < best_load):
                    best, best_load = w, load
            host_cap = max(4, int(node.total.get("CPU", 1)))
            want_new = (
                best is None
                or (
                    best_load >= RayConfig.actor_host_spread_threshold
                    and len(node.actor_hosts) < host_cap
                )
            )
            if want_new:
                for wid in list(node.pool):
                    w = self.workers.get(wid)
                    if (
                        w is not None
                        and w.state == W_IDLE
                        and w.conn is not None
                        and not w.gpus
                    ):
                        node.pool.discard(wid)
                        w.actor_host = True
                        node.actor_hosts.add(wid)
                        return w
            return best
        for wid in list(node.pool):
            w = self.workers.get(wid)
            if (
                w is not None
                and w.state == W_IDLE
                and w.conn is not None
                and w.gpus == needs_gpus
            ):
                if spec.actor_creation:
                    node.pool.discard(wid)
                return w
        return None

    def _spawn_worker(self, node: NodeState, gpus: int = 0) -> WorkerHandle:
        self._worker_counter += 1
        wid = WorkerID.from_random()
        w = WorkerHandle(worker_id=wid, node_id=node.node_id, gpus=gpus)
        self.workers[wid.binary()] = w
        _events.record(
            _events.WORKER, wid.hex(), "SPAWN_REQUESTED",
            {"node": node.node_id.hex()[:12], "gpus": gpus},
        )
        if node.conn is not None:
            # Remote node: its daemon spawns the worker (and owns its
            # cards' ids); the worker connects back to us over TCP.
            try:
                node.conn.send(
                    {"type": "spawn_worker", "worker_id": wid.binary(), "gpus": gpus}
                )
            except ConnectionLost:
                self._handle_node_death(
                    node.node_id.binary(), "daemon send failed"
                )
            return w
        # Per-worker env on top of the spawner's base (CUDA pinning for
        # workers without a card happens inside the spawner; reference:
        # worker_pool.cc StartWorkerProcess env plumbing).
        env = {
            "RAY_TPU_TORCH_WORKER_ID": wid.hex(),
            "PYTHONUNBUFFERED": "1",  # prints reach the log tailer live
            # Chaos rule scoping: a standalone head process carries
            # role "head" (head_main) — its spawned workers must not
            # inherit it or kill:gcs.* / ?role=head rules would fire
            # inside workers.
            "RAY_TPU_TORCH_CHAOS_ROLE": "worker",
            # Current flight-recorder toggle: a worker spawned after
            # `events --record off` must not silently resume recording
            # (RayConfig reads this env override at worker boot).
            "RAY_TPU_TORCH_events_enabled": (
                "1" if _events.get_recorder().enabled else "0"
            ),
        }
        if gpus:
            w.gpu_ids = self._assign_head_gpus(node, wid.binary(), gpus)
            GPUAcceleratorManager.set_visible_accelerator_ids(
                env, list(w.gpu_ids)
            )
        logdir = os.path.join(self.session_dir, "logs")
        os.makedirs(logdir, exist_ok=True)
        log_path = os.path.join(logdir, f"worker-{wid.hex()[:8]}.out")
        # Pipelined spawn returns before the fork completes; a failed
        # fork must tear down the W_STARTING entry or pool accounting
        # would count a ghost forever.
        w.proc = self._spawner.spawn(
            env, log_path, gpu=bool(gpus),
            on_fail=lambda b=wid.binary(): self._handle_worker_death(
                b, "worker spawn failed"
            ),
        )
        return w

    def _assign_head_gpus(self, node: NodeState, wid: bytes,
                          n: int) -> Tuple[str, ...]:
        """The head node's card ids for a new worker of `n` cards: those
        no live worker holds, lowest first; when fewer are free
        (fractional requests share a card), the least-held ones. The
        scheduler has already taken the GPU resource, so whole-card
        requests always find free ids. Caller holds the lock."""
        ids = GPUAcceleratorManager.node_device_ids(
            int(node.total.get("GPU", 0))
        )
        held = {i: 0 for i in ids}
        for other in self.workers.values():
            if (
                other.worker_id.binary() != wid
                and other.node_id == node.node_id
                and other.state != W_DEAD
            ):
                for i in other.gpu_ids:
                    if i in held:
                        held[i] += 1
        order = sorted(ids, key=lambda i: (held[i], ids.index(i)))
        return tuple(sorted(order[:n], key=ids.index))

    def _maybe_repool_host(self, w: WorkerHandle) -> None:
        """An emptied shared host (no packed actors, no in-flight
        creations) rejoins the fungible pool as a warm prestarted
        worker. Caller holds the lock."""
        if w.state == W_DEAD or not w.actor_host:
            return
        if w.packed or any(s.actor_creation for s in w.inflight.values()):
            return
        w.actor_host = False
        w.state = W_IDLE
        node = self.nodes.get(w.node_id.binary())
        if node is not None:
            node.actor_hosts.discard(w.worker_id.binary())
            node.pool.add(w.worker_id.binary())
        self._work.notify_all()

    def _h_worker_spawn_failed(self, state, msg):
        """A remote raylet could not start a head-requested worker (both
        the zygote fork and the cold-path Popen failed): release the
        W_STARTING entry so its startup-cap slot and claimed task free
        up (the local-spawn analogue is the on_fail in _spawn_worker)."""
        self._handle_worker_death(msg["worker_id"], "worker spawn failed")

    def _handle_worker_death(self, wid: bytes, reason: str, respawn: bool = False):
        from ..exceptions import OutOfMemoryError, WorkerCrashedError

        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.state == W_DEAD:
                return
            if w.death_reason_hint:
                reason = w.death_reason_hint
            exc_cls = (
                OutOfMemoryError
                if reason.startswith("out-of-memory")
                else WorkerCrashedError
            )
            self._version += 1  # task failures are durable state
            for _t in (
                "objects", "actors", "pending", "orphans", "named_actors",
            ):
                self._table_versions[_t] += 1
            prev_state = w.state
            w.state = W_DEAD
            node = self.nodes.get(w.node_id.binary())
            if node is not None:
                node.pool.discard(wid)
                node.actor_hosts.discard(wid)
            dying_task = w.current_task
            if dying_task is not None:
                self._release_task_resources(dying_task, w.node_id)
                w.current_task = None
            if w.lease_resources:
                if node is not None:
                    _release(node.available, w.lease_resources)
                w.lease_resources = None
            inflight, w.inflight = dict(w.inflight), {}
            for tid, spec in inflight.items():
                hedge = self._hedges.get(tid)
                if hedge is not None and wid in hedge["seqs"]:
                    # A hedged twin died mid-race. It can't win
                    # posthumously; if its sibling is still running
                    # (or already won), the task needs NO retry — a
                    # requeue here would re-run side effects the
                    # sibling produces exactly once. Only when every
                    # twin is gone does the normal retry path below
                    # take over.
                    del hedge["seqs"][wid]
                    hedge["pending"].discard(wid)
                    if not hedge["pending"]:
                        self._hedges.pop(tid, None)
                    if hedge["winner"] is not None or hedge["seqs"]:
                        continue
                if spec.actor_id is not None and not spec.actor_creation:
                    self._fail_task_returns(
                        spec, None, actor_error=f"actor worker died: {reason}"
                    )
                elif spec.max_retries > 0 and not spec.actor_creation:
                    # System failures are always retriable up to max_retries
                    # (reference: task_manager.h RetryTaskIfPossible).
                    spec.max_retries -= 1
                    self._pending.append(spec)
                else:
                    self._fail_task_returns(
                        spec, exc_cls(f"worker died: {reason}")
                    )
            # Every actor this process hosted dies with it: the dedicated
            # actor (actor_id), every packed actor on a shared host, and
            # any packed creation still in flight (its resources were
            # acquired at scheduling but never entered `packed`).
            dead_actor_ids: List[Tuple[bytes, bool]] = []
            if w.actor_id is not None:
                dead_actor_ids.append((w.actor_id.binary(), False))
            for aid_b in w.packed:
                dead_actor_ids.append((aid_b, True))
            for spec in inflight.values():
                if (
                    spec.actor_creation
                    and spec.actor_id is not None
                    and spec.actor_id.binary() not in w.packed
                    and (
                        w.actor_id is None
                        or spec.actor_id.binary() != w.actor_id.binary()
                    )
                ):
                    dead_actor_ids.append((spec.actor_id.binary(), True))
            w.packed = {}
            for aid_b, release_always in dead_actor_ids:
                actor = self.actors.get(aid_b)
                # A RESTARTING actor listed here died in its restart
                # attempt (this worker held its re-creation): it restarts
                # again, as when its first creation's worker dies. The
                # reference skips it, and the actor stays RESTARTING on
                # no worker, its calls queued forever.
                if actor is not None and actor.state != A_DEAD:
                    self._recover_actors.discard(aid_b)
                    released_creation = (
                        dying_task is not None and dying_task.actor_creation
                    )
                    if release_always or prev_state == W_ACTOR or (
                        prev_state == W_BUSY and not released_creation
                    ):
                        # Lifetime resources held since creation. W_BUSY
                        # mid-method: the method's own resources went via
                        # current_task above, creation's release here.
                        # W_BUSY mid-creation: current_task IS the
                        # creation spec — already released, don't double.
                        self._release_task_resources(actor.spec, w.node_id)
                    if actor.restarts_used < actor.spec.max_restarts:
                        # Restart state machine (reference: GcsActorManager,
                        # design doc actor_states.rst ALIVE -> RESTARTING).
                        actor.restarts_used += 1
                        actor.epoch += 1  # fence the old incarnation
                        actor.state = A_RESTARTING
                        actor.worker_id = None
                        if not self._creation_queued(aid_b):
                            self._pending.append(actor.spec)
                    else:
                        actor.state = A_DEAD
                        actor.death_reason = f"actor worker died: {reason}"
                        self._publish(
                            "ACTOR", actor.actor_id.hex(),
                            {"state": "DEAD", "reason": actor.death_reason},
                        )
                        if actor.name:
                            self.named_actors.pop(actor.name, None)
                        while actor.pending:
                            self._fail_task_returns(
                                actor.pending.popleft(), None,
                                actor_error=actor.death_reason,
                            )
                        self._notify_direct_waiters(actor)
            self._work.notify_all()
        if w.proc is not None:
            threading.Thread(
                target=_reap, args=(w.proc, w.direct_addr), daemon=True
            ).start()

    # --------------------------------------------------------------- shutdown

    def shutdown(self):
        # Detach from the process-global flight-recorder ring FIRST: a
        # late message trickling into this (dying) server's aggregator
        # would otherwise keep its indexer draining the ring, stealing
        # events from the next session's aggregator in this process.
        self.events.local_recorder = None
        self._log_monitor.stop()
        if self._pub_thread is not None:
            self._pub_queue.put(None)
        with self._lock:
            self._shutdown = True
            self._work.notify_all()
            workers = list(self.workers.values())
            peers = list(self._peers)
            daemons = [n.conn for n in self.nodes.values() if n.conn is not None]
            segs = [
                ObjectID(oid)
                for oid, e in self.objects.items()
                if e.segment is not None
            ]
        for conn in daemons:
            try:
                conn.send({"type": "shutdown"})
            except ConnectionLost:
                pass
        for w in workers:
            if w.conn is not None:
                try:
                    w.conn.send({"type": "exit"})
                except ConnectionLost:
                    pass
        deadline = time.time() + 2.0
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=max(0.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()
        try:
            self._listener.close()
        except Exception:
            pass
        if self._tcp_listener is not None:
            try:
                self._tcp_listener.close()
            except Exception:  # noqa: BLE001
                pass
        for p in peers:
            p.close()
        self._spawner.shutdown()
        self.objects.stop()
        for oid in segs:
            self._store.delete(oid)
        self._store.close()


def stale_node_ids(nodes, now_mono: float, period_s: float,
                   threshold: float) -> List[bytes]:
    """Heartbeat-timeout sweep decision (pure; unit-tested).

    ``now_mono`` and ``NodeState.last_heartbeat`` are BOTH
    time.monotonic() readings: liveness must never consult the wall
    clock, or an NTP step / VM resume would mass-declare live nodes
    dead (reference: GcsHealthCheckManager counts missed probes, it
    does not diff wall timestamps)."""
    return [
        n.node_id.binary()
        for n in nodes
        if n.alive
        and n.conn is not None
        and n.last_heartbeat > 0
        and now_mono - n.last_heartbeat > period_s * threshold
    ]


def _drop_spill_file(entry: "ObjectEntry") -> None:
    """Clear (and unlink) an entry's superseded spill copy: a fresh
    seal replaces the bytes, and the old file would otherwise sit in
    the spill dir unreferenced for the session lifetime."""
    if entry.spilled_path:
        try:
            os.unlink(entry.spilled_path)
        except OSError:
            pass
    entry.spilled_path = None


def sort_oom_victims(victims: List["WorkerHandle"]) -> List["WorkerHandle"]:
    """OOM kill ladder ordering (pure; unit-tested).

    Tiers (reference: worker_killing_policy_group_by_owner.h layered
    over the retriable-FIFO policy):

    1. group-by-owner fairness — prefer victims from the submitting
       job with the MOST running tasks, so one job's burst pays for
       the pressure it created instead of starving another job's
       single task;
    2. retriability — GCS-retriable first (it resubmits), then leased
       (the caller decides retry on conn loss), then non-retriable;
    3. newest-first within the tie (the least sunk work).
    """
    def _klass(w) -> int:
        if w.state == W_LEASED:
            return 1
        return 0 if w.current_task.max_retries > 0 else 2

    def _group(w):
        # Owner identity is only known for GCS-routed tasks. A victim
        # without one (leased workers: the GCS can't see their task)
        # is its OWN singleton group — lumping all unknowns into one
        # pseudo-job would make the fairness tier gang up on innocent
        # leased workers from unrelated jobs.
        t = w.current_task
        o = getattr(t, "owner_client", None) if t is not None else None
        return o if o else ("solo", id(w))

    group_size: Dict[Any, int] = {}
    for w in victims:
        g = _group(w)
        group_size[g] = group_size.get(g, 0) + 1
    return sorted(
        victims,
        key=lambda w: (
            -group_size[_group(w)], _klass(w), -w.task_started_at
        ),
    )


def _reap(proc: subprocess.Popen, direct_addr: str = ""):
    """Waits for a dead worker this head forked (killing it after 5 s),
    then removes its direct-call socket, which a killed worker leaves."""
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if direct_addr.startswith("/"):
        unlink_worker_socket(direct_addr)
