"""Flight recorder: always-on structured runtime events, cheap enough
to leave enabled in production.

Reference: the task-event path (core worker TaskEventBuffer →
GcsTaskManager → dashboard timeline / `ray list tasks`,
task_event_buffer.h + gcs_task_manager.h) generalized to every layer
boundary: submission, scheduling decision, lease lifecycle, zygote
fork, execution, object seal/transfer. Three pieces:

- :class:`FlightRecorder` — one per process, a bounded lock-free ring
  of event tuples. Recording is on by default
  (``RAY_TPU_TORCH_events_enabled=0`` disables) with a hard budget: one
  deque append per event, no dict building on the hot path (hot paths
  record ONE span event carrying several timestamps in its attrs;
  the aggregator expands it off the hot path). Overflow evicts the
  oldest event and counts the drop — drops are never silent
  (exported as a Prometheus counter).

- shipping — events piggyback on flushes that already exist: workers
  drain their ring into the next ``task_done_batch`` (or the
  ``flush_events`` read barrier), raylets onto their heartbeat, and
  the head/driver process's ring is drained in-process by the
  aggregator (the GCS threads live there).

- :class:`EventAggregator` — head-side store with per-job retention
  caps (a "job" is the submitting process until a richer job id is
  attached), per-task transition expansion for the state API /
  the stitched timeline, and incrementally-maintained derived
  metrics: per-phase latency histograms and drop counters.

Event wire format (compact tuple):
    (t_wall, t_mono, category, entity, event, attrs-or-None)

Canonical task lifecycle transitions (expanded by the aggregator):
    SUBMITTED → QUEUED → LEASED → FORKED → EXEC_START → EXEC_END
    → SEALED
stitched by :func:`stitch_task_phases` into the six phases
submit/queue/lease/fork/exec/seal.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from bisect import bisect_left
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

# Categories.
TASK, WORKER, LEASE, OBJECT, TRANSFER, SCHED, REFS, CHAOS, HEAD = (
    "task", "worker", "lease", "object", "transfer", "sched", "refs",
    "chaos", "head",
)

#: Order of the canonical per-task transitions; also the stitch order.
TASK_TRANSITIONS = (
    "SUBMITTED", "QUEUED", "LEASED", "FORKED",
    "EXEC_START", "EXEC_END", "SEALED",
)

#: The six phases between consecutive transitions.
TASK_PHASES = ("submit", "queue", "lease", "fork", "exec", "seal")

#: Histogram bucket boundaries (seconds) for per-phase latencies.
PHASE_BOUNDARIES = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
)

# Per-thread execution context (set by the worker runtime around user
# code) — consumed by the log-line tagger so a print() correlates to
# its timeline row. Thread-local, not a contextvar: prints happen on
# the thread running the task (inline reader threads, pool threads).
_ctx = threading.local()


def set_task_context(task_id_hex: Optional[str]) -> None:
    _ctx.task_id = task_id_hex


def current_task_context() -> Optional[str]:
    return getattr(_ctx, "task_id", None)


class FlightRecorder:
    """Per-process bounded ring of runtime events.

    Lock-free on the record path (GIL-atomic deque ops); drain uses
    popleft-until-empty so it never races a concurrent append into
    losing events. ``dropped`` counts ring evictions since the last
    drain — the count ships with the next batch so overflow is
    observable end to end."""

    __slots__ = ("capacity", "enabled", "_buf", "dropped", "source")

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 source: Optional[str] = None):
        from .config import RayConfig

        self.capacity = int(capacity or RayConfig.event_buffer_size)
        if enabled is None:
            enabled = bool(RayConfig.events_enabled)
        self.enabled = enabled
        self._buf: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self.source = source or f"pid-{os.getpid()}"

    def record(self, category: str, entity: str, event: str,
               attrs: Optional[Dict[str, Any]] = None) -> None:
        """Hot path: one tuple build + one append. attrs may carry
        extra timestamps (span events) — pass a dict only when you
        already have one; never build one just to label a point."""
        if not self.enabled:
            return
        buf = self._buf
        if len(buf) == self.capacity:
            # maxlen deque: the append below evicts the oldest.
            self.dropped += 1
        # Second slot is reserved for a monotonic stamp; wall time alone
        # feeds the stitcher (which clamps skew), and skipping the extra
        # clock read halves the timing cost of a record.
        buf.append((time.time(), 0.0, category, entity, event, attrs))

    def drain(self) -> Tuple[List[tuple], int]:
        """Take everything recorded so far (+ the drop count since the
        last drain). Safe against concurrent record()."""
        buf = self._buf
        out: List[tuple] = []
        while True:
            try:
                out.append(buf.popleft())
            except IndexError:
                break
        d, self.dropped = self.dropped, 0
        return out, d

    def attach(self, msg: Dict[str, Any]) -> Tuple[List[tuple], int]:
        """Drain the ring onto an outgoing message (the piggyback
        shipping pattern). Pair with :meth:`count_lost` if the send
        fails so the loss stays observable."""
        items, dropped = self.drain()
        if items:
            msg["events"] = items
        if dropped:
            msg["events_dropped"] = dropped
        return items, dropped

    def count_lost(self, items: List[tuple], dropped: int) -> None:
        """A drained batch died before reaching the head (connection
        lost): fold it into the drop counter so the next successful
        ship reports it — drops are never silent."""
        if items or dropped:
            self.dropped += len(items) + dropped

    def __len__(self) -> int:
        return len(self._buf)


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    r = _recorder
    if r is None:
        with _recorder_lock:
            r = _recorder
            if r is None:
                r = _recorder = FlightRecorder()
    return r


def record(category: str, entity: str, event: str,
           attrs: Optional[Dict[str, Any]] = None) -> None:
    """Module-level convenience for instrumentation sites."""
    get_recorder().record(category, entity, event, attrs)


def enabled() -> bool:
    return get_recorder().enabled


# --------------------------------------------------------------- aggregator


#: Span event -> (attrs key, canonical transition) expansion table —
#: the single source of truth for span layout, consumed by _expand,
#: _validate_task_item and EventAggregator._track_task alike.
_SPAN_KEYS = {
    "SUBMIT_SPAN": (
        ("t_submit", "SUBMITTED"),
        ("t_queue", "QUEUED"),
        ("t_lease", "LEASED"),
    ),
    "EXEC_SPAN": (
        ("t_fork", "FORKED"),
        ("t_start", "EXEC_START"),
        ("t_end", "EXEC_END"),
        ("t_seal", "SEALED"),
    ),
}

#: Transitions a span implies even when its attrs key is absent,
#: defaulting to the record's own stamp: a SUBMIT_SPAN is a submission
#: and an EXEC_SPAN always seals.
_SPAN_IMPLIED = {"SUBMITTED", "SEALED"}


def _expand(item: tuple, source: str) -> List[Dict[str, Any]]:
    """Normalize one wire event into transition dicts.

    Span events carry several boundary timestamps in one append (see
    _SPAN_KEYS) so the hot paths pay one record; the expansion to
    individual transitions happens here, on the head, off every hot
    path."""
    t_wall, t_mono, category, entity, event, attrs = item
    base = {
        "category": category,
        "entity": entity,
        "timestamp": t_wall,
        "monotonic": t_mono,
        "source": source,
    }
    span = _SPAN_KEYS.get(event) if category == TASK else None
    if span is None:
        return [dict(base, event=event, attrs=attrs)]
    a = attrs or {}
    worker = a.get("worker", "")
    out = []
    for key, name in span:
        if key in a:
            ts = a[key]
        elif name in _SPAN_IMPLIED:
            ts = t_wall
        else:
            continue
        ev_attrs: Dict[str, Any] = {}
        if name == "SUBMITTED":
            ev_attrs["route"] = a.get("route", "")
        if event == "EXEC_SPAN":
            ev_attrs["worker"] = worker
            if name == "SEALED" and a.get("error"):
                ev_attrs["error"] = True
        out.append(dict(base, event=name, timestamp=ts, attrs=ev_attrs))
    return out


def _validate_task_item(item: tuple) -> None:
    """Raise if a task event could poison phase accounting:
    :meth:`EventAggregator._track_task` and the histogram math assume
    a 6-tuple with a hashable entity and numeric timestamps."""
    t_wall, _t_mono, _cat, tid, event, attrs = item
    hash(tid)
    if not isinstance(t_wall, (int, float)):
        raise TypeError("non-numeric timestamp")
    span = _SPAN_KEYS.get(event)
    if span is not None:
        a = attrs or {}
        for key, _name in span:
            if key in a and not isinstance(a[key], (int, float)):
                raise TypeError(f"non-numeric {key}")


class EventAggregator:
    """Head-side store of flight-recorder events.

    The ingest path is ONE deque append: batches arrive on the GCS
    dispatch thread, which at task-storm rates is the cluster's
    throughput bottleneck, so expansion, per-job indexing and phase
    accounting all run on a dedicated background thread (reference:
    GcsTaskManager owns its own io_context thread for exactly this
    reason, gcs_task_manager.h). Reads flush the backlog first, so
    they stay read-your-writes.

    Retention is capped PER JOB (submitting process) so one chatty
    job cannot evict another job's history; evictions count into the
    per-job drop counter beside the per-process ring drops, and a
    bounded ingest backlog counts overflow the same way — drops are
    never silent."""

    _OPEN_CAP = 10_000
    _BACKLOG_CAP = 500_000  # raw events queued for the indexer thread

    def __init__(self, per_job_cap: Optional[int] = None):
        from .config import RayConfig

        self.per_job_cap = int(
            per_job_cap or RayConfig.event_retention_per_job
        )
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # Optional process-local FlightRecorder drained at the top of
        # every indexer round, BEFORE shipped batches are indexed:
        # local events (submission, scheduling decision) happen-before
        # the execution events workers ship for the same task, so
        # draining them first keeps per-task transition order right
        # without any cross-process synchronization.
        self.local_recorder: Optional[FlightRecorder] = None
        # Unprocessed (items, source) batches awaiting the indexer.
        self._pending: deque = deque()
        self._pending_count = 0
        self._indexing = False
        self._thread: Optional[threading.Thread] = None
        # job -> deque of (pickled-batch, event count). Retained
        # history is stored PACKED: tens of thousands of live dicts
        # and tuples make every gen-2 GC pass in the head process
        # proportionally slower (measured ~30us/task on the async
        # task microbenchmark), while opaque bytes blobs are free to
        # the collector. Reads unpack; expansion to transition dicts
        # also happens at read time.
        self._by_job: "OrderedDict[str, deque]" = OrderedDict()
        self._job_counts: Dict[str, int] = {}
        # source -> ring/retention/backlog drops.
        self.drops: Dict[str, int] = {}
        # category -> ingested event count.
        self.totals: Dict[str, int] = {}
        # task entity -> {transition: wall_ts} awaiting SEALED.
        self._open: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        # Sealed tasks lingering for late submit-side spans (a remote
        # driver's SUBMIT_SPAN may ship long after the worker's
        # EXEC_SPAN): (tid, monotonic seal time) in seal order, plus a
        # membership set. Finalized into the phase histograms on age
        # or on a read barrier — by flush() time every span available
        # anywhere has been indexed, so the merge is complete.
        self._sealed_pending: deque = deque()
        self._sealed_set: set = set()
        # Tasks whose phases were already finalized: a submit-side span
        # arriving later (remote driver flushing minutes after the
        # EXEC_SPAN sealed) must NOT reopen an _open entry — it would
        # never seal again, and a burst of such orphans churns the
        # _OPEN_CAP FIFO, evicting genuinely in-flight tasks' state.
        # list()/timeline reads stay complete either way: they re-expand
        # the retained raw events, not this accounting state.
        self._finalized_recent: deque = deque(maxlen=self._OPEN_CAP)
        self._finalized_set: set = set()
        # phase -> [bucket counts + overflow], and phase -> sum seconds.
        self.phase_counts: Dict[str, List[int]] = {
            p: [0] * (len(PHASE_BOUNDARIES) + 1) for p in TASK_PHASES
        }
        self.phase_sums: Dict[str, float] = {p: 0.0 for p in TASK_PHASES}

    #: Indexer poll period. Ingest deliberately does NOT notify the
    #: indexer — at task-storm rates a notify per batch turns into a
    #: GIL handoff between the dispatch and indexer threads per
    #: shipment (measured ~100us/task of dispatch-side CPU on the
    #: async-tasks microbenchmark). The indexer wakes on this period
    #: and drains the whole backlog in one pass; read barriers
    #: (flush) notify to skip the wait.
    _POLL_S = 0.05

    #: How long a sealed task's transitions linger awaiting late
    #: submit-side spans before the phase histograms are finalized
    #: without them. Reads force-finalize, so this only bounds memory
    #: on read-free clusters — it never delays a scrape.
    _SEAL_LINGER_S = 5.0

    def ingest(self, items: List[tuple], source: str,
               ring_dropped: int = 0) -> None:
        """Hot path (GCS dispatch thread): O(1) — enqueue the batch for
        the indexer thread and return. No wakeup: the indexer
        poll-coalesces (see _POLL_S)."""
        with self._cv:
            if ring_dropped:
                self.drops[source] = (
                    self.drops.get(source, 0) + ring_dropped
                )
            if not items:
                return
            self._pending.append((items, source))
            self._pending_count += len(items)
            while self._pending_count > self._BACKLOG_CAP:
                old_items, old_source = self._pending.popleft()
                self._pending_count -= len(old_items)
                self.drops[old_source] = (
                    self.drops.get(old_source, 0) + len(old_items)
                )
            self._ensure_thread()

    def _ensure_thread(self) -> None:
        """Start the indexer lazily. Caller holds the lock."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._index_loop,
                name="event-aggregator",
                daemon=True,
            )
            self._thread.start()

    # ---------------------------------------------------------- indexing

    def _index_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending:
                    self._indexing = False
                    self._cv.notify_all()  # wake flush() waiters
                    self._cv.wait(self._POLL_S)
                self._indexing = True
                # Take the WHOLE backlog in one lock acquisition and
                # merge consecutive same-source batches, so a poll
                # tick pays one pickle per source, not per shipment.
                taken, self._pending = self._pending, deque()
                self._pending_count = 0
            merged: List[Tuple[List[tuple], str]] = []
            rec = self.local_recorder
            if rec is not None:
                # Local events first: they happen-before the shipped
                # execution events for the same tasks (see __init__).
                litems, ldropped = rec.drain()
                if ldropped:
                    with self._lock:
                        self.drops[rec.source] = (
                            self.drops.get(rec.source, 0) + ldropped
                        )
                if litems:
                    merged.append((litems, rec.source))
            for items, source in taken:
                if merged and merged[-1][1] == source:
                    merged[-1][0].extend(items)
                else:
                    merged.append((list(items), source))
            for items, source in merged:
                try:
                    self._index_batch(items, source)
                except Exception:  # noqa: BLE001 - indexer must
                    # survive; the batch is lost but counted.
                    with self._lock:
                        self.drops[source] = (
                            self.drops.get(source, 0) + len(items)
                        )

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until everything ingested so far is indexed (read
        barrier for list/summary), then finalize lingering sealed
        tasks — at this point every span available anywhere has been
        indexed, so phase merges are complete."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._cv.notify_all()  # kick the indexer out of its poll
            while self._pending or self._indexing:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    break
            self._finalize_sealed(force=True)

    def drain_local_front(self) -> None:
        """Read-path helper: move the process-local ring to the FRONT
        of the backlog so local submit-side events index before any
        already-pending shipped batches (the same happens-before
        invariant the indexer's own local-drain-first preserves)."""
        rec = self.local_recorder
        if rec is None:
            return
        items, dropped = rec.drain()
        with self._cv:
            if dropped:
                self.drops[rec.source] = (
                    self.drops.get(rec.source, 0) + dropped
                )
            if items:
                self._pending.appendleft((items, rec.source))
                self._pending_count += len(items)
                self._ensure_thread()

    def _index_batch(self, items: List[tuple], source: str) -> None:
        """Totals + phase accounting + packed retention. Runs on the
        indexer thread OUTSIDE the ingest lock — the expensive part
        (pickling the retained blob) must not stall the GCS dispatch
        thread's O(1) ingest — reacquiring it only to publish."""
        drops = 0
        good: List[tuple] = []
        totals: Dict[str, int] = {}
        task_items: List[tuple] = []
        for item in items:
            try:
                if len(item) != 6:
                    # Wrong arity would poison every later read (the
                    # expansion unpacks 6 fields from retained blobs).
                    drops += 1
                    continue
                category = item[2]
            except (TypeError, IndexError):  # malformed: count it
                drops += 1
                continue
            totals[category] = totals.get(category, 0) + 1
            if category == TASK:
                try:
                    # Attrs must be well-formed before the item is
                    # retained; phase accounting itself happens under
                    # the lock below.
                    _validate_task_item(item)
                except Exception:  # noqa: BLE001 - malformed attrs
                    drops += 1
                    continue
                task_items.append(item)
            good.append(item)
        if len(good) > self.per_job_cap:
            drops += len(good) - self.per_job_cap
            good = good[-self.per_job_cap:]
        blob = pickle.dumps(good) if good else b""
        with self._lock:
            for c, n in totals.items():
                self.totals[c] = self.totals.get(c, 0) + n
            for item in task_items:
                self._track_task(item)
            if good:
                q = self._by_job.get(source)
                if q is None:
                    q = self._by_job[source] = deque()
                q.append((blob, len(good)))
                count = self._job_counts.get(source, 0) + len(good)
                # Retention evicts whole packed blobs (oldest first);
                # every evicted event counts as a drop.
                while count > self.per_job_cap and len(q) > 1:
                    _, n = q.popleft()
                    count -= n
                    drops += n
                self._job_counts[source] = count
            if drops:
                self.drops[source] = self.drops.get(source, 0) + drops
            self._finalize_sealed()

    def _track_task(self, item: tuple) -> None:
        """Incremental phase metrics from one raw task event."""
        t_wall, _t_mono, _cat, tid, event, attrs = item
        span = _SPAN_KEYS.get(event)
        if span is None and event not in TASK_TRANSITIONS:
            return
        transitions = self._open.get(tid)
        if transitions is None:
            if event == "SEALED" or tid in self._finalized_set:
                # Nothing to measure / already finalized: a late
                # submit-side span must not open a never-sealing orphan.
                return
            transitions = self._open[tid] = {}
            while len(self._open) > self._OPEN_CAP:
                self._open.popitem(last=False)
        sealed = False
        if span is not None:
            a = attrs or {}
            for key, name in span:
                if key in a:
                    transitions[name] = a[key]
                elif name in _SPAN_IMPLIED:
                    transitions.setdefault(name, t_wall)
            sealed = event == "EXEC_SPAN"
        else:
            transitions[event] = t_wall
            sealed = event == "SEALED"
        if sealed and tid not in self._sealed_set:
            # Linger instead of finalizing now: submit-side spans can
            # arrive after the seal (remote drivers flush lazily) and
            # must merge before the phase math runs.
            self._sealed_set.add(tid)
            self._sealed_pending.append((tid, time.monotonic()))

    def _finalize_sealed(self, force: bool = False) -> None:
        """Fold aged (or, with force, all) lingering sealed tasks into
        the phase histograms. Caller holds the lock."""
        cutoff = time.monotonic() - self._SEAL_LINGER_S
        while self._sealed_pending:
            tid, sealed_at = self._sealed_pending[0]
            if not force and sealed_at > cutoff:
                break
            self._sealed_pending.popleft()
            self._sealed_set.discard(tid)
            if len(self._finalized_recent) == self._finalized_recent.maxlen:
                self._finalized_set.discard(self._finalized_recent[0])
            self._finalized_recent.append(tid)
            self._finalized_set.add(tid)
            transitions = self._open.pop(tid, None)
            if not transitions:
                continue  # evicted by _OPEN_CAP: partial state lost
            for phase, dur in phase_durations(transitions):
                self.phase_counts[phase][
                    bisect_left(PHASE_BOUNDARIES, dur)
                ] += 1
                self.phase_sums[phase] += dur

    # ------------------------------------------------------------- reads

    def list(self, entity: Optional[str] = None,
             category: Optional[str] = None,
             job: Optional[str] = None,
             event: Optional[str] = None,
             limit: int = 1000) -> List[Dict[str, Any]]:
        if limit <= 0:
            # A negative slice below would invert into "everything".
            return []
        self.flush()
        with self._lock:
            jobs = (
                [job] if job is not None else list(self._by_job.keys())
            )
            out: List[Dict[str, Any]] = []
            for j in jobs:
                for blob, _n in self._by_job.get(j, ()):
                    for item in pickle.loads(blob):
                        if category is not None and item[2] != category:
                            continue
                        if entity is not None and item[3] != entity:
                            continue
                        for ev in _expand(item, j):
                            if entity is not None and ev["entity"] != entity:
                                continue
                            if event is not None and ev["event"] != event:
                                continue
                            ev["job"] = j
                            out.append(ev)
        out.sort(key=lambda e: e["timestamp"])
        # Newest events win the cap: the tail of a long run is what a
        # debugging session needs.
        return out[-limit:]

    def task_transitions(self, task_id_hex: str) -> List[Dict[str, Any]]:
        return self.list(entity=task_id_hex, category=TASK, limit=10_000)

    def summary(self) -> Dict[str, Any]:
        self.flush()
        with self._lock:
            return {
                "drops": dict(self.drops),
                "totals": dict(self.totals),
                "phase_boundaries": list(PHASE_BOUNDARIES),
                "phase_counts": {
                    p: list(c) for p, c in self.phase_counts.items()
                },
                "phase_sums": dict(self.phase_sums),
                "jobs": dict(self._job_counts),
            }


# ------------------------------------------------------------- stitching


def phase_durations(
    transitions: Dict[str, float]
) -> List[Tuple[str, float]]:
    """(phase, seconds) for each of the six phases from a task's
    transition timestamps. Missing boundaries collapse to the next
    known one (zero-width phase); boundaries are clamped monotonic so
    cross-process wall-clock skew can't produce negative phases."""
    bounds = _phase_boundaries(transitions)
    return [
        (TASK_PHASES[i], bounds[i + 1] - bounds[i])
        for i in range(len(TASK_PHASES))
    ]


def _phase_boundaries(transitions: Dict[str, float]) -> List[float]:
    """Seven monotone boundary timestamps for the six phases."""
    raw: List[Optional[float]] = [
        transitions.get(t) for t in TASK_TRANSITIONS
    ]
    # Back-fill missing boundaries from the next known one, then
    # forward-fill a missing tail from the last known.
    nxt: Optional[float] = None
    for i in range(len(raw) - 1, -1, -1):
        if raw[i] is None:
            raw[i] = nxt
        else:
            nxt = raw[i]
    prev = 0.0
    out: List[float] = []
    for v in raw:
        if v is None or v < prev:
            v = prev
        out.append(v)
        prev = v
    return out


def stitch_task_phases(
    events: List[Dict[str, Any]]
) -> Dict[str, List[Dict[str, Any]]]:
    """task_id -> six chrome-trace "X" slices (one row per task).

    Input: transition dicts as returned by ``EventAggregator.list``
    (category "task"). Output slices carry microsecond ts/dur and the
    phase name; rows render one-per-task in chrome://tracing with the
    six phases laid end to end."""
    by_task: Dict[str, Dict[str, float]] = {}
    extra: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("category") != TASK:
            continue
        tid = ev["entity"]
        t = by_task.setdefault(tid, {})
        name = ev["event"]
        if name in TASK_TRANSITIONS:
            # First occurrence wins (retries re-enter transitions; the
            # first pass is the stitched row).
            t.setdefault(name, ev["timestamp"])
            a = ev.get("attrs") or {}
            if a.get("worker"):
                extra.setdefault(tid, {})["worker"] = a["worker"]
    out: Dict[str, List[Dict[str, Any]]] = {}
    for tid, transitions in by_task.items():
        bounds = _phase_boundaries(transitions)
        slices = []
        for i, phase in enumerate(TASK_PHASES):
            slices.append(
                {
                    "name": phase,
                    "cat": "task_phase",
                    "ph": "X",
                    "ts": bounds[i] * 1e6,
                    "dur": (bounds[i + 1] - bounds[i]) * 1e6,
                    "pid": "tasks",
                    "tid": tid[:12],
                    "args": {
                        "task_id": tid,
                        "phase": phase,
                        **extra.get(tid, {}),
                    },
                }
            )
        out[tid] = slices
    return out
