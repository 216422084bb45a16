"""Worker process: task execution loop.

Reference: the worker side of the core worker — HandlePushTask →
ExecuteTask (core_worker.cc:2889) and the Cython execute_task hot loop
(_raylet.pyx:1731): deserialize args, run the function, serialize
returns (small → inline, large → shm store), report completion.

One process per worker. Normal tasks run serially on the main thread.
An actor-creation task pins the process to that actor; subsequent method
calls run serially (ordered), on a thread pool when max_concurrency > 1,
or on an asyncio loop for coroutine methods (async actors execute
concurrently, as in the reference's fiber-based async actors —
transport/fiber.h).
"""
from __future__ import annotations

import asyncio
import inspect
import os
import queue
import sys
import threading
import time
import traceback


def _finite(value, default: float, cap: float, floor: float = 0.0) -> float:
    """Clamp an untrusted numeric knob to [floor, cap]; NaN/garbage
    falls back to the default (profiling knobs arrive from HTTP)."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return default
    if v != v:  # NaN
        return default
    return min(max(v, floor), cap)
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import cloudpickle

from . import chaos as _chaos
from . import events as _events
from . import serialization
from .client import CoreClient
from .config import RayConfig
from .ids import ActorID, TaskID, WorkerID
from .protocol import OP_CALL, OP_REPLY
from .task_spec import TaskSpec
from ..exceptions import RayActorError, RayTaskError
from ..object_ref import ObjectRef


def _spec_from_frame(frame) -> TaskSpec:
    """Materialize a shim TaskSpec from a compact OP_CALL frame.

    Hot-path calls ship (task_id, function_id, method, args_blob,
    num_returns, actor_id) instead of a pickled TaskSpec; everything
    else takes its default. __new__ + attribute stores skip the
    21-field dataclass __init__."""
    _, _req, tid, fid, method, args_blob, nret, aid = frame[:8]
    s = TaskSpec.__new__(TaskSpec)
    s.task_id = TaskID(tid)
    s.name = method or "task"
    s.function_id = fid
    s.function_blob = None
    s.args_blob = args_blob
    s.dependencies = []
    s.borrowed_refs = []
    s.num_returns = nret
    s.resources = {}
    s.actor_creation = False
    s.actor_id = ActorID(aid) if aid is not None else None
    s.method_name = method or ""
    s.max_restarts = 0
    s.max_retries = 0
    s.retry_exceptions = False
    s.max_concurrency = 1
    s.placement_group_id = None
    s.placement_group_bundle_index = -1
    s.scheduling_strategy = None
    s.actor_name = None
    s.lifetime = None
    s.runtime_env = None
    s.concurrency_groups = None
    s.concurrency_group = frame[8] if len(frame) > 8 else None
    return s


class _TaggedStream:
    """Prefix lines printed while a task executes with an \\x1e-framed
    task marker. The log monitor lifts the marker out of the line and
    into the worker tag (``<worker> task=<id>``), so the dashboard log
    viewer can correlate a log line to its timeline row without the
    visible line changing."""

    def __init__(self, base):
        self._base = base
        self._at_start = True
        # Concurrency groups / user threads share this stream; the
        # line-start bookkeeping must not interleave mid-write or a
        # marker lands mid-line, where the log monitor won't lift it.
        self._wlock = threading.Lock()

    def write(self, s):
        if not s:
            return 0
        tid = _events.current_task_context()
        with self._wlock:
            if tid is None:
                self._at_start = s.endswith("\n")
                return self._base.write(s)
            marker = "\x1et=" + tid + "\x1e"
            out = []
            for chunk in s.splitlines(keepends=True):
                if self._at_start:
                    out.append(marker)
                out.append(chunk)
                self._at_start = chunk.endswith("\n")
            self._base.write("".join(out))
        return len(s)

    def flush(self):
        self._base.flush()

    def __getattr__(self, name):
        return getattr(self._base, name)


class _DoneBatcher:
    """Coalesce direct-path task_done notifications to the GCS.

    Direct actor calls and leased tasks answer the caller on their own
    socket; the GCS only needs the completion for object-directory
    coherence (wait/free/refs from other processes). Sending one message
    per call makes the GCS — threads inside the driver process — pay an
    unpickle + handler under the driver's GIL at the aggregate call
    rate, which caps every concurrent benchmark. Batching trades a few
    ms of directory lag (invisible: callers resolve on the direct
    socket) for an order of magnitude less control-plane load
    (reference: the raylet batches task state events to the GCS,
    task_event_buffer.h).
    """

    _MAX_BATCH = 256
    _FLUSH_INTERVAL_S = 0.004
    #: At-least-once across head failover: unacked batches older than
    #: this resend (the head acks on receipt and dedups per conn).
    _RETRANSMIT_S = 1.0
    _RETRANSMIT_MAX = 20

    def __init__(self, client: CoreClient):
        self._client = client
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._items: list = []
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # seq -> [msg, sent_at, attempts]: every item-carrying batch is
        # numbered and retained until the head acks it. A head crash
        # between this worker answering its caller and the directory
        # hearing the completion would otherwise lose the seal forever
        # (the head's object soft state is rebuilt from bearers of
        # truth, and for completions this batcher IS the bearer).
        self._seq = 0
        self._unacked: "OrderedDict[int, list]" = OrderedDict()
        #: Client conn generation the current numbering belongs to. A
        #: fresh conn means a fresh head-side sequencer (start_seq=1),
        #: so EVERY send path must renumber before its first send on
        #: the new conn — checked inside flush() under the lock, not
        #: just in on_reconnect, or a completion flushed between the
        #: conn swap and the reconnect callback would ship a stale seq
        #: and poison the new sequencer's baseline.
        self._gen_seen = 0
        self.lost_batches = 0
        client.done_ack = self.ack

    def ack(self, seq: int) -> None:
        with self._lock:
            self._unacked.pop(seq, None)

    def _maybe_renumber_locked(self) -> None:
        """Caller holds self._lock. Renumber the unacked batches 1..k
        (original order) when the client moved to a new connection —
        the restarted head's per-conn sequencer numbers from 1 again;
        re-applying completions is idempotent head-side."""
        gen = getattr(self._client, "_conn_gen", 0)
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

    def on_reconnect(self) -> None:
        """Head restarted on a fresh conn: replay the unacked batches
        now (flush renumbers them for the new conn generation)."""
        self._wake.set()
        self.flush()

    def _retransmit_due(self) -> None:
        now = time.monotonic()
        resend = []
        with self._lock:
            for seq, rec in list(self._unacked.items()):
                if now - rec[1] < self._RETRANSMIT_S:
                    break  # OrderedDict: the rest are younger
                if rec[2] >= self._RETRANSMIT_MAX:
                    del self._unacked[seq]
                    self.lost_batches += 1  # counted, never silent
                    continue
                rec[1] = now
                rec[2] += 1
                resend.append(rec[0])
        if not resend:
            return
        from .protocol import ConnectionLost

        try:
            for m in resend:
                self._client.send(m)
        except ConnectionLost:
            pass  # still unacked; the reconnect replay re-sends

    def add(self, item: Dict[str, Any]) -> None:
        with self._lock:
            self._items.append(item)
            n = len(self._items)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="done-batcher", daemon=True
            )
            self._thread.start()
        if n == 1 or n >= self._MAX_BATCH:
            # First item arms the coalescing window; a full batch flushes
            # immediately. In-between adds ride the armed window free.
            self._wake.set()

    def flush(self) -> None:
        # _send_lock spans swap AND send: a barrier flush (flush_events
        # on the reader thread) that loses the swap race to the _loop
        # thread must not ack until the in-flight task_done_batch is on
        # the wire, or the GCS would answer a listing before the batch
        # it was barriering on arrives.
        with self._send_lock:
            with self._lock:
                self._maybe_renumber_locked()
                items, self._items = self._items, []
                base = None
                if items:
                    self._seq += 1
                    base = {
                        "type": "task_done_batch",
                        "worker_id": self._client.worker_id.binary(),
                        "items": items,
                        "seq": self._seq,
                    }
                    # Retain the ack-tracked copy WITHOUT the event
                    # piggyback below: a retransmit must not double-
                    # ingest flight-recorder events head-side.
                    self._unacked[self._seq] = [base, time.monotonic(), 1]
            # Flight-recorder piggyback: the ring ships on the flush
            # that already exists instead of its own timer/message
            # (reference: task events batch with the state updates,
            # task_event_buffer.h).
            rec = _events.get_recorder()
            msg = dict(base) if base is not None else {
                "type": "task_done_batch",
                "worker_id": self._client.worker_id.binary(),
                "items": [],
            }
            ev_items, ev_dropped = rec.attach(msg)
            if base is None and not ev_items and not ev_dropped:
                self._retransmit_due()
                return
            if items:
                # Chaos: worker dies after answering its callers but
                # before the directory hears the completions — the
                # early-drop ledger / owner release paths must cope.
                _chaos.kill_point("worker.pre_task_done")
            from .protocol import ConnectionLost

            try:
                self._client.send(msg)
            except ConnectionLost:
                # The batch stays unacked (retransmitted after the
                # failover); only the piggybacked events are lost.
                rec.count_lost(ev_items, ev_dropped)
            self._retransmit_due()

    def _loop(self) -> None:
        # Park until work arrives — an idle worker must cost ZERO
        # wakeups (with hundreds of actors on a node, a per-worker
        # polling timer is itself the scale bottleneck: 150 actors x
        # 250 polls/s saturated a core before any real work ran).
        # With unacked batches outstanding the park is bounded so
        # retransmits run even when no new completions arrive.
        while True:
            self._wake.wait(
                self._RETRANSMIT_S / 2 if self._unacked else None
            )
            client = self._client
            if client.conn.closed:
                if not client.conn_failover_pending():
                    return
                # Head outage: hold everything; the reconnect replay
                # (on_reconnect) flushes the moment the new conn lands.
                time.sleep(0.1)
                continue
            # Coalescing window: let the burst in flight accumulate
            # into one task_done_batch message.
            time.sleep(self._FLUSH_INTERVAL_S)
            self._wake.clear()
            self.flush()


class WorkerRuntime:
    def __init__(self, client: CoreClient, task_queue):
        # task_queue holds (spec, origin); origin None = GCS-routed,
        # (peer, req_id) = direct call to answer on that connection
        # (reference: direct actor transport bypassing raylet+GCS,
        # transport/direct_actor_task_submitter.h).
        self.client = client
        self.task_queue = task_queue
        self.fn_cache: Dict[bytes, Any] = {}
        # aid -> instance. One entry for a dedicated actor worker; many
        # for a shared host packing sub-core actors (the GCS routes
        # packable creations here — gcs._packable). Each actor gets its
        # own execution lock so co-hosted actors stay mutually
        # concurrent (and same-host nested calls can't deadlock) while
        # each actor alone stays serial.
        self.actors: Dict[bytes, Any] = {}
        self._actor_locks: Dict[bytes, threading.RLock] = {}
        # Set when a creation arrives marked packed: shared hosts stay
        # alive when their last actor exits (the GCS re-pools them).
        self._shared_host = False
        self.max_concurrency = 1
        self._pool: Optional[ThreadPoolExecutor] = None
        self._group_pools: Dict[str, ThreadPoolExecutor] = {}
        self._method_group: Dict[str, str] = {}
        self._group_sems: Dict[str, Any] = {}  # async actors
        self._aio_loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_lock = threading.Lock()
        self._done = threading.Event()
        self._done_batcher = _DoneBatcher(client)
        self._wid_hex = client.worker_id.hex()
        # Head-failover reconciliation state (bearers of truth): tasks
        # currently executing in this process (task_id -> return oids;
        # the oids let a restarted head protect in-flight LEASED/direct
        # tasks' returns — which it has no spec for — from the
        # lost-producer sweep) and a bounded ledger of store-backed
        # results this worker sealed (oid -> location) — both
        # re-reported to a restarted head so it can rebuild its
        # non-durable inflight/location tables.
        self._executing: Dict[bytes, tuple] = {}
        self._sealed_locs: "OrderedDict[bytes, str]" = OrderedDict()
        # Hedge-loser cancellation (gray-failure tolerance): task ids
        # the head told us lost their speculative race. The done report
        # for a cancelled task skips value sealing — no pool bytes are
        # committed for results the head will reject anyway.
        self._cancelled: set = set()
        # Serializes execution across the main loop (GCS-routed tasks)
        # and direct-conn reader threads (inline fast calls): serial
        # workers run exactly one task at a time no matter which path
        # delivered it.
        self._exec_lock = threading.RLock()

    def _actor_for(self, aid: Optional[bytes]):
        inst = self.actors.get(aid) if aid is not None else None
        if inst is None:
            raise RayActorError(
                "actor is gone: killed, exited, or never created on this "
                "worker"
            )
        return inst

    def _lock_for(self, aid: Optional[bytes]):
        """Per-actor serial execution; everything else (plain tasks,
        creations) serializes on the worker-wide lock."""
        if aid is not None:
            lk = self._actor_locks.get(aid)
            if lk is not None:
                return lk
        return self._exec_lock

    def handle_fast_call(self, frame, peer) -> None:
        """An OP_CALL frame from a direct connection.

        Serial workloads execute inline on the reader thread — no queue
        handoff, no extra thread wakeup; the reply buffers on the same
        connection and flushes when the input goes quiet. Concurrent and
        async actors keep their pool/event-loop dispatch."""
        req_id = frame[1]
        method_name = frame[4]
        _inst = self.actors.get(frame[7]) if frame[7] is not None else None
        if _inst is not None:
            method = getattr(_inst, method_name, None)
            if method is not None and asyncio.iscoroutinefunction(method):
                self._submit_async(_spec_from_frame(frame), (peer, req_id, False))
                return
            try:
                pool = self._pool_for(
                    method_name, frame[8] if len(frame) > 8 else None
                )
            except ValueError as e:
                self._report_done(
                    _spec_from_frame(frame), None, e, (peer, req_id, False)
                )
                return
            if pool is not None:
                pool.submit(
                    self._execute, _spec_from_frame(frame), (peer, req_id, False)
                )
                return
        if method_name in ("__ray_terminate__", "__ray_apply__"):
            spec = _spec_from_frame(frame)
            with self._lock_for(frame[7]):
                # lazy reply: the reader thread flushes once input drains.
                self._execute(spec, (peer, req_id, True))
            return
        from ..util import tracing

        if tracing.enabled():
            spec = _spec_from_frame(frame)
            with self._lock_for(frame[7]):
                self._execute(spec, (peer, req_id, True))
            return
        self._execute_inline(frame, peer)

    _SEALED_LEDGER_CAP = 8192

    def _note_sealed(self, oid: bytes, loc: str) -> None:
        """Remember where a store-backed result lives (failover
        reconcile re-reports it; bounded FIFO)."""
        led = self._sealed_locs
        led[oid] = loc
        while len(led) > self._SEALED_LEDGER_CAP:
            led.popitem(last=False)

    def _execute_inline(self, frame, peer) -> None:
        """Lean serial executor for OP_CALL frames: no shim TaskSpec, one
        results pass building both the reply tuples and the (batched)
        task_done record. The generic path handles everything this
        declines (async/pool actors, terminate, apply, tracing)."""
        from .submit import _EMPTY_ARGS_BLOB
        from ..object_ref import _CaptureRefs

        _, req_id, tid, fid, method, args_blob, nret, aid = frame[:8]
        name = method or "task"
        _rec = _events.get_recorder()
        t_fork = time.time() if _rec.enabled else 0.0
        t_start = 0.0
        tid_hex = tid.hex()
        self._executing[tid] = tuple(
            tid[:12] + i.to_bytes(4, "little") for i in range(nret)
        )
        with self._lock_for(aid):
            _events.set_task_context(tid_hex)
            try:
                if aid is not None:
                    fn = getattr(self._actor_for(aid), method)
                else:
                    fn = self.fn_cache.get(fid)
                    if fn is None:
                        blob = self.client.fetch_function(fid)
                        fn = cloudpickle.loads(blob)
                        self.fn_cache[fid] = fn
                    name = getattr(fn, "__name__", "task")
                t_start = time.time()
                if args_blob == _EMPTY_ARGS_BLOB:
                    value = fn()
                else:
                    args, kwargs = serialization.unpack(args_blob)
                    args = [
                        self.client.get([a])[0] if isinstance(a, ObjectRef) else a
                        for a in args
                    ]
                    kwargs = {
                        k: self.client.get([v])[0] if isinstance(v, ObjectRef) else v
                        for k, v in kwargs.items()
                    }
                    value = fn(*args, **kwargs)
                exc = None
            except BaseException as e:  # noqa: BLE001
                value, exc = None, e
            finally:
                _events.set_task_context(None)
        t_end = time.time() if _rec.enabled else 0.0
        error_blob = None
        tuple_results = None
        dict_results = []
        if exc is not None:
            if not isinstance(exc, (RayTaskError, RayActorError)):
                exc = RayTaskError.from_exception(name, exc)
            try:
                error_blob = serialization.pack(exc)
            except Exception:
                error_blob = serialization.pack(
                    RayTaskError(name, exc.traceback_str)
                )
            dict_results = [
                {"object_id": tid[:12] + i.to_bytes(4, "little")}
                for i in range(nret)
            ]
        else:
            values = list(value) if nret > 1 else [value]
            if nret > 1 and len(values) != nret:
                error_blob = serialization.pack(
                    RayTaskError(
                        name,
                        f"task declared num_returns={nret} but "
                        f"returned {len(values)} values",
                    )
                )
                dict_results = [
                    {"object_id": tid[:12] + i.to_bytes(4, "little")}
                    for i in range(nret)
                ]
            else:
                tuple_results = []
                for i, v in enumerate(values):
                    d = self._seal_value(tid[:12] + i.to_bytes(4, "little"), v)
                    tuple_results.append(
                        (
                            d.get("inline"),
                            d.get("segment"),
                            d.get("size", 0),
                            # () not None: None used to push the whole
                            # reply onto the pickle fallback (fastpath
                            # enc_reply rejected it).
                            d.get("children") or (),
                        )
                    )
                    dict_results.append(d)
        from .protocol import ConnectionLost

        try:
            peer.send_lazy((OP_REPLY, req_id, error_blob, tuple_results))
        except ConnectionLost:
            pass
        self._done_batcher.add(
            {
                "task_id": tid,
                "name": name,
                "results": dict_results,
                "error": error_blob,
                # The head never dispatched this call: the start it
                # records for the task is this one.
                "t_start": t_start or t_fork,
            }
        )
        self._executing.pop(tid, None)
        # t_fork truthy too: recording may have been toggled on
        # mid-execution, and a half-captured span (0.0 boundaries)
        # would poison the phase histograms with epoch-sized phases.
        if _rec.enabled and t_fork:
            # One append carrying all four execution boundaries; the
            # head expands it into FORKED/EXEC_START/EXEC_END/SEALED.
            attrs = {
                "t_fork": t_fork,
                "t_start": t_start or t_fork,
                "t_end": t_end,
                "t_seal": time.time(),
                "worker": self._wid_hex,
            }
            if error_blob is not None:
                attrs["error"] = True
            _rec.record(_events.TASK, tid_hex, "EXEC_SPAN", attrs)

    # -------------------------------------------------------------- resolve

    def _resolve_function(self, spec: TaskSpec) -> Any:
        fn = self.fn_cache.get(spec.function_id)
        if fn is None:
            blob = spec.function_blob or self.client.fetch_function(spec.function_id)
            fn = cloudpickle.loads(blob)
            self.fn_cache[spec.function_id] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec):
        from .object_plane import pull_manager as _pullm
        from .submit import _EMPTY_ARGS_BLOB

        if spec.args_blob == _EMPTY_ARGS_BLOB:
            return [], {}
        args, kwargs = serialization.unpack(spec.args_blob)
        # Top-level ObjectRefs are resolved to values; nested refs pass
        # through as refs (the reference's borrowing semantics). Pulls
        # these gets trigger ride the task-args admission class —
        # user-facing ray.get pulls activate ahead of them
        # (pull_manager.h priority order).
        with _pullm.pull_class(_pullm.PULL_TASK_ARGS):
            args = [
                self.client.get([a])[0] if isinstance(a, ObjectRef) else a
                for a in args
            ]
            kwargs = {
                k: self.client.get([v])[0] if isinstance(v, ObjectRef) else v
                for k, v in kwargs.items()
            }
        return args, kwargs

    # -------------------------------------------------------------- execute

    def _run_user_code(self, spec: TaskSpec):
        from . import runtime_env as _re

        if spec.actor_creation:
            # Actor runtime envs activate for the actor's whole life
            # (the env stack is entered and never popped; the worker is
            # dedicated to this actor from here on). Entered BEFORE
            # deserialization so code shipped via py_modules/working_dir
            # resolves (functions pickled by reference need sys.path).
            if spec.runtime_env:
                self._actor_env = _re.activate(spec.runtime_env, self.client)
                self._actor_env.__enter__()
            args, kwargs = self._resolve_args(spec)
            cls = self._resolve_function(spec)
            aid_b = spec.actor_id.binary()
            self.actors[aid_b] = cls(*args, **kwargs)
            self._actor_locks[aid_b] = threading.RLock()
            if getattr(spec, "packed_host", False):
                self._shared_host = True
            self.max_concurrency = spec.max_concurrency
            if spec.concurrency_groups:
                # Named concurrency groups (reference:
                # concurrency_group_manager.h): one bounded executor per
                # group + a default executor; methods bind to groups via
                # @ray_tpu_torch.method(concurrency_group=...) on the class or
                # per-call .options(concurrency_group=...).
                self._group_limits = dict(spec.concurrency_groups)
                self._group_pools = {
                    g: ThreadPoolExecutor(
                        max_workers=max(1, int(limit)),
                        thread_name_prefix=f"cg-{g}",
                    )
                    for g, limit in spec.concurrency_groups.items()
                }
                self._pool = ThreadPoolExecutor(
                    max_workers=max(1, self.max_concurrency),
                    thread_name_prefix="cg-default",
                )
                self._method_group = {}
                for mname in dir(cls):
                    m = getattr(cls, mname, None)
                    g = getattr(m, "__ray_method_options__", {}).get(
                        "concurrency_group"
                    ) if m is not None else None
                    if g is not None:
                        if g not in self._group_pools:
                            raise ValueError(
                                f"method {mname!r} names undeclared "
                                f"concurrency group {g!r}"
                            )
                        self._method_group[mname] = g
            elif self.max_concurrency > 1:
                self._pool = ThreadPoolExecutor(max_workers=self.max_concurrency)
            return None
        if spec.actor_id is not None:
            if spec.method_name == "__ray_terminate__":
                # Ordering: completions queued behind us must reach the
                # GCS before the exit notice tears down worker state.
                aid_b = spec.actor_id.binary()
                self.actors.pop(aid_b, None)
                self._actor_locks.pop(aid_b, None)
                self._done_batcher.flush()
                self.client.send(
                    {"type": "actor_exit", "actor_id": aid_b}
                )
                if not self._shared_host:
                    # Dedicated actor worker: process dies with its
                    # actor. Shared hosts outlive any one actor — the
                    # GCS re-pools an empty host.
                    self._done.set()
                    self.task_queue.put((None, None))
                return None
            args, kwargs = self._resolve_args(spec)
            if spec.method_name == "__ray_apply__":
                # Apply a shipped function to the actor instance
                # (compiled-graph loops, introspection) — the function
                # runs with actor state but isn't a class method.
                fn = cloudpickle.loads(args[0])
                return fn(
                    self._actor_for(spec.actor_id.binary()),
                    *args[1:], **kwargs,
                )
            method = getattr(
                self._actor_for(spec.actor_id.binary()), spec.method_name
            )
            from ..util import tracing

            if tracing.enabled():
                # Actor-method span, parented to the actor's creation
                # context (per-call caller context isn't carried).
                ctx = tracing.new_context(spec.name)
                t0 = time.time()
                result = method(*args, **kwargs)
                tracing.record_span(spec.name, t0, time.time(), ctx)
                return result
            return method(*args, **kwargs)
        if spec.runtime_env:
            with _re.activate(spec.runtime_env, self.client):
                args, kwargs = self._resolve_args(spec)
                fn = self._resolve_function(spec)
                from ..util import tracing

                if tracing.enabled():
                    t0 = time.time()
                    result = fn(*args, **kwargs)
                    tracing.record_span(
                        spec.name, t0, time.time(), tracing.current_context()
                    )
                    return result
                return fn(*args, **kwargs)
        args, kwargs = self._resolve_args(spec)
        fn = self._resolve_function(spec)
        if spec.name == "task":
            # Shim spec from a compact frame: recover the real name for
            # task events now that the function is resolved.
            spec.name = getattr(fn, "__name__", "task")
        return fn(*args, **kwargs)

    def _start_aio_loop(self) -> None:
        """The actor's one event loop, started on first use. Calls arrive
        on several dispatch threads at once; without the lock two of them
        could each start a loop, and an asyncio object made on one loop
        (an Event shared by the calls of a collective round) would then
        be awaited from the other."""
        with self._aio_lock:
            if self._aio_loop is None:
                self._aio_loop = asyncio.new_event_loop()
                threading.Thread(
                    target=self._aio_loop.run_forever, name="actor-aio", daemon=True
                ).start()

    def _submit_stream_async(self, spec: TaskSpec, origin=None):
        """Streaming call on an async-generator method: drive it as a
        task on the actor's event loop so the dispatch thread stays
        free (concurrent streams + ordinary async calls overlap, like
        any other async-actor method)."""
        self._start_aio_loop()
        tid = spec.task_id.binary()
        wid = self.client.worker_id.binary()

        async def stream_runner():
            idx = 0
            exc = None
            try:
                # Resolve inside the coroutine: a failed dependency must
                # fail this call, not the dispatch thread.
                args, kwargs = self._resolve_args(spec)
                method = getattr(
                    self._actor_for(spec.actor_id.binary()), spec.method_name
                )
                async for item in method(*args, **kwargs):
                    fields = self._seal_value(
                        tid[:12] + idx.to_bytes(4, "little"), item
                    )
                    self.client.send(
                        {
                            "type": "stream_item",
                            "worker_id": wid,
                            "task_id": tid,
                            "index": idx,
                            "result": fields,
                        }
                    )
                    idx += 1
            except BaseException as e:  # noqa: BLE001
                exc = e
            error_blob = None
            if exc is not None:
                e2 = exc if isinstance(
                    exc, (RayTaskError, RayActorError)
                ) else RayTaskError.from_exception(spec.name, exc)
                try:
                    error_blob = serialization.pack(e2)
                except Exception:
                    error_blob = serialization.pack(
                        RayTaskError(spec.name, e2.traceback_str)
                    )
            # Batcher, not a raw send: the stream close must survive a
            # head outage (and never raise into the event loop).
            self._done_batcher.add(
                {
                    "task_id": tid,
                    "name": spec.name,
                    "results": [],
                    "error": error_blob,
                    "streaming_total": idx,
                }
            )
            self._done_batcher.flush()

        asyncio.run_coroutine_threadsafe(stream_runner(), self._aio_loop)

    def _pool_for(self, method_name: str, explicit: Optional[str] = None):
        """The executor a threaded actor method runs on: its declared
        (or per-call) concurrency group's pool, else the default. An
        explicit per-call group that was never declared is an error —
        silently falling back would drop the intended limit."""
        if self._group_pools:
            g = explicit or self._method_group.get(method_name)
            if g is not None:
                pool = self._group_pools.get(g)
                if pool is None:
                    raise ValueError(
                        f"concurrency group {g!r} not declared on this "
                        f"actor (declared: {sorted(self._group_pools)})"
                    )
                return pool
        elif explicit is not None:
            raise ValueError(
                f"concurrency group {explicit!r}: actor has no "
                "concurrency_groups"
            )
        return self._pool

    def _submit_async(self, spec: TaskSpec, origin=None):
        """Run a coroutine method on the actor's event loop without blocking
        the dispatch thread — async actor calls execute concurrently
        (reference: fiber-based async actors, transport/fiber.h:17).
        Concurrency groups bound by asyncio.Semaphore per group."""
        self._start_aio_loop()
        group = spec.concurrency_group or self._method_group.get(
            spec.method_name
        )
        limits = self._group_limits if hasattr(self, "_group_limits") else {}

        async def runner():
            args, kwargs = self._resolve_args(spec)
            method = getattr(
                self._actor_for(spec.actor_id.binary()), spec.method_name
            )
            if group is not None and group in limits:
                sem = self._group_sems.get(group)
                if sem is None:
                    sem = self._group_sems[group] = asyncio.Semaphore(
                        max(1, int(limits[group]))
                    )
                async with sem:
                    return await method(*args, **kwargs)
            return await method(*args, **kwargs)

        t_start = time.time()
        fut = asyncio.run_coroutine_threadsafe(runner(), self._aio_loop)
        fut.add_done_callback(
            lambda f: self._finish_async(spec, f, origin, t_start)
        )

    def _finish_async(self, spec: TaskSpec, fut, origin=None,
                      t_start: float = 0.0):
        exc = fut.exception()
        value = None if exc is not None else fut.result()
        self._report_done(spec, value, exc, origin, t_start=t_start)

    def _seal_value(self, oid_bytes: bytes, value: Any) -> Dict[str, Any]:
        """Serialize one return value into result fields (inline payload
        or a sealed store segment), capturing nested refs as children."""
        from ..object_ref import _CaptureRefs

        d: Dict[str, Any] = {"object_id": oid_bytes}
        with _CaptureRefs() as cap:
            payload, buffers = serialization.dumps(value)
        if cap.seen:
            d["children"] = cap.seen
        size = serialization.serialized_size(payload, buffers)
        if size <= RayConfig.max_inline_object_size:
            blob = bytearray(size)
            serialization.write_to(memoryview(blob), payload, buffers)
            d["inline"] = bytes(blob)
            d["size"] = size
        else:
            from .client import object_segment_put
            from .ids import ObjectID as _OID

            d["segment"] = object_segment_put(
                self.client.store, _OID(oid_bytes), payload, buffers, size
            )
            d["size"] = size
            self._note_sealed(oid_bytes, d["segment"])
        return d

    def _stream_results(self, spec: TaskSpec, value: Any, origin=None,
                        exc: Optional[BaseException] = None):
        """Drive a streaming task (num_returns=-1): seal every yield as
        its own object, report it incrementally, then close the stream
        with the final count in task_done (reference: streaming-
        generator reporting, _raylet.pyx:1289). A pre-existing ``exc``
        (failure before iteration) skips straight to the error close."""
        tid = spec.task_id.binary()
        wid = self.client.worker_id.binary()
        idx = 0
        try:
            if exc is not None:
                raise exc
            if hasattr(value, "__aiter__"):
                it = self._drain_async_gen(value)
            elif hasattr(value, "__next__"):
                it = value
            else:
                it = iter([value])
            for item in it:
                fields = self._seal_value(
                    tid[:12] + idx.to_bytes(4, "little"), item
                )
                self.client.send(
                    {
                        "type": "stream_item",
                        "worker_id": wid,
                        "task_id": tid,
                        "index": idx,
                        "result": fields,
                    }
                )
                idx += 1
        except BaseException as e:  # noqa: BLE001
            exc = e
        error_blob = None
        if exc is not None:
            if not isinstance(exc, (RayTaskError, RayActorError)):
                exc = RayTaskError.from_exception(spec.name, exc)
            try:
                error_blob = serialization.pack(exc)
            except Exception:
                error_blob = serialization.pack(
                    RayTaskError(spec.name, exc.traceback_str)
                )
        # Batcher, not a raw send: the stream close must survive a head
        # outage (and never raise out of the execution loop).
        self._done_batcher.add(
            {
                "task_id": tid,
                "name": spec.name,
                "results": [],
                "error": error_blob,
                "streaming_total": idx,
            }
        )
        self._done_batcher.flush()
        if origin is not None:
            peer, req_id, lazy = origin
            from .protocol import ConnectionLost

            try:
                peer.send((OP_REPLY, req_id, error_blob, []))
            except ConnectionLost:
                pass

    def _drain_async_gen(self, agen):
        """Iterate an async generator from sync code on a private loop
        (streaming methods on async actors)."""
        self._start_aio_loop()
        while True:
            fut = asyncio.run_coroutine_threadsafe(
                agen.__anext__(), self._aio_loop
            )
            try:
                yield fut.result()
            except StopAsyncIteration:
                return

    def _report_done(self, spec: TaskSpec, value: Any,
                     exc: Optional[BaseException], origin=None,
                     t_start: float = 0.0):
        return_ids = spec.return_object_ids()
        results = [{"object_id": oid.binary()} for oid in return_ids]
        error_blob = None
        cancelled = spec.task_id.binary() in self._cancelled
        if cancelled and exc is None:
            # Hedge loser (head sent cancel_task mid-execution): the
            # winning twin's results are already durable in its done
            # batcher, so sealing ours would only commit pool bytes
            # the head must reject. Report a flagged done instead —
            # the lease comes home, nothing touches the directory.
            pass
        elif exc is not None:
            if not isinstance(exc, (RayTaskError, RayActorError)):
                exc = RayTaskError.from_exception(spec.name, exc)
            try:
                error_blob = serialization.pack(exc)
            except Exception:
                error_blob = serialization.pack(
                    RayTaskError(spec.name, exc.traceback_str)
                )
        else:
            values = (
                list(value)
                if spec.num_returns > 1
                else [value]
            )
            if spec.num_returns > 1 and len(values) != spec.num_returns:
                error_blob = serialization.pack(
                    RayTaskError(
                        spec.name,
                        f"task declared num_returns={spec.num_returns} but "
                        f"returned {len(values)} values",
                    )
                )
            else:
                from ..object_ref import _CaptureRefs

                for i, (oid, v) in enumerate(zip(return_ids, values)):
                    with _CaptureRefs() as cap:
                        payload, buffers = serialization.dumps(v)
                    if cap.seen:
                        results[i]["children"] = cap.seen
                    size = serialization.serialized_size(payload, buffers)
                    if size <= RayConfig.max_inline_object_size:
                        blob = bytearray(size)
                        serialization.write_to(memoryview(blob), payload, buffers)
                        results[i].update(inline=bytes(blob), size=size)
                    else:
                        from .client import object_segment_put

                        name = object_segment_put(
                            self.client.store, oid, payload, buffers, size
                        )
                        results[i].update(segment=name, size=size)
                        self._note_sealed(oid.binary(), name)
        if origin is not None:
            # Direct call: answer on the caller's connection with a
            # compact reply frame. Results ride inline; larger values
            # are sealed into the store and the caller reads them by
            # location. The GCS still gets a (batched) task_done so the
            # object directory stays coherent for refs shared with
            # other processes (wait/free/args).
            peer, req_id, lazy = origin
            from .protocol import ConnectionLost

            tuple_results = (
                None
                if error_blob is not None
                else [
                    (
                        r.get("inline"),
                        r.get("segment"),
                        r.get("size", 0),
                        r.get("children") or (),
                    )
                    for r in results
                ]
            )
            reply = (OP_REPLY, req_id, error_blob, tuple_results)
            if not spec.actor_creation:
                # Direct path: the GCS copy is directory bookkeeping and
                # can be coalesced — but it must be IN the batcher before
                # the caller can observe completion, or a flush barrier
                # (gcs._barrier_flush_events) taken right after the
                # caller's get() could flush an empty batcher and miss
                # this record.
                item = {
                    "task_id": spec.task_id.binary(),
                    "name": spec.name,
                    "results": results,
                    "error": error_blob,
                }
                if t_start:
                    # The head never dispatched this call: the start
                    # it records for the task is this one.
                    item["t_start"] = t_start
                self._done_batcher.add(item)
            try:
                if lazy:
                    peer.send_lazy(reply)
                else:
                    peer.send(reply)
            except ConnectionLost:
                pass
        if origin is not None and not spec.actor_creation:
            return
        item = {
            "task_id": spec.task_id.binary(),
            "name": spec.name,
            "results": results,
            "error": error_blob,
        }
        if getattr(spec, "actor_epoch", None) is not None:
            # Epoch fence (membership protocol): echo the incarnation
            # this call executed under so the head can reject a result
            # produced by a falsely-dead actor after its restart —
            # at-most-once across false death.
            item["actor_epoch"] = spec.actor_epoch
        if getattr(spec, "hedge_seq", None) is not None:
            # Hedge fence: echo which speculative twin produced this
            # result so the head adjudicates first-done-wins and
            # rejects the stale twin like a stale actor epoch.
            item["hedge_seq"] = spec.hedge_seq
        if cancelled:
            item["hedge_cancelled"] = True
        if getattr(spec, "grant_lat", None) is not None:
            item["grant_lat"] = spec.grant_lat
        pinned_refs = list(spec.dependencies) + list(
            getattr(spec, "borrowed_refs", None) or ()
        )
        if pinned_refs:
            # Borrow piggyback (object plane, reference: borrowed refs
            # ride the task reply — reference_count.h): dependency or
            # nested arg refs this process still holds outlive the
            # task's server-side pin; report them so the head converts
            # pin -> borrow edge with no unprotected window.
            # mark_advertised makes the eventual local drop send its
            # bdel.
            tracker = self.client._tracker
            held = {
                d.binary()
                for d in pinned_refs
                if tracker.holds(d.binary())
            }
            if held:
                for oid in held:
                    tracker.mark_advertised(oid)
                item["borrows"] = list(held)
        if origin is not None:
            item["direct"] = True
        if spec.actor_creation:
            item["actor_creation"] = True
            item["actor_id"] = spec.actor_id.binary()
        # Through the at-least-once batcher, like the direct path: a
        # raw send here would (a) LOSE the completion if the head is
        # mid-restart and (b) raise ConnectionLost out of the execution
        # loop — killing this worker (and its actor) on every head
        # outage a task completes inside. The batcher retains the
        # record until the (possibly restarted) head acks it. Eager
        # flush keeps the old wire latency: the submitter's get is
        # parked head-side on exactly this seal.
        self._done_batcher.add(item)
        self._done_batcher.flush()
        if _chaos._active is not None:
            # Chaos: named per-task kill point — "kill the owner
            # between SEAL and REF_FLUSH" targets exactly the task
            # whose returns this process now owns (the caller observed
            # completion; this process's authoritative refcounts die
            # unflushed). Guarded: the f-string must not run on the
            # per-task hot path when chaos is off.
            _chaos.kill_point(f"worker.post_exec.{spec.name}")

    def _execute(self, spec: TaskSpec, origin=None):
        _rec = _events.get_recorder()
        t_fork = time.time() if _rec.enabled else 0.0
        tid_b = spec.task_id.binary()
        self._executing[tid_b] = (
            tuple(o.binary() for o in spec.return_object_ids())
            if spec.num_returns > 0
            else ()
        )
        _events.set_task_context(spec.task_id.hex())
        t_exec0 = time.monotonic()
        t_start = time.time()
        try:
            value = self._run_user_code(spec)
            exc = None
        except BaseException as e:  # noqa: BLE001
            value, exc = None, e
        finally:
            _events.set_task_context(None)
        if _chaos._active is not None:
            # Chaos: slowexec stretch — a cpu-starved machine would
            # have taken factor x as long; the sleep (and the glob
            # match) live inside the chaos engine, off when inactive.
            _chaos.slowexec_stretch(
                spec.name, time.monotonic() - t_exec0,
                cancelled=lambda: (
                    spec.task_id.binary() in self._cancelled
                ),
            )
        if spec.num_returns == -1:
            # Failures before iteration (bad args, fetch error) must
            # still end the stream or consumers park forever.
            self._stream_results(spec, value, origin, exc=exc)
            self._executing.pop(tid_b, None)
            # The generator ran inside _stream_results: the execution
            # ends with the stream.
            t_end = time.time() if _rec.enabled else 0.0
        else:
            t_end = time.time() if _rec.enabled else 0.0
            self._report_done(spec, value, exc, origin, t_start=t_start)
            self._executing.pop(tid_b, None)
            self._cancelled.discard(tid_b)
        # t_fork truthy too: a mid-execution toggle-on must not ship a
        # half-captured span (0.0 boundaries poison the histograms).
        if _rec.enabled and t_fork:
            attrs = {
                "t_fork": t_fork,
                "t_start": t_fork,
                "t_end": t_end,
                "t_seal": time.time(),
                "worker": self._wid_hex,
            }
            if exc is not None:
                attrs["error"] = True
            _rec.record(
                _events.TASK, spec.task_id.hex(), "EXEC_SPAN", attrs
            )

    # ------------------------------------------------------------------- loop

    def run(self):
        while not self._done.is_set():
            spec, origin = self.task_queue.get()
            if spec is None:
                break
            is_actor_method = spec.actor_id is not None and not spec.actor_creation
            if is_actor_method and spec.method_name != "__ray_terminate__":
                method = getattr(
                    self.actors.get(spec.actor_id.binary()),
                    spec.method_name,
                    None,
                )
                if method is not None and asyncio.iscoroutinefunction(method):
                    self._submit_async(spec, origin)
                    continue
                if (
                    method is not None
                    and spec.num_returns == -1
                    and inspect.isasyncgenfunction(method)
                ):
                    # Async-generator stream: runs as a task on the
                    # actor's event loop; dispatch stays free.
                    self._submit_stream_async(spec, origin)
                    continue
                try:
                    pool = self._pool_for(
                        spec.method_name, spec.concurrency_group
                    )
                except ValueError as e:
                    self._report_done(spec, None, e, origin)
                    continue
                if pool is not None:
                    pool.submit(self._execute, spec, origin)
                    continue
            with self._lock_for(
                spec.actor_id.binary()
                if spec.actor_id is not None and not spec.actor_creation
                else None
            ):
                self._execute(spec, origin)


def main():
    # Lock-order witness opt-in (env-inherited from the test driver).
    from . import lock_witness

    lock_witness.maybe_install()
    address = os.environ["RAY_TPU_TORCH_SESSION_ADDR"]
    authkey = bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])
    worker_id = WorkerID.from_hex(os.environ["RAY_TPU_TORCH_WORKER_ID"])
    # Flight-recorder toggle state at spawn time. Read explicitly
    # rather than via RayConfig: zygote-forked workers inherit a
    # config initialized in the zygote parent BEFORE this env var
    # existed, and a worker spawned after `events --record off` must
    # not silently resume recording.
    _ev_env = os.environ.get("RAY_TPU_TORCH_events_enabled")
    if _ev_env is not None:
        _events.get_recorder().enabled = _ev_env.lower() in (
            "1", "true", "yes",
        )
    # Task-context log tagging (satellite of the flight recorder): user
    # prints gain an invisible marker the log monitor turns into a
    # worker tag suffix.
    sys.stdout = _TaggedStream(sys.stdout)
    sys.stderr = _TaggedStream(sys.stderr)

    # The queue exists before the connection: the GCS may push a task the
    # instant our hello registers, on the reader thread.
    task_queue: "queue.Queue" = queue.Queue()
    rt_holder: Dict[str, Any] = {}

    # raylint: dispatch-only
    def push(msg):
        t = msg["type"]
        def _send_stack_reply(token, text, **extra):
            def _send():
                try:
                    rt_holder["boot_client"].send(
                        {
                            "type": "stack_dump", "token": token,
                            "text": text, **extra,
                        }
                    )
                except Exception:  # noqa: BLE001 - reply is best-effort
                    pass

            if "boot_client" in rt_holder:
                _send()
                return

            # A dump can race CoreClient construction (the GCS learns
            # of this worker during the handshake). The wait for
            # main() to publish the client moves OFF the reader
            # thread: spinning here would stall execute_task delivery
            # for up to 2s (raylint no-blocking-on-dispatch).
            def _wait_and_send():
                deadline = time.monotonic() + 2.0
                while (
                    "boot_client" not in rt_holder
                    and time.monotonic() < deadline
                ):
                    time.sleep(0.01)
                if "boot_client" in rt_holder:
                    _send()

            threading.Thread(
                target=_wait_and_send, name="stack-dump-reply",
                daemon=True,
            ).start()

        if t == "execute_task":
            s = msg["spec"]
            if msg.get("packed"):
                # Creation routed to a shared actor host (gcs._packable):
                # the runtime packs the instance and the process outlives
                # any single actor.
                s.packed_host = True
            if msg.get("actor_epoch") is not None:
                # Rides the message, not the spec pickle (TaskSpec's
                # positional __reduce__ drops ad-hoc attrs): stamp it
                # back on so the done record can echo the epoch.
                s.actor_epoch = msg["actor_epoch"]
            if msg.get("hedge_seq") is not None:
                # Same message-rider pattern for the hedge fence: the
                # done record echoes which speculative twin ran.
                s.hedge_seq = msg["hedge_seq"]
            if msg.get("t_grant") is not None:
                # Health signal: how long the lease grant spent in
                # flight (a throttled link stretches this 10-100x).
                # Echoed in the done record for the head's scorer.
                s.grant_lat = max(0.0, time.time() - msg["t_grant"])
            task_queue.put((s, None))
        elif t == "cancel_task":
            # Hedge-loser cancellation: the head picked the other twin.
            # Python can't preempt user code mid-frame, so the mark
            # makes the eventual done report skip value sealing (no
            # pool bytes committed) and carry the cancelled flag; a
            # task that already finished has nothing to cancel.
            rt = rt_holder.get("rt")
            if rt is not None:
                tid = msg.get("task_id")
                if tid in rt._executing:
                    rt._cancelled.add(tid)
        elif t == "terminate_actor":
            # Force-kill of ONE packed actor on a shared host (the
            # process-level SIGKILL of a dedicated actor worker doesn't
            # apply — co-hosted actors must survive). Dropping the
            # instance makes in-flight and future calls fail fast.
            rt = rt_holder.get("rt")
            if rt is not None:
                aid = msg.get("actor_id")
                rt.actors.pop(aid, None)
                rt._actor_locks.pop(aid, None)
        elif t == "flush_events":
            # State-API read barrier (gcs._barrier_flush_events): push
            # any coalesced task_done records out NOW, then ack. Runs on
            # the GCS-conn reader thread so it works mid-user-code.
            rt = rt_holder.get("rt")
            if rt is not None:
                try:
                    rt._done_batcher.flush()
                except Exception:  # noqa: BLE001
                    pass
            bc = rt_holder.get("boot_client")
            if bc is not None:
                try:
                    bc.send(
                        {"type": "events_flushed", "token": msg.get("token")}
                    )
                except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- the flusher waits for its token with a timeout of its own
                    pass
        elif t == "set_events_recording":
            # Cluster-wide flight-recorder toggle (gcs broadcast).
            from . import events as _ev

            _ev.get_recorder().enabled = bool(msg.get("enabled", True))
        elif t == "dump_stacks":
            # Live profiling hook (reference: dashboard py-spy capture):
            # format every thread's stack right here on the reader
            # thread — works even when the main thread is stuck in user
            # code, which is exactly when you want a dump.
            import traceback as _tb

            frames = sys._current_frames()
            names = {th.ident: th.name for th in threading.enumerate()}
            parts = []
            for tid, frame in frames.items():
                parts.append(
                    f"--- thread {names.get(tid, '?')} ({tid}) ---\n"
                    + "".join(_tb.format_stack(frame))
                )
            _send_stack_reply(msg.get("token"), "".join(parts))
        elif t == "profile_stacks":
            # Statistical sampling profile (reference: the dashboard's
            # py-spy -f flamegraph capture — here in-process, no
            # ptrace): sample every thread's stack for `duration`
            # seconds on a dedicated thread and reply with collapsed
            # folded-stack lines ("a;b;c <count>"), the standard
            # flamegraph/speedscope input format.
            def _sample(token=msg.get("token"),
                        duration=_finite(msg.get("duration"), 5.0, 60.0),
                        interval=_finite(
                            msg.get("interval"), 0.01, 1.0, floor=0.001
                        )):
                me = threading.get_ident()
                counts: dict = {}
                t_end = time.monotonic() + duration
                n_samples = 0
                while time.monotonic() < t_end:
                    for tid, frame in sys._current_frames().items():
                        if tid == me:
                            continue
                        stack = []
                        f = frame
                        while f is not None:
                            c = f.f_code
                            stack.append(
                                f"{c.co_name} "
                                f"({os.path.basename(c.co_filename)}"
                                f":{f.f_lineno})"
                            )
                            f = f.f_back
                        key = ";".join(reversed(stack))
                        counts[key] = counts.get(key, 0) + 1
                    n_samples += 1
                    time.sleep(interval)
                folded = "\n".join(
                    f"{k} {v}"
                    for k, v in sorted(
                        counts.items(), key=lambda kv: -kv[1]
                    )
                )
                _send_stack_reply(token, folded, samples=n_samples)

            threading.Thread(
                target=_sample, name="profile-sampler", daemon=True
            ).start()
        elif t == "exit":
            task_queue.put((None, None))

    # Direct actor-call listener: callers connect here and push
    # execute_task without a GCS hop; replies carry results back on the
    # same connection (reference: actor calls gRPC straight to the actor
    # process, transport/direct_actor_task_submitter.h).
    from multiprocessing.connection import Listener

    from .protocol import PeerConn

    # Full hex: a truncated id is NOT unique for counter-suffixed ids
    # (ids.fast_unique_bytes shares its first 8 bytes process-wide).
    from .config import worker_socket

    direct_addr = worker_socket(worker_id.hex())
    try:
        os.unlink(direct_addr)
    except FileNotFoundError:
        pass
    # Token auth runs on each direct conn's reader thread; the accept
    # loop never blocks on a handshake.
    direct_listener = Listener(direct_addr, family="AF_UNIX", authkey=None)

    def direct_accept_loop():
        while True:
            try:
                conn = direct_listener.accept()
            except (OSError, EOFError):
                return
            except Exception:  # noqa: BLE001 - failed auth handshake etc.
                continue
            holder = {}

            def on_direct(msg, h=holder):
                if type(msg) is tuple:
                    if msg[0] == OP_CALL:
                        r = rt_holder.get("rt")
                        if r is not None:
                            r.handle_fast_call(msg, h["peer"])
                        else:
                            # Lease granted before the runtime finished
                            # wiring: run it through the main loop.
                            task_queue.put(
                                (
                                    _spec_from_frame(msg),
                                    (h["peer"], msg[1], False),
                                )
                            )
                elif msg.get("type") == "execute_task":
                    task_queue.put(
                        (msg["spec"], (h["peer"], msg["req_id"], False))
                    )

            from . import transport as _transport

            peer = PeerConn(
                conn, push_handler=on_direct, name="direct-serve",
                autostart=False,
                handshake=lambda c: _transport.server_handshake(c, authkey),
            )
            holder["peer"] = peer
            peer.start()

    threading.Thread(target=direct_accept_loop, daemon=True).start()

    _spawned_at = os.environ.get("RAY_TPU_TORCH_SPAWNED_AT")
    _t_pre_client = time.perf_counter()
    _prof = None
    if os.environ.get("RAY_TPU_TORCH_BOOT_PROFILE"):
        import cProfile

        _prof = cProfile.Profile()
        _prof.enable()
    client = CoreClient(
        address, authkey, role="worker", worker_id=worker_id,
        push_handler=push, direct_addr=direct_addr,
    )
    if _prof is not None:
        import io
        import pstats

        _prof.disable()
        s = io.StringIO()
        pstats.Stats(_prof, stream=s).sort_stats("cumulative").print_stats(15)
        print(s.getvalue())
    rt_holder["boot_client"] = client
    try:
        _events.record(
            _events.WORKER, worker_id.hex(), "BOOT",
            {
                "pid": os.getpid(),
                "spawned_at": float(_spawned_at) if _spawned_at else None,
            },
        )
    except (TypeError, ValueError):
        pass
    if _spawned_at and os.environ.get("RAY_TPU_TORCH_BOOT_TRACE"):
        # Boot latency: spawn request -> registered. The spawn path is
        # the actor-creation throughput ceiling; this line makes it
        # measurable from the worker logs.
        print(
            f"worker boot: {time.time() - float(_spawned_at):.3f}s total, "
            f"client {time.perf_counter() - _t_pre_client:.3f}s",
        )
    raylet_addr = os.environ.get("RAY_TPU_TORCH_LOCAL_RAYLET")
    if raylet_addr and os.environ.get("RAY_TPU_TORCH_LOCAL_ONLY"):
        # Report our direct socket to the owning raylet so it can lease
        # this worker to local clients (local dispatch authority).
        from . import transport as _transport

        try:
            rl = _transport.connect(raylet_addr, authkey)
            rl.send(
                {
                    "type": "worker_hello",
                    "worker_id": worker_id.binary(),
                    "direct_addr": direct_addr,
                }
            )
        except OSError:
            pass
    rt = WorkerRuntime(client, task_queue)
    rt_holder["rt"] = rt
    # State reads issued from inside a task flush our coalesced
    # task_done records first (the GCS flush barrier excludes the
    # requesting worker; see CoreClient.state_read).
    client.pre_state_read_flush = rt._done_batcher.flush

    # Head-failover reconciliation (reference: bearers of truth
    # re-report after NotifyGCSRestart). The reconnect hello carries
    # what this process authoritatively knows — hosted actors, tasks
    # mid-execution, and where its sealed results live — and the
    # post-reconnect callback replays the unacked done batches and
    # drops actor instances the restarted head refused to re-bind.
    def _reconcile_info():
        from .ids import ObjectID as _OID

        sealed = []
        for oid, loc in list(rt._sealed_locs.items()):
            if client.store.contains(_OID(oid)):
                sealed.append((oid, loc))
            else:
                rt._sealed_locs.pop(oid, None)  # evicted/freed: stale
        return {
            "actors": list(rt.actors.keys()),
            "shared_host": rt._shared_host,
            "executing": [
                (tid, list(oids))
                for tid, oids in list(rt._executing.items())
            ],
            "sealed": sealed,
        }

    def _on_reconnected(reply):
        for aid in reply.get("drop_actors") or ():
            rt.actors.pop(aid, None)
            rt._actor_locks.pop(aid, None)
        rt._done_batcher.on_reconnect()

    client.reconcile_info = _reconcile_info
    client.on_reconnected = _on_reconnected

    # Make the ray_tpu_torch API usable from inside tasks (nested submission).
    from . import worker as worker_api

    worker_api.connect_existing(client, mode="worker")

    # Exit when the GCS goes away for good. A closed conn alone is no
    # longer terminal — the client rides a head restart (reconnect with
    # backoff + re-registration); only a reconnect that exhausts its
    # budget (or an explicit close) sets head_permanently_lost.
    def watch_conn():
        # Block on the event — no polling (idle workers must cost zero
        # wakeups; see the many-actor scale stress).
        client.head_permanently_lost.wait()
        os._exit(0)

    threading.Thread(target=watch_conn, daemon=True).start()

    try:
        rt.run()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    sys.exit(0)


if __name__ == "__main__":
    main()
