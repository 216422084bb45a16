"""Handle-side router: assigns requests to replicas.

Reference: serve/_private/router.py (Router:312, assign_request:518) +
PowerOfTwoChoicesReplicaScheduler
(replica_scheduler/pow_2_scheduler.py:49): sample two candidate
replicas, pick the one with the lower queue length; rejection (replica
at max_ongoing_requests) triggers re-assignment with backoff.

The router keeps a local in-flight estimate per replica (incremented on
send, decremented on completion) so steady-state routing needs no probe
RPCs; the replica set itself arrives via long-poll from the controller.
"""
from __future__ import annotations

import asyncio
import random
import threading
import time
import uuid
from collections import defaultdict
from typing import Dict, List, Optional

from .common import (
    CONTROLLER_NAME,
    DeploymentID,
    LongPollKey,
    RequestMetadata,
    RunningReplicaInfo,
)
from .long_poll import LongPollClient
from .replica import RejectedError

ASSIGN_RETRY_BACKOFF_S = 0.025
METRICS_PUSH_INTERVAL_S = 0.5
# shutdown_routers() waits this long for each metrics thread to end.
ROUTER_JOIN_S = 5.0


class _ReplicaSet:
    def __init__(self):
        self.replicas: Dict[str, RunningReplicaInfo] = {}
        self.handles: Dict[str, object] = {}  # replica_id -> ActorHandle
        self.inflight: Dict[str, int] = defaultdict(int)
        self.changed = threading.Event()

    def update(self, infos: List[RunningReplicaInfo]):
        from ... import get_actor

        new = {}
        handles = {}
        for info in infos:
            new[info.replica_id] = info
            if info.replica_id in self.handles:
                handles[info.replica_id] = self.handles[info.replica_id]
            else:
                try:
                    handles[info.replica_id] = get_actor(info.actor_name)
                except ValueError:
                    continue
        self.replicas = new
        self.handles = handles
        # Drop drained counters for removed replicas so the estimate map
        # doesn't grow across redeployments. Replicas removed with
        # requests still in flight keep their count until it drains to 0
        # (deleting early would let the finally resurrect the key at -1).
        for rid in list(self.inflight):
            if rid not in new and self.inflight[rid] <= 0:
                del self.inflight[rid]
        self.changed.set()
        self.changed = threading.Event()


class PowerOfTwoChoicesReplicaScheduler:
    """Pick min-load of two random candidates; prefer replicas serving
    the request's multiplexed model id (reference pow_2_scheduler.py:49
    locality/multiplex ranking)."""

    def __init__(self, replica_set: _ReplicaSet):
        self._rs = replica_set

    def choose(self, meta: RequestMetadata) -> Optional[str]:
        rs = self._rs
        ids = list(rs.replicas)
        if not ids:
            return None
        if meta.multiplexed_model_id:
            owners = [
                rid
                for rid in ids
                if meta.multiplexed_model_id in rs.replicas[rid].multiplexed_model_ids
            ]
            if owners:
                ids = owners
        candidates = random.sample(ids, min(2, len(ids)))
        best = min(candidates, key=lambda rid: rs.inflight[rid])
        # Honor max_ongoing_requests with the local estimate; the replica
        # still enforces the hard cap via RejectedError.
        if rs.inflight[best] >= rs.replicas[best].max_ongoing_requests:
            return None
        return best


class Router:
    """One per (process, deployment). Owns a daemon asyncio loop so
    many requests are in flight concurrently."""

    def __init__(self, deployment_id: DeploymentID, controller_handle):
        self._dep_id = deployment_id
        self._controller = controller_handle
        self._replica_set = _ReplicaSet()
        self._scheduler = PowerOfTwoChoicesReplicaScheduler(self._replica_set)
        self._num_queued = 0
        self._queued_lock = threading.Lock()
        self._handle_id = uuid.uuid4().hex[:8]
        self._loop = asyncio.new_event_loop()
        threading.Thread(target=self._run_loop, daemon=True).start()
        self._long_poll = LongPollClient(
            controller_handle,
            {
                LongPollKey.running_replicas(deployment_id): self._replica_set.update,
            },
        )
        # Set by shutdown(): the metrics thread ends at once, and never
        # pushes to the controller of a Serve that was shut down.
        self._stopped = threading.Event()
        self._metrics_thread = threading.Thread(
            target=self._push_metrics_loop, daemon=True
        )
        self._metrics_thread.start()

    def _run_loop(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def shutdown(self):
        self._stopped.set()
        self._long_poll.stop()
        self._loop.call_soon_threadsafe(self._loop.stop)

    # ------------------------------------------------------------ public
    def assign_request(self, meta: RequestMetadata, args, kwargs):
        """Returns a concurrent.futures.Future with the final result
        (rejections retried transparently). Raises BackPressureError
        when max_queued_requests is exceeded (reference: router.py
        handle-side queue cap)."""
        # Count the request against the queue cap synchronously on the
        # caller thread — incrementing inside the coroutine would let a
        # burst of callers all pass the cap before the loop runs.
        with self._queued_lock:
            cap = self._max_queued()
            if cap >= 0 and self._num_queued >= cap:
                from ...exceptions import BackPressureError

                raise BackPressureError(
                    f"{self._dep_id}: {self._num_queued} queued requests "
                    f"(max_queued_requests={cap})"
                )
            self._num_queued += 1
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._assign_and_run(meta, args, kwargs), self._loop
            )
        except BaseException:
            with self._queued_lock:
                self._num_queued -= 1
            raise
        # Decrement on the future, not in the coroutine: a cancel before
        # the task's first step would skip the coroutine's finally.
        fut.add_done_callback(self._dec_queued)
        return fut

    def assign_request_streaming(self, meta: RequestMetadata, args, kwargs):
        """Streaming assignment: returns (async_value_generator, loop).
        The generator runs on the router loop and yields chunk VALUES;
        it carries the same admission semantics as the unary path — a
        replica that rejects (or dies) before producing anything is
        retried elsewhere, and the in-flight estimate covers the whole
        stream's lifetime (reference: router streaming calls ride the
        generator path with rejection retries)."""
        return self._stream_values(meta, args, kwargs), self._loop

    async def _stream_values(self, meta: RequestMetadata, args, kwargs):
        from .replica import RejectedError

        rs = self._replica_set
        args, kwargs = await _resolve_composed_args(args, kwargs)
        loop = asyncio.get_running_loop()
        while True:
            rid = self._scheduler.choose(meta)
            if rid is None:
                await asyncio.sleep(ASSIGN_RETRY_BACKOFF_S)
                continue
            handle = rs.handles.get(rid)
            if handle is None:
                await asyncio.sleep(ASSIGN_RETRY_BACKOFF_S)
                continue
            rs.inflight[rid] += 1
            yielded = False
            try:
                refgen = handle.handle_request_streaming.options(
                    num_returns="streaming"
                ).remote(meta, *args, **kwargs)
                async for ref in refgen:
                    value = await loop.run_in_executor(None, _get_one, ref)
                    yielded = True
                    yield value
                return
            except RejectedError:
                if yielded:
                    raise
                await asyncio.sleep(ASSIGN_RETRY_BACKOFF_S)
            except Exception as e:  # noqa: BLE001
                if yielded or not _is_actor_death(e):
                    raise
                rs.replicas.pop(rid, None)
                rs.handles.pop(rid, None)
            finally:
                rs.inflight[rid] -= 1

    def _dec_queued(self, _fut):
        with self._queued_lock:
            self._num_queued -= 1

    def _max_queued(self) -> int:
        for info in self._replica_set.replicas.values():
            return info.max_queued_requests
        return -1

    # ---------------------------------------------------------- internal
    async def _assign_and_run(self, meta: RequestMetadata, args, kwargs):
        rs = self._replica_set
        args, kwargs = await _resolve_composed_args(args, kwargs)
        while True:
            rid = self._scheduler.choose(meta)
            if rid is None:
                await asyncio.sleep(ASSIGN_RETRY_BACKOFF_S)
                continue
            handle = rs.handles.get(rid)
            if handle is None:
                await asyncio.sleep(ASSIGN_RETRY_BACKOFF_S)
                continue
            rs.inflight[rid] += 1
            try:
                ref = handle.handle_request.remote(meta, *args, **kwargs)
                return await ref
            except RejectedError:
                # Hard cap hit; try another replica.
                await asyncio.sleep(ASSIGN_RETRY_BACKOFF_S)
            except Exception as e:
                # Dead replica: drop it and retry until the controller
                # pushes a fresh set (reference: router retries on
                # ActorDiedError).
                if _is_actor_death(e):
                    rs.replicas.pop(rid, None)
                    rs.handles.pop(rid, None)
                    continue
                raise
            finally:
                rs.inflight[rid] -= 1

    def _push_metrics_loop(self):
        from ..._private.worker import is_initialized

        while not self._stopped.is_set():
            # Pushing through a dead session would auto-init a fresh
            # one — exit instead.
            if not is_initialized():
                return
            try:
                self._controller.record_handle_metrics.remote(
                    str(self._dep_id), self._handle_id, self._num_queued, time.time()
                )
            except Exception:  # noqa: BLE001
                pass
            self._stopped.wait(METRICS_PUSH_INTERVAL_S)


async def _resolve_composed_args(args, kwargs):
    """DeploymentResponses passed as arguments resolve on the router
    loop (never blocking the caller's thread — model composition,
    reference handle.py DeploymentResponse-to-ObjectRef conversion)."""
    import asyncio as _aio

    from ..handle import DeploymentResponse

    async def conv(v):
        if isinstance(v, DeploymentResponse):
            return await _aio.wrap_future(v._future)
        return v

    return (
        tuple([await conv(a) for a in args]),
        {k: await conv(v) for k, v in kwargs.items()},
    )


def _get_one(ref):
    import ray_tpu_torch

    return ray_tpu_torch.get(ref)


def _is_actor_death(e: BaseException) -> bool:
    from ...exceptions import ActorDiedError, ActorUnavailableError

    return isinstance(e, (ActorDiedError, ActorUnavailableError))


_routers: Dict[DeploymentID, Router] = {}
_routers_lock = threading.Lock()


def get_or_create_router(deployment_id: DeploymentID) -> Router:
    from ... import get_actor

    with _routers_lock:
        router = _routers.get(deployment_id)
        if router is None:
            router = Router(deployment_id, get_actor(CONTROLLER_NAME))
            _routers[deployment_id] = router
        return router


def shutdown_routers():
    with _routers_lock:
        routers = list(_routers.values())
        for r in routers:
            r.shutdown()
        _routers.clear()
    for r in routers:
        r._metrics_thread.join(timeout=ROUTER_JOIN_S)
