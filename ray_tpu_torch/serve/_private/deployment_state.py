"""Controller-side deployment reconciler.

Reference: serve/_private/deployment_state.py (DeploymentState:1226,
DeploymentReplica:211): each tick converges the live replica set toward
the target (count + version), performs health checks, and broadcasts
the running set to routers via the long-poll host.
"""
from __future__ import annotations

import hashlib
import pickle
import time
import uuid
from typing import Dict, List, Optional

from .common import (
    DeploymentID,
    DeploymentStatus,
    DeploymentStatusInfo,
    LongPollKey,
    ReplicaState,
    RunningReplicaInfo,
)


class DeploymentTarget:
    """Immutable desired state for one deployment."""

    def __init__(self, serialized_callable, init_args, init_kwargs, config):
        self.serialized_callable = serialized_callable
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.config = config
        # Code version: changing the callable or init args requires
        # replica replacement; user_config changes reconfigure in place
        # (reference: DeploymentVersion).
        self.code_version = hashlib.sha1(
            serialized_callable + pickle.dumps((init_args, init_kwargs))
        ).hexdigest()[:12]
        self.target_num_replicas = config.initial_target_replicas
        self.deleting = False


class _Replica:
    def __init__(self, replica_id, actor_name, handle, version, user_config_hash):
        self.replica_id = replica_id
        self.actor_name = actor_name
        self.handle = handle
        self.version = version
        self.user_config_hash = user_config_hash
        self.state = ReplicaState.STARTING
        self.start_ref = None
        self.started_at = time.monotonic()
        self.health_ref = None
        self.last_health_check = time.monotonic()
        self.shutdown_ref = None
        self.multiplexed_model_ids: tuple = ()


def _user_config_hash(config) -> str:
    try:
        return hashlib.sha1(pickle.dumps(config.user_config)).hexdigest()[:12]
    except Exception:  # noqa: BLE001 - unpicklable configs still work in-place
        return uuid.uuid4().hex[:12]


class DeploymentState:
    START_TIMEOUT_S = 60.0

    def __init__(self, dep_id: DeploymentID, long_poll_host):
        self._id = dep_id
        self._long_poll = long_poll_host
        self._target: Optional[DeploymentTarget] = None
        self._replicas: List[_Replica] = []
        self._status = DeploymentStatusInfo(DeploymentStatus.UPDATING)
        self._last_broadcast: Optional[list] = None
        self._message = ""
        self._consecutive_start_failures = 0

    # ------------------------------------------------------------ target
    def set_target(self, target: DeploymentTarget):
        self._target = target
        self._status = DeploymentStatusInfo(DeploymentStatus.UPDATING)
        # A redeploy gets a fresh chance: clear the crash-loop latch.
        self._consecutive_start_failures = 0

    def set_target_num_replicas(self, n: int):
        if self._target and not self._target.deleting:
            self._target.target_num_replicas = n

    def delete(self):
        if self._target:
            self._target.deleting = True
            self._target.target_num_replicas = 0

    @property
    def target_num_replicas(self) -> int:
        return self._target.target_num_replicas if self._target else 0

    @property
    def is_deleted(self) -> bool:
        return bool(
            self._target and self._target.deleting and not self._replicas
        )

    # ------------------------------------------------------------ update
    def update(self) -> None:
        if self._target is None:
            return
        self._check_starting_replicas()
        self._check_stopping_replicas()
        self._reconfigure_or_replace_outdated()
        self._scale_to_target()
        self._run_health_checks()
        self._broadcast_running_replicas()
        self._refresh_status()

    # -------------------------------------------------------- transitions
    def _running(self) -> List[_Replica]:
        return [r for r in self._replicas if r.state == ReplicaState.RUNNING]

    def _check_starting_replicas(self):
        from ... import wait

        for r in self._replicas:
            if r.state != ReplicaState.STARTING or r.start_ref is None:
                continue
            ready, _ = wait([r.start_ref], timeout=0)
            if ready:
                try:
                    from ... import get

                    get(r.start_ref)
                    r.state = ReplicaState.RUNNING
                    self._consecutive_start_failures = 0
                except Exception as e:  # noqa: BLE001 - constructor failed
                    self._message = f"replica constructor failed: {e!r}"
                    self._consecutive_start_failures += 1
                    self._stop_replica(r, graceful=False)
            elif time.monotonic() - r.started_at > self.START_TIMEOUT_S:
                self._message = "replica start timed out"
                self._consecutive_start_failures += 1
                self._stop_replica(r, graceful=False)

    def _check_stopping_replicas(self):
        from ... import kill, wait

        still = []
        for r in self._replicas:
            if r.state != ReplicaState.STOPPING:
                still.append(r)
                continue
            done = r.shutdown_ref is None
            if not done:
                ready, _ = wait([r.shutdown_ref], timeout=0)
                done = bool(ready)
            if done:
                try:
                    kill(r.handle)
                except Exception:  # noqa: BLE001
                    pass
            else:
                still.append(r)
        self._replicas = still

    def _reconfigure_or_replace_outdated(self):
        """Surge rollout: old-version replicas keep serving until the
        new version has target_num_replicas RUNNING, then stop — a code
        redeploy never hits a zero-replica window (a model can take
        seconds to load onto the card in the new replicas)."""
        t = self._target
        cfg_hash = _user_config_hash(t.config)
        old = [
            r
            for r in self._replicas
            if r.state != ReplicaState.STOPPING and r.version != t.code_version
        ]
        if old:
            new_running = [
                r
                for r in self._running()
                if r.version == t.code_version
            ]
            if len(new_running) >= t.target_num_replicas:
                for r in old:
                    self._stop_replica(r, graceful=True)
        for r in self._replicas:
            if (
                r.state == ReplicaState.RUNNING
                and r.version == t.code_version
                and r.user_config_hash != cfg_hash
            ):
                r.handle.reconfigure.remote(t.config.user_config)
                r.user_config_hash = cfg_hash

    def _scale_to_target(self):
        t = self._target
        # Only new-version replicas count toward the target; old ones
        # are surge capacity handled above.
        alive = [
            r
            for r in self._replicas
            if r.state != ReplicaState.STOPPING and r.version == t.code_version
        ]
        delta = t.target_num_replicas - len(alive)
        if delta > 0:
            if self._consecutive_start_failures >= self.MAX_START_FAILURES:
                return  # crash loop — stop burning workers
            for _ in range(delta):
                self._start_replica()
        elif delta < 0:
            # Prefer stopping not-yet-running replicas.
            victims = sorted(
                alive, key=lambda r: r.state == ReplicaState.RUNNING
            )[: -delta]
            for r in victims:
                self._stop_replica(r, graceful=True)

    def _start_replica(self):
        from ... import remote

        from .replica import ReplicaActor

        t = self._target
        replica_id = f"{self._id}#{uuid.uuid4().hex[:8]}"
        actor_name = f"{self._id.actor_prefix()}#{replica_id[-8:]}"
        actor_cls = remote(ReplicaActor).options(
            name=actor_name,
            max_concurrency=t.config.max_ongoing_requests + 8,
            **t.config.ray_actor_options,
        )
        handle = actor_cls.remote(
            self._id.name,
            self._id.app_name,
            replica_id,
            t.serialized_callable,
            t.init_args,
            t.init_kwargs,
            pickle.dumps(t.config),
        )
        r = _Replica(
            replica_id,
            actor_name,
            handle,
            t.code_version,
            _user_config_hash(t.config),
        )
        r.start_ref = handle.ensure_started.remote()
        self._replicas.append(r)

    def _stop_replica(self, r: _Replica, graceful: bool):
        from ... import kill

        if r.state == ReplicaState.STOPPING:
            return
        if graceful and r.state == ReplicaState.RUNNING:
            r.state = ReplicaState.STOPPING
            try:
                r.shutdown_ref = r.handle.prepare_for_shutdown.remote()
            except Exception:  # noqa: BLE001
                r.shutdown_ref = None
        else:
            r.state = ReplicaState.STOPPING
            r.shutdown_ref = None
            try:
                kill(r.handle)
            except Exception:  # noqa: BLE001
                pass

    def _run_health_checks(self):
        from ... import wait

        t = self._target
        period = t.config.health_check_period_s
        now = time.monotonic()
        for r in self._running():
            if r.health_ref is not None:
                ready, _ = wait([r.health_ref], timeout=0)
                if ready:
                    try:
                        from ... import get

                        get(r.health_ref)
                        r.last_health_check = now
                        r.health_ref = None
                    except Exception:  # noqa: BLE001 - unhealthy
                        self._message = f"replica {r.replica_id} failed health check"
                        self._stop_replica(r, graceful=False)
                elif now - r.last_health_check > t.config.health_check_timeout_s:
                    self._message = f"replica {r.replica_id} health check timed out"
                    self._stop_replica(r, graceful=False)
            elif now - r.last_health_check > period:
                try:
                    r.health_ref = r.handle.check_health.remote()
                except Exception:  # noqa: BLE001
                    self._stop_replica(r, graceful=False)

    def record_multiplexed_model_ids(self, replica_id: str, model_ids: tuple):
        """Pushed by the replica's multiplex wrapper on model load/evict;
        the next broadcast carries residency to routers."""
        for r in self._replicas:
            if r.replica_id == replica_id:
                r.multiplexed_model_ids = tuple(model_ids)

    # ---------------------------------------------------------- broadcast
    def _broadcast_running_replicas(self):
        t = self._target
        running = self._running()
        # Key includes model residency so multiplex updates re-broadcast.
        key = [(r.replica_id, r.multiplexed_model_ids) for r in running]
        if key == self._last_broadcast:
            return
        self._last_broadcast = key
        infos = [
            RunningReplicaInfo(
                replica_id=r.replica_id,
                deployment_id=self._id,
                actor_name=r.actor_name,
                max_ongoing_requests=t.config.max_ongoing_requests,
                multiplexed_model_ids=r.multiplexed_model_ids,
                max_queued_requests=t.config.max_queued_requests,
            )
            for r in running
        ]
        self._long_poll.notify_changed(
            {LongPollKey.running_replicas(self._id): infos}
        )

    MAX_START_FAILURES = 3

    def _refresh_status(self):
        n_running = len(self._running())
        target = self.target_num_replicas
        if self._consecutive_start_failures >= self.MAX_START_FAILURES:
            # Crash loop: stop retrying and surface DEPLOY_FAILED.
            self._status = DeploymentStatusInfo(
                DeploymentStatus.UNHEALTHY, self._message,
                num_replicas=n_running,
            )
            return
        if n_running == target and all(
            r.state == ReplicaState.RUNNING
            for r in self._replicas
        ):
            self._status = DeploymentStatusInfo(
                DeploymentStatus.HEALTHY, num_replicas=n_running
            )
        elif n_running < target:
            self._status = DeploymentStatusInfo(
                DeploymentStatus.UPDATING, self._message, num_replicas=n_running
            )
        else:
            self._status = DeploymentStatusInfo(
                DeploymentStatus.DOWNSCALING, num_replicas=n_running
            )

    @property
    def status_info(self) -> DeploymentStatusInfo:
        return self._status


class DeploymentStateManager:
    def __init__(self, long_poll_host):
        self._long_poll = long_poll_host
        self._states: Dict[DeploymentID, DeploymentState] = {}

    def deploy(self, dep_id: DeploymentID, target: DeploymentTarget):
        state = self._states.get(dep_id)
        if state is None:
            state = DeploymentState(dep_id, self._long_poll)
            self._states[dep_id] = state
        state.set_target(target)

    def delete(self, dep_id: DeploymentID):
        if dep_id in self._states:
            self._states[dep_id].delete()

    def get(self, dep_id: DeploymentID) -> Optional[DeploymentState]:
        return self._states.get(dep_id)

    def update(self):
        for dep_id in list(self._states):
            state = self._states[dep_id]
            state.update()
            if state.is_deleted:
                del self._states[dep_id]

    def statuses(self) -> Dict[DeploymentID, DeploymentStatusInfo]:
        return {d: s.status_info for d, s in self._states.items()}
