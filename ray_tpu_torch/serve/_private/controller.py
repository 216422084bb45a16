"""ServeController actor: the Serve control plane.

Reference: serve/_private/controller.py (ServeController:86). One named
async actor owns the application/deployment/autoscaling state machines
and a LongPollHost; ``run_control_loop`` reconciles every tick.
"""
from __future__ import annotations

import asyncio
import pickle
from typing import Any, Dict, Optional

from .application_state import ApplicationStateManager
from .autoscaling_state import AutoscalingStateManager
from .common import DeploymentID
from .deployment_state import DeploymentStateManager, DeploymentTarget
from .long_poll import LongPollHost

CONTROL_LOOP_INTERVAL_S = 0.05


class ServeController:
    def __init__(self, http_options_blob: bytes = b""):
        self._long_poll = LongPollHost()
        self._dsm = DeploymentStateManager(self._long_poll)
        self._asm = ApplicationStateManager(self._dsm, self._long_poll)
        self._autoscaling = AutoscalingStateManager()
        self._http_options = (
            pickle.loads(http_options_blob) if http_options_blob else None
        )
        self._shutdown = False
        self._loop_started = False

    # ------------------------------------------------------------- loop
    async def run_control_loop(self) -> None:
        if self._loop_started:
            return
        self._loop_started = True
        while not self._shutdown:
            try:
                self._dsm.update()
                self._asm.update()
                self._apply_autoscaling()
            except Exception:  # noqa: BLE001 - the loop must survive
                import traceback

                traceback.print_exc()
            await asyncio.sleep(CONTROL_LOOP_INTERVAL_S)

    def _apply_autoscaling(self):
        for dep_id, state in list(self._dsm._states.items()):
            target = state._target
            if target is None or target.config.autoscaling_config is None:
                continue
            self._autoscaling.register(
                dep_id, target.config.autoscaling_config, state.target_num_replicas
            )
            decision = self._autoscaling.get_decision(dep_id)
            if decision is not None and decision != state.target_num_replicas:
                state.set_target_num_replicas(decision)

    # ------------------------------------------------------------ deploy
    async def deploy_application(
        self, name: str, route_prefix: Optional[str], ingress: str,
        deployments_blob: bytes,
    ) -> None:
        """deployments_blob: pickled list of dicts with keys
        name/serialized_callable/init_args/init_kwargs/config."""
        infos = pickle.loads(deployments_blob)
        names = [d["name"] for d in infos]
        self._asm.deploy(
            name, route_prefix, ingress, names,
            ingress_streaming=_ingress_is_streaming(infos, ingress),
        )
        for d in infos:
            dep_id = DeploymentID(d["name"], name)
            self._dsm.deploy(
                dep_id,
                DeploymentTarget(
                    d["serialized_callable"],
                    d["init_args"],
                    d["init_kwargs"],
                    d["config"],
                ),
            )
            if d["config"].autoscaling_config is not None:
                self._autoscaling.register(
                    dep_id,
                    d["config"].autoscaling_config,
                    d["config"].initial_target_replicas,
                )
            else:
                self._autoscaling.deregister(dep_id)

    async def delete_application(self, name: str) -> None:
        self._asm.delete(name)

    async def get_app_statuses(self) -> Dict[str, Any]:
        return self._asm.statuses()

    async def get_app_info(self, name: str):
        app = self._asm.get_app(name)
        if app is None:
            return None
        return {
            "ingress": app.ingress,
            "route_prefix": app.route_prefix,
            "deployments": app.deployment_names,
        }

    async def graceful_shutdown(self) -> None:
        for name in list(self._asm._apps):
            self._asm.delete(name)
        # Wait for replicas to drain.
        for _ in range(200):
            self._dsm.update()
            self._asm.update()
            if not self._dsm._states:
                break
            await asyncio.sleep(0.05)
        self._shutdown = True

    # ----------------------------------------------------------- metrics
    async def record_autoscaling_metrics(
        self, dep_id_str: str, replica_id: str, ongoing: float, ts: float
    ) -> None:
        self._autoscaling.record_replica(
            _parse_dep_id(dep_id_str), replica_id, ongoing, ts
        )

    async def record_handle_metrics(
        self, dep_id_str: str, handle_id: str, queued: float, ts: float
    ) -> None:
        self._autoscaling.record_handle(
            _parse_dep_id(dep_id_str), handle_id, queued, ts
        )

    async def record_multiplexed_model_ids(
        self, dep_id_str: str, replica_id: str, model_ids: tuple
    ) -> None:
        state = self._dsm.get(_parse_dep_id(dep_id_str))
        if state is not None:
            state.record_multiplexed_model_ids(replica_id, model_ids)

    # ---------------------------------------------------------- longpoll
    async def listen_for_change(self, snapshot_ids: Dict[str, int]):
        return await self._long_poll.listen_for_change(snapshot_ids)

    async def get_http_options(self):
        return self._http_options


def _parse_dep_id(s: str) -> DeploymentID:
    app, _, name = s.partition("#")
    return DeploymentID(name, app)


def _ingress_is_streaming(infos, ingress_name: str) -> bool:
    """Deploy-time inspection: a generator (or async-generator) ingress
    handler means the HTTP proxy should stream chunked responses
    (reference: Serve streams when the app returns StreamingResponse)."""
    import inspect

    for d in infos:
        if d["name"] != ingress_name:
            continue
        try:
            c = pickle.loads(d["serialized_callable"])
        except Exception:  # noqa: BLE001 - env-specific callables
            return False
        target = c if not inspect.isclass(c) else getattr(c, "__call__", None)
        return bool(
            target is not None
            and (
                inspect.isgeneratorfunction(target)
                or inspect.isasyncgenfunction(target)
            )
        )
    return False
