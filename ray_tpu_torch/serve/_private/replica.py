"""Replica actor: hosts one copy of a deployment's callable.

Reference: serve/_private/replica.py (ReplicaActor:231,
handle_request_with_rejection:487 — rejection-based admission control).
Requests arrive as ordinary actor tasks on the async event loop, so a
replica overlaps many in-flight requests; a torch model held by the
callable is loaded once per replica process.
"""
from __future__ import annotations

import asyncio
import contextvars
import inspect
import pickle
import time
from typing import Any, Dict, Optional, Tuple

from .common import DeploymentID, RequestMetadata

# Module-global so user code can reach its own replica context
# (reference: serve/api.py get_replica_context:140).
_replica_context: Optional["ReplicaContext"] = None

# Per-request (requests overlap on the async loop, so this must be a
# contextvar, not a field on the shared context).
_request_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


class ReplicaContext:
    def __init__(self, deployment_id: DeploymentID, replica_id: str):
        self.deployment = deployment_id.name
        self.app_name = deployment_id.app_name
        self.replica_id = replica_id

    @property
    def multiplexed_model_id(self) -> str:
        return _request_model_id.get()


def get_replica_context() -> ReplicaContext:
    if _replica_context is None:
        raise RuntimeError(
            "get_replica_context() may only be called inside a Serve replica."
        )
    return _replica_context


class RejectedError(Exception):
    """Replica at max_ongoing_requests; router must retry elsewhere."""


class ReplicaActor:
    def __init__(
        self,
        deployment_name: str,
        app_name: str,
        replica_id: str,
        serialized_callable: bytes,
        init_args: tuple,
        init_kwargs: dict,
        config_blob: bytes,
    ):
        global _replica_context
        self._dep_id = DeploymentID(deployment_name, app_name)
        self._replica_id = replica_id
        self._config = pickle.loads(config_blob)
        _replica_context = ReplicaContext(self._dep_id, replica_id)

        func_or_class = pickle.loads(serialized_callable)
        if inspect.isclass(func_or_class):
            self._callable = func_or_class(*init_args, **init_kwargs)
        else:
            # Function deployment: the "callable" is the function itself.
            self._callable = func_or_class
        self._is_function = not inspect.isclass(func_or_class)
        self._num_ongoing = 0
        self._metrics_task: Optional[asyncio.Task] = None
        if self._config.user_config is not None:
            self._apply_user_config(self._config.user_config)

    # ------------------------------------------------------------ control
    async def ensure_started(self) -> str:
        """Awaited by the controller to confirm the replica constructed;
        also kicks off the autoscaling metrics pusher."""
        if self._metrics_task is None and self._config.autoscaling_config:
            self._metrics_task = asyncio.get_running_loop().create_task(
                self._push_metrics_loop()
            )
        return self._replica_id

    def _apply_user_config(self, user_config) -> None:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    async def reconfigure(self, user_config) -> None:
        self._config.user_config = user_config
        self._apply_user_config(user_config)

    async def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            out = self._callable.check_health()
            if inspect.isawaitable(out):
                await out
        return True

    async def prepare_for_shutdown(self) -> None:
        """Drain: wait for in-flight requests (graceful shutdown,
        reference replica.py perform_graceful_shutdown)."""
        deadline = time.monotonic() + self._config.graceful_shutdown_timeout_s
        while self._num_ongoing > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        if hasattr(self._callable, "__del__"):
            try:
                self._callable.__del__()
            except Exception:  # noqa: BLE001
                pass

    def get_num_ongoing_requests(self) -> int:
        return self._num_ongoing

    async def list_multiplexed_model_ids(self) -> Tuple[str, ...]:
        from ..multiplex import get_loaded_model_ids

        return tuple(get_loaded_model_ids(self._callable))

    # ------------------------------------------------------------ serving
    async def handle_request(self, meta: RequestMetadata, *args, **kwargs):
        """Rejection-based admission: over-capacity calls raise
        RejectedError so the router retries another replica instead of
        queueing here (reference replica.py:487)."""
        if self._num_ongoing >= self._config.max_ongoing_requests:
            raise RejectedError(self._replica_id)
        self._num_ongoing += 1
        try:
            _request_model_id.set(meta.multiplexed_model_id)
            target = self._resolve_method(meta.call_method)
            result = target(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            return result
        finally:
            self._num_ongoing -= 1

    async def handle_request_streaming(
        self, meta: RequestMetadata, *args, **kwargs
    ):
        """Streaming variant: an async generator the worker runtime
        drives as a ``num_returns="streaming"`` task — each yielded
        chunk seals as its own object and reaches the caller while the
        handler is still producing (reference: replica.py:471
        handle_request_streaming)."""
        if self._num_ongoing >= self._config.max_ongoing_requests:
            raise RejectedError(self._replica_id)
        self._num_ongoing += 1
        try:
            _request_model_id.set(meta.multiplexed_model_id)
            target = self._resolve_method(meta.call_method)
            result = target(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            if hasattr(result, "__aiter__"):
                async for item in result:
                    yield item
            elif inspect.isgenerator(result):
                for item in result:
                    yield item
            else:
                yield result
        finally:
            self._num_ongoing -= 1

    def _resolve_method(self, name: str):
        if self._is_function:
            return self._callable
        if name == "__call__":
            call = getattr(self._callable, "__call__", None)
            if call is None:
                raise AttributeError(
                    f"Deployment {self._dep_id} has no __call__ method"
                )
            return call
        return getattr(self._callable, name)

    # ------------------------------------------------------- autoscaling
    async def _push_metrics_loop(self):
        from ... import get_actor

        from .common import CONTROLLER_NAME

        interval = self._config.autoscaling_config.metrics_interval_s
        controller = get_actor(CONTROLLER_NAME)
        while True:
            try:
                controller.record_autoscaling_metrics.remote(
                    str(self._dep_id), self._replica_id, self._num_ongoing, time.time()
                )
            except Exception:  # noqa: BLE001
                pass
            await asyncio.sleep(interval)
