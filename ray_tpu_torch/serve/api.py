"""Serve public API (reference: python/ray/serve/api.py).

``@serve.deployment`` wraps a class/function into a Deployment;
``.bind(*args)`` builds an Application graph (nested Applications in
the init args become DeploymentHandles — model composition);
``serve.run`` deploys it through the controller and blocks until
RUNNING.
"""
from __future__ import annotations

import pickle
import time
from dataclasses import replace as _dc_replace
from typing import Any, Callable, Dict, List, Optional, Union

import cloudpickle

from ._private.common import (
    CONTROLLER_NAME,
    DEFAULT_APP_NAME,
    ApplicationStatus,
    DeploymentID,
    PROXY_NAME_PREFIX,
)
from ._private.replica import get_replica_context  # noqa: F401 (re-export)
from .config import AutoscalingConfig, DeploymentConfig, GRPCOptions, HTTPOptions
from .handle import DeploymentHandle


class Application:
    """A deployment bound to init args (reference: serve/api.py
    Application) — the node of the composition graph."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class, name: str, config: DeploymentConfig):
        self._func_or_class = func_or_class
        self.name = name
        self._config = config

    def options(self, **kwargs) -> "Deployment":
        name = kwargs.pop("name", self.name)
        cfg_fields = {
            "num_replicas",
            "max_ongoing_requests",
            "max_queued_requests",
            "user_config",
            "autoscaling_config",
            "health_check_period_s",
            "health_check_timeout_s",
            "graceful_shutdown_timeout_s",
            "ray_actor_options",
        }
        updates = {}
        for k in list(kwargs):
            if k in cfg_fields:
                updates[k] = kwargs.pop(k)
        if kwargs:
            raise TypeError(f"Unknown deployment options: {sorted(kwargs)}")
        if isinstance(updates.get("autoscaling_config"), dict):
            updates["autoscaling_config"] = AutoscalingConfig(
                **updates["autoscaling_config"]
            )
        if updates.get("num_replicas") == "auto":
            updates["num_replicas"] = 1
            updates.setdefault("autoscaling_config", AutoscalingConfig(max_replicas=10))
        return Deployment(
            self._func_or_class, name, _dc_replace(self._config, **updates)
        )

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise RuntimeError(
            "Deployments cannot be called directly; use .bind() + serve.run, "
            "or a DeploymentHandle."
        )


def deployment(
    _func_or_class=None,
    *,
    name: Optional[str] = None,
    num_replicas: Union[int, str, None] = None,
    max_ongoing_requests: int = 100,
    max_queued_requests: int = -1,
    user_config: Any = None,
    autoscaling_config: Union[AutoscalingConfig, dict, None] = None,
    health_check_period_s: float = 2.0,
    health_check_timeout_s: float = 30.0,
    graceful_shutdown_timeout_s: float = 5.0,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """Decorator: ``@serve.deployment`` (reference serve/api.py:248)."""

    def build(target) -> Deployment:
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        n = num_replicas
        if n == "auto":
            n = 1
            nonlocal_asc = asc or AutoscalingConfig(max_replicas=10)
        else:
            nonlocal_asc = asc
        cfg = DeploymentConfig(
            num_replicas=n or 1,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            user_config=user_config,
            autoscaling_config=nonlocal_asc,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=ray_actor_options or {},
        )
        return Deployment(target, name or target.__name__, cfg)

    if _func_or_class is not None:
        return build(_func_or_class)
    return build


def ingress(app_or_func):
    """Compatibility shim: the reference wires FastAPI apps here; the
    aiohttp-native proxy calls ``__call__(HTTPRequest)`` directly, so
    this is the identity decorator."""
    return lambda cls: cls


# --------------------------------------------------------------- control
def _get_controller():
    from .. import get_actor

    return get_actor(CONTROLLER_NAME)


def start(http_options: Optional[HTTPOptions] = None, proxy: bool = True,
          grpc_options: Optional["GRPCOptions"] = None):
    """Ensure the controller (and HTTP/gRPC proxies) are running."""
    from .. import get, get_actor, is_initialized, init, remote

    if not is_initialized():
        init()
    try:
        return get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    from ._private.controller import ServeController

    http_options = http_options or HTTPOptions()
    controller = (
        remote(ServeController)
        .options(name=CONTROLLER_NAME, max_concurrency=64, get_if_exists=True)
        .remote(pickle.dumps(http_options))
    )
    controller.run_control_loop.remote()
    if proxy:
        from ._private.proxy import ProxyActor

        proxy_actor = (
            remote(ProxyActor)
            .options(
                name=f"{PROXY_NAME_PREFIX}::head",
                max_concurrency=256,
                get_if_exists=True,
            )
            .remote(http_options.host, http_options.port)
        )
        get(proxy_actor.ready.remote())
    if grpc_options is not None:
        from ._private.grpc_proxy import GrpcProxyActor

        grpc_actor = (
            remote(GrpcProxyActor)
            .options(
                name=f"{PROXY_NAME_PREFIX}::grpc",
                max_concurrency=256,
                get_if_exists=True,
            )
            .remote(grpc_options.host, grpc_options.port)
        )
        get(grpc_actor.ready.remote())
    return controller


def _flatten_application(
    app: Application, infos: Dict[str, dict], handles: Dict[int, DeploymentHandle],
    app_name: str,
) -> str:
    """DFS the composition graph; nested Applications become handles."""
    if id(app) in handles:
        return handles[id(app)].deployment_id.name
    dep = app._deployment

    def convert(v):
        if isinstance(v, Application):
            child = _flatten_application(v, infos, handles, app_name)
            return DeploymentHandle(child, app_name)
        return v

    args = tuple(convert(a) for a in app._args)
    kwargs = {k: convert(v) for k, v in app._kwargs.items()}
    if dep.name in infos:
        existing = infos[dep.name]
        if existing["_app_obj_id"] != id(app):
            raise ValueError(
                f"Duplicate deployment name {dep.name!r} in application"
            )
    infos[dep.name] = {
        "name": dep.name,
        "serialized_callable": cloudpickle.dumps(dep._func_or_class),
        "init_args": args,
        "init_kwargs": kwargs,
        "config": dep._config,
        "_app_obj_id": id(app),
    }
    handles[id(app)] = DeploymentHandle(dep.name, app_name)
    return dep.name


def run(
    target: Application,
    *,
    name: str = DEFAULT_APP_NAME,
    route_prefix: Optional[str] = "/",
    _blocking: bool = True,
    timeout_s: float = 120.0,
    deployment_overrides: Optional[Dict[str, Dict[str, Any]]] = None,
) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress
    (reference serve/api.py:570). ``deployment_overrides`` maps
    deployment name -> config-field updates (the declarative-config
    path: YAML values override code-side settings, serve/schema.py)."""
    from .. import get

    if not isinstance(target, Application):
        raise TypeError("serve.run expects an Application (deployment.bind(...))")
    controller = start()
    infos: Dict[str, dict] = {}
    handles: Dict[int, DeploymentHandle] = {}
    ingress_name = _flatten_application(target, infos, handles, name)
    for dep_name, updates in (deployment_overrides or {}).items():
        if dep_name not in infos:
            raise ValueError(
                f"deployment override for unknown deployment {dep_name!r}; "
                f"application has {sorted(infos)}"
            )
        updates = dict(updates)
        if isinstance(updates.get("autoscaling_config"), dict):
            updates["autoscaling_config"] = AutoscalingConfig(
                **updates["autoscaling_config"]
            )
        infos[dep_name]["config"] = _dc_replace(
            infos[dep_name]["config"], **updates
        )
    payload = [
        {k: v for k, v in d.items() if k != "_app_obj_id"} for d in infos.values()
    ]
    get(
        controller.deploy_application.remote(
            name, route_prefix, ingress_name, pickle.dumps(payload)
        )
    )
    if _blocking:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            statuses = get(controller.get_app_statuses.remote())
            info = statuses.get(name)
            if info and info.status == ApplicationStatus.RUNNING:
                break
            if info and info.status == ApplicationStatus.DEPLOY_FAILED:
                raise RuntimeError(f"Deploy failed: {info.message}")
            time.sleep(0.1)
        else:
            raise TimeoutError(f"Application {name!r} not RUNNING in {timeout_s}s")
    return DeploymentHandle(ingress_name, name)


def delete(name: str, _blocking: bool = True):
    from .. import get

    controller = _get_controller()
    get(controller.delete_application.remote(name))
    if _blocking:
        for _ in range(600):
            if name not in get(controller.get_app_statuses.remote()):
                return
            time.sleep(0.05)


def status():
    from .. import get

    return get(_get_controller().get_app_statuses.remote())


def get_app_handle(name: str = DEFAULT_APP_NAME) -> DeploymentHandle:
    from .. import get

    info = get(_get_controller().get_app_info.remote(name))
    if info is None:
        raise ValueError(f"No application named {name!r}")
    return DeploymentHandle(info["ingress"], name)


def get_deployment_handle(
    deployment_name: str, app_name: str = DEFAULT_APP_NAME
) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def shutdown():
    """Tear down all Serve state (reference serve/api.py:120)."""
    from .. import get, get_actor, kill

    from ._private.router import shutdown_routers

    try:
        controller = get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        get(controller.graceful_shutdown.remote(), timeout=30)
    except Exception:  # noqa: BLE001
        pass
    shutdown_routers()
    try:
        proxy = get_actor(f"{PROXY_NAME_PREFIX}::head")
        try:
            get(proxy.shutdown.remote(), timeout=5)
        except Exception:  # noqa: BLE001
            pass
        kill(proxy)
    except ValueError:
        pass
    kill(controller)


# ------------------------------------------------------------ multiplex
from .multiplex import get_multiplexed_model_id, multiplexed  # noqa: E402,F401
