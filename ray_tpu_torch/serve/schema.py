"""Declarative Serve config: YAML -> running applications.

Reference: python/ray/serve/schema.py (ServeDeploySchema) + the `serve
deploy` CLI — a config file names applications by import path with
per-deployment option overrides, and redeploying an updated file
reconciles the live cluster toward it (replica counts change with zero
downtime: the deployment reconciler scales the existing replica set
instead of tearing the app down).

Schema::

    applications:
      - name: text_app            # default: "default"
        route_prefix: /           # null -> no HTTP route
        import_path: mymodule:app # module attr holding a bound Application
        runtime_env: {}           # reserved
        deployments:              # optional per-deployment overrides
          - name: TextGen
            num_replicas: 2
            max_ongoing_requests: 16
            autoscaling_config: {min_replicas: 1, max_replicas: 4}
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List

from .api import Application, run
from .handle import DeploymentHandle

_OVERRIDE_FIELDS = {
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


def _load_import_path(import_path: str) -> Application:
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:variable'"
        )
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    if not isinstance(target, Application):
        raise TypeError(
            f"{import_path!r} resolves to {type(target).__name__}, expected a "
            f"bound Application (deployment.bind(...))"
        )
    return target


def deploy_config(config: Dict[str, Any] | str,
                  _blocking: bool = True) -> List[DeploymentHandle]:
    """Deploy every application in a config dict or YAML file path.

    Idempotent: redeploying reconciles live deployments toward the new
    config (scale up/down in place, no downtime)."""
    if isinstance(config, str):
        import yaml

        with open(config) as f:
            config = yaml.safe_load(f)
    apps = config.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ValueError("config must have a non-empty 'applications' list")
    handles = []
    for app_cfg in apps:
        import_path = app_cfg.get("import_path")
        if not import_path:
            raise ValueError(f"application entry missing import_path: {app_cfg}")
        overrides: Dict[str, Dict[str, Any]] = {}
        for dep in app_cfg.get("deployments") or []:
            dep = dict(dep)
            dep_name = dep.pop("name", None)
            if not dep_name:
                raise ValueError("deployment override entries need a 'name'")
            unknown = set(dep) - _OVERRIDE_FIELDS
            if unknown:
                raise ValueError(
                    f"unknown deployment option(s) for {dep_name!r}: "
                    f"{sorted(unknown)}"
                )
            overrides[dep_name] = dep
        handles.append(
            run(
                _load_import_path(import_path),
                name=app_cfg.get("name", "default"),
                route_prefix=app_cfg.get("route_prefix", "/"),
                deployment_overrides=overrides or None,
                _blocking=_blocking,
            )
        )
    return handles
