"""Application state: a named group of deployments with one ingress.

Reference: serve/_private/application_state.py (ApplicationState:117,
ApplicationStateManager:771).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .common import (
    ApplicationStatus,
    ApplicationStatusInfo,
    DeploymentID,
    DeploymentStatus,
    LongPollKey,
)


class ApplicationState:
    def __init__(self, name: str, route_prefix: Optional[str], ingress: str,
                 deployment_names: List[str], ingress_streaming: bool = False):
        self.name = name
        self.route_prefix = route_prefix
        self.ingress = ingress
        self.deployment_names = deployment_names
        # Ingress __call__ is a (sync/async) generator: the HTTP proxy
        # serves this app with chunked streaming responses.
        self.ingress_streaming = ingress_streaming
        self.status = ApplicationStatus.DEPLOYING
        self.message = ""
        self.deleting = False

    def deployment_ids(self) -> List[DeploymentID]:
        return [DeploymentID(n, self.name) for n in self.deployment_names]


class ApplicationStateManager:
    def __init__(self, deployment_state_manager, long_poll_host):
        self._dsm = deployment_state_manager
        self._long_poll = long_poll_host
        self._apps: Dict[str, ApplicationState] = {}
        self._last_routes: Optional[dict] = None

    def deploy(self, name, route_prefix, ingress, deployment_names,
               ingress_streaming: bool = False):
        # Remove deployments dropped by a redeploy.
        old = self._apps.get(name)
        if old:
            for dep in old.deployment_ids():
                if dep.name not in deployment_names:
                    self._dsm.delete(dep)
        self._apps[name] = ApplicationState(
            name, route_prefix, ingress, deployment_names, ingress_streaming
        )

    def delete(self, name: str):
        app = self._apps.get(name)
        if app is None:
            return
        app.deleting = True
        app.status = ApplicationStatus.DELETING
        for dep in app.deployment_ids():
            self._dsm.delete(dep)

    def update(self):
        for name in list(self._apps):
            app = self._apps[name]
            dep_statuses = {
                d.name: self._dsm.get(d).status_info
                for d in app.deployment_ids()
                if self._dsm.get(d) is not None
            }
            if app.deleting:
                if not dep_statuses:
                    del self._apps[name]
                continue
            if all(
                s.status == DeploymentStatus.HEALTHY for s in dep_statuses.values()
            ) and len(dep_statuses) == len(app.deployment_names):
                app.status = ApplicationStatus.RUNNING
            elif any(
                s.status == DeploymentStatus.UNHEALTHY for s in dep_statuses.values()
            ):
                app.status = ApplicationStatus.DEPLOY_FAILED
                app.message = "; ".join(
                    s.message for s in dep_statuses.values() if s.message
                )
            else:
                app.status = ApplicationStatus.DEPLOYING
        self._broadcast_routes()

    def _broadcast_routes(self):
        routes = {
            app.route_prefix: {
                "app_name": app.name,
                "ingress": app.ingress,
                "streaming": app.ingress_streaming,
            }
            for app in self._apps.values()
            if app.route_prefix and not app.deleting
        }
        if routes != self._last_routes:
            self._last_routes = routes
            self._long_poll.notify_changed({LongPollKey.ROUTE_TABLE: routes})
        apps = {
            app.name: {
                "app_name": app.name,
                "ingress": app.ingress,
                "streaming": app.ingress_streaming,
            }
            for app in self._apps.values()
            if not app.deleting
        }
        if apps != getattr(self, "_last_grpc_apps", None):
            self._last_grpc_apps = apps
            self._long_poll.notify_changed({LongPollKey.GRPC_APPS: apps})

    def status(self, name: str) -> Optional[ApplicationStatusInfo]:
        app = self._apps.get(name)
        if app is None:
            return None
        return ApplicationStatusInfo(
            status=app.status,
            message=app.message,
            deployments={
                d.name: self._dsm.get(d).status_info
                for d in app.deployment_ids()
                if self._dsm.get(d) is not None
            },
            route_prefix=app.route_prefix,
        )

    def statuses(self) -> Dict[str, ApplicationStatusInfo]:
        return {name: self.status(name) for name in self._apps}

    def get_app(self, name: str) -> Optional[ApplicationState]:
        return self._apps.get(name)
