"""Shared Serve types (reference: serve/_private/common.py)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"
PROXY_NAME_PREFIX = "SERVE_PROXY"
DEFAULT_APP_NAME = "default"


@dataclass(frozen=True)
class DeploymentID:
    name: str
    app_name: str = DEFAULT_APP_NAME

    def actor_prefix(self) -> str:
        return f"SERVE_REPLICA::{self.app_name}#{self.name}"

    def __str__(self):
        return f"{self.app_name}#{self.name}"


class ReplicaState(str, enum.Enum):
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    STOPPING = "STOPPING"


class DeploymentStatus(str, enum.Enum):
    UPDATING = "UPDATING"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    UPSCALING = "UPSCALING"
    DOWNSCALING = "DOWNSCALING"


class ApplicationStatus(str, enum.Enum):
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    DEPLOY_FAILED = "DEPLOY_FAILED"
    DELETING = "DELETING"
    NOT_STARTED = "NOT_STARTED"


@dataclass
class RequestMetadata:
    request_id: str
    call_method: str = "__call__"
    multiplexed_model_id: str = ""
    http_request: bool = False


@dataclass
class RunningReplicaInfo:
    """What routers need to know about a live replica (reference:
    serve/_private/common.py RunningReplicaInfo)."""

    replica_id: str
    deployment_id: DeploymentID
    actor_name: str
    max_ongoing_requests: int
    multiplexed_model_ids: tuple = ()
    max_queued_requests: int = -1


@dataclass
class DeploymentStatusInfo:
    status: DeploymentStatus
    message: str = ""
    num_replicas: int = 0


@dataclass
class ApplicationStatusInfo:
    status: ApplicationStatus
    message: str = ""
    deployments: Dict[str, DeploymentStatusInfo] = field(default_factory=dict)
    route_prefix: Optional[str] = None


# Long-poll namespace keys (reference: serve/_private/long_poll.py
# LongPollNamespace).
class LongPollKey:
    @staticmethod
    def running_replicas(dep_id: DeploymentID) -> str:
        return f"RUNNING_REPLICAS::{dep_id}"

    ROUTE_TABLE = "ROUTE_TABLE"
    # All apps keyed by name (gRPC routes by application, not prefix —
    # apps with route_prefix=None are still gRPC-reachable).
    GRPC_APPS = "GRPC_APPS"


@dataclass
class HTTPRequest:
    """Framework-native HTTP request passed to ingress deployments
    (the reference passes a starlette Request; aiohttp-backed here)."""

    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes

    def json(self):
        import json

        return json.loads(self.body.decode() or "null")

    def text(self) -> str:
        return self.body.decode()
