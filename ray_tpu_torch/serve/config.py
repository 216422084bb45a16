"""Serve configuration dataclasses.

Reference: python/ray/serve/config.py (AutoscalingConfig :33,
HTTPOptions :233) — pydantic there; plain dataclasses here to stay
dependency-light.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-length-based autoscaling (reference default policy:
    serve/autoscaling_policy.py:85 — desired = total_requests /
    target_ongoing_requests, smoothed and delay-gated)."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    # Seconds a scaling decision must persist before it is applied.
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    # Multiplicative smoothing on the size of each scaling move.
    upscaling_factor: float = 1.0
    downscaling_factor: float = 1.0
    # How often replicas/handles push metrics and how much history the
    # controller averages over.
    metrics_interval_s: float = 0.5
    look_back_period_s: float = 5.0
    initial_replicas: Optional[int] = None

    def bound(self, n: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, n))


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
    root_path: str = ""


@dataclass
class GRPCOptions:
    """gRPC ingress (reference: serve gRPCOptions — grpc_servicer_
    functions there; schema-free generic service here)."""

    host: str = "127.0.0.1"
    port: int = 9000


@dataclass
class DeploymentConfig:
    """Per-deployment runtime knobs (reference:
    serve/_private/config.py DeploymentConfig)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 100
    max_queued_requests: int = -1
    user_config: Any = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)

    @property
    def initial_target_replicas(self) -> int:
        if self.autoscaling_config is not None:
            ac = self.autoscaling_config
            if ac.initial_replicas is not None:
                return ac.bound(ac.initial_replicas)
            return ac.min_replicas
        return self.num_replicas
