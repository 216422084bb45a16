"""ray_tpu_torch.serve: scalable model serving on the actor substrate, the
port's copy of ray_tpu.serve on the port's runtime.

Architecture mirrors the reference (python/ray/serve — see SURVEY.md
§3.5): a ServeController actor owns application/deployment state and
reconciles replica actors toward the target; per-node ProxyActors serve
HTTP (aiohttp here, uvicorn/starlette in the reference); handles embed a
Router using power-of-two-choices replica scheduling
(serve/_private/replica_scheduler/pow_2_scheduler.py:49); config is
pushed via a long-poll host (serve/_private/long_poll.py:173).

Replicas are ordinary ray_tpu_torch actors, so a deployment can hold a
torch model on its card (``ray_actor_options={"num_gpus": 1}``, loaded
once per replica process) and batched requests run as one forward via
`@serve.batch`.
"""
from __future__ import annotations

from .api import (  # noqa: F401
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    get_multiplexed_model_id,
    get_replica_context,
    ingress,
    multiplexed,
    run,
    shutdown,
    start,
    status,
)
from .batching import batch  # noqa: F401
from .config import AutoscalingConfig, GRPCOptions, HTTPOptions  # noqa: F401
from .handle import (  # noqa: F401
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from .schema import deploy_config  # noqa: F401

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "deploy_config",
    "HTTPOptions",
    "GRPCOptions",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "get_replica_context",
    "ingress",
    "multiplexed",
    "run",
    "shutdown",
    "start",
    "status",
]

from ray_tpu_torch._private import usage_stats as _usage

_usage.record_library_usage("serve")
