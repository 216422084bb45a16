"""Train configuration dataclasses.

Reference: air/config.py — ScalingConfig (:~200), RunConfig,
FailureConfig (:395), CheckpointConfig. ScalingConfig scales by
`num_workers` processes, one card each with `use_gpu`, joined into one
torch.distributed group (NCCL on cards, gloo without); its `mesh` is the
port's `parallel.mesh.MeshSpec`, the layout the loop builds over that
group.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    mesh: Optional[MeshSpec] = None
    placement_strategy: str = "PACK"
    #: Join the worker group into one torch.distributed process group
    #: (when num_workers > 1): NCCL where the worker sees a card, gloo
    #: otherwise. Rank 0 brokers its address through the GCS KV
    #: (replaces the reference's NCCLUniqueIDStore actor —
    #: util/collective/util.py:9).
    use_torch_distributed: bool = False

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        if not res:
            res = {"GPU": 1.0} if self.use_gpu else {"CPU": 1.0}
        return res


@dataclass
class FailureConfig:
    max_failures: int = 0
    # Separate budget for actor-loss (infra) failures — a preempted or
    # OOM-killed trial actor restarts from its latest checkpoint
    # without consuming max_failures (user-code error) budget.
    infra_retries: int = 3


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    #: Tune stop criteria, e.g. {"training_iteration": 10} (reference:
    #: air RunConfig.stop).
    stop: Optional[Dict[str, Any]] = None


@dataclass
class Result:
    """Reference: air/result.py."""

    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Any]
    error: Optional[BaseException]
    path: Optional[str]
    metrics_history: list = field(default_factory=list)
    config: Optional[Dict[str, Any]] = None
