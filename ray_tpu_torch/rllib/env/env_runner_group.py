"""EnvRunnerGroup: the fleet of sampling actors.

Reference: rllib/env/env_runner_group.py (sync_weights :522). With
num_env_runners=0 a local runner samples in-process (debugging); with
N>0, N CPU actors sample in parallel and weights are broadcast through
the object store (one `put`, N handles).
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import ray_tpu_torch

from ..utils.actor_manager import FaultTolerantActorManager
from .single_agent_env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(self, config: Dict[str, Any]):
        self._config = config
        self._blob = pickle.dumps(config)
        n = config.get("num_env_runners", 0)
        runner_cls = config.get("runner_cls") or SingleAgentEnvRunner
        self._local: Optional[SingleAgentEnvRunner] = None
        self._manager: Optional[FaultTolerantActorManager] = None
        if n == 0:
            self._local = runner_cls(self._blob, worker_index=0)
        else:
            actor_cls = ray_tpu_torch.remote(runner_cls).options(
                num_cpus=config.get("num_cpus_per_env_runner", 1)
            )
            self._manager = FaultTolerantActorManager(
                lambda i: actor_cls.remote(self._blob, i + 1), n
            )

    @property
    def num_remote_runners(self) -> int:
        return self._manager.num_actors if self._manager else 0

    @property
    def num_healthy_env_runners(self) -> int:
        return self._manager.num_actors if self._manager else 1

    @property
    def num_restarts(self) -> int:
        return self._manager.num_restarts if self._manager else 0

    def sample(
        self, *, num_timesteps=None, num_episodes=None, explore=True
    ) -> List:
        if self._local is not None:
            return self._local.sample(
                num_timesteps=num_timesteps,
                num_episodes=num_episodes,
                explore=explore,
            )
        per = None
        per_eps = None
        if num_timesteps is not None:
            per = max(1, num_timesteps // self._manager.num_actors)
        if num_episodes is not None:
            per_eps = max(1, num_episodes // self._manager.num_actors)
        results = self._manager.foreach_actor(
            "sample", num_timesteps=per, num_episodes=per_eps, explore=explore
        )
        episodes = []
        for _, eps in results:
            episodes.extend(eps)
        return episodes

    def sync_weights(self, weights) -> None:
        """Broadcast learner weights to every runner via one object-store
        put (reference env_runner_group.py:522)."""
        if self._local is not None:
            self._local.set_weights(weights)
            return
        ref = ray_tpu_torch.put(weights)
        self._manager.foreach_actor("set_weights", ref)

    def stats(self) -> List[Dict[str, Any]]:
        if self._local is not None:
            return [self._local.stats()]
        return [s for _, s in self._manager.foreach_actor("stats")]

    def get_metrics(self) -> Dict[str, Any]:
        """Drain completed-episode returns from every runner."""
        if self._local is not None:
            return self._local.get_metrics()
        returns: List[float] = []
        module_returns: Dict[str, List[float]] = {}
        for _, m in self._manager.foreach_actor("get_metrics"):
            returns.extend(m["episode_returns"])
            for mid, rs in m.get("module_returns", {}).items():
                module_returns.setdefault(mid, []).extend(rs)
        out: Dict[str, Any] = {"episode_returns": returns}
        if module_returns:
            out["module_returns"] = module_returns
        return out

    def stop(self):
        if self._manager:
            self._manager.shutdown()
