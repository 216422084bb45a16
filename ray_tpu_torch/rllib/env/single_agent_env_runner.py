"""SingleAgentEnvRunner: samples episodes from gymnasium vector envs.

Reference: rllib/env/single_agent_env_runner.py — the hot rollout loop:
vectorized env.step + module forward per tick. Runs on CPU actors, which
see no card; the module's forward is torch on the CPU under no_grad,
with the learner's weights pushed as a host copy (weight sync,
env_runner_group.py:522).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..connectors.connector_v2 import (
    BatchObservations,
    ConnectorPipelineV2,
    SampleCategoricalActions,
)
from .episode import SingleAgentEpisode


def _make_env(env_spec, env_config):
    import gymnasium as gym

    if callable(env_spec):
        return env_spec(env_config)
    return gym.make(env_spec, **(env_config or {}))


class SingleAgentEnvRunner:
    """One actor; ``sample()`` returns finalized episode chunks."""

    def __init__(self, config_blob: bytes, worker_index: int = 0):
        import pickle

        cfg = pickle.loads(config_blob)
        self.config = cfg
        self.worker_index = worker_index
        self.num_envs = cfg["num_envs_per_env_runner"]
        seed = (cfg.get("seed") or 0) + 1000 * worker_index
        self._rng = np.random.default_rng(seed)

        import gymnasium as gym

        self.env = gym.vector.SyncVectorEnv(
            [
                (lambda i=i: _make_env(cfg["env"], cfg.get("env_config")))
                for i in range(self.num_envs)
            ]
        )
        spec = cfg["module_spec"]
        if spec.observation_space is None:
            spec.observation_space = self.env.single_observation_space
        if spec.action_space is None:
            spec.action_space = self.env.single_action_space
        self.module = spec.build("cpu")
        self.params = self.module.init_params(torch.Generator().manual_seed(seed))

        self.env_to_module = cfg.get("env_to_module") or ConnectorPipelineV2(
            [BatchObservations()]
        )
        self.module_to_env = cfg.get("module_to_env") or ConnectorPipelineV2(
            [SampleCategoricalActions(rng=self._rng)]
        )
        self._episodes: List[SingleAgentEpisode] = []
        self._obs = None
        self._total_steps = 0
        # gymnasium >=1.0 vector envs use NEXT-step autoreset: the step
        # after a termination returns the reset observation with reward
        # 0 and ignores the action. Track which slots are in that state
        # so the bogus transition is dropped and the new episode starts
        # from the true reset obs.
        self._pending_reset = np.zeros(self.num_envs, bool)
        # True episode returns (accumulated across chunk cuts — a chunk's
        # sum undercounts episodes spanning sample boundaries).
        self._return_acc = np.zeros(self.num_envs, np.float64)
        self._completed_returns: List[float] = []

    # ------------------------------------------------------------ weights
    def set_weights(self, weights) -> None:
        self.params.load_state_dict(weights)

    def get_weights(self):
        return {k: v.clone() for k, v in self.params.state_dict().items()}

    # ------------------------------------------------------------- sample
    def _forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        # Rollouts stay on the host CPU — the learner owns the card.
        with torch.no_grad():
            out = self.module.forward_exploration(self.params, batch)
        return {k: v.numpy() for k, v in out.items()}

    def _reset_if_needed(self):
        if self._obs is None:
            obs, _ = self.env.reset(seed=int(self._rng.integers(0, 2**31)))
            self._obs = obs
            self._episodes = [
                SingleAgentEpisode(initial_observation=obs[i])
                for i in range(self.num_envs)
            ]

    def sample(
        self,
        *,
        num_timesteps: Optional[int] = None,
        num_episodes: Optional[int] = None,
        explore: bool = True,
    ) -> List[SingleAgentEpisode]:
        """Collect at least num_timesteps env steps (across the vector
        env) or num_episodes full episodes."""
        self._reset_if_needed()
        if num_timesteps is None and num_episodes is None:
            num_timesteps = self.config.get("rollout_fragment_length", 200) * (
                self.num_envs
            )
        done_eps: List[SingleAgentEpisode] = []
        steps = 0
        while True:
            batch = self.env_to_module(episodes=self._episodes)
            outs = self._forward(batch)
            outs = self.module_to_env(
                batch=outs, episodes=self._episodes, explore=explore
            )
            actions = np.asarray(outs["actions"])
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            extra_keys = [k for k in ("action_logp",) if k in outs]
            recorded = 0
            for i, ep in enumerate(self._episodes):
                if self._pending_reset[i]:
                    # This step performed the autoreset: obs[i] is the
                    # new episode's first observation; the transition is
                    # fake (action ignored, reward 0) — drop it.
                    self._episodes[i] = SingleAgentEpisode(
                        initial_observation=obs[i]
                    )
                    self._pending_reset[i] = False
                    continue
                self._return_acc[i] += rewards[i]
                recorded += 1
                ep.add_env_step(
                    obs[i],
                    actions[i],
                    rewards[i],
                    terminated=bool(terms[i]),
                    truncated=bool(truncs[i]),
                    extra_model_outputs={k: outs[k][i] for k in extra_keys},
                )
                if ep.is_done:
                    self._completed_returns.append(float(self._return_acc[i]))
                    self._return_acc[i] = 0.0
                    done_eps.append(ep.finalize())
                    # Placeholder until the autoreset step delivers the
                    # real initial observation (never recorded into).
                    self._episodes[i] = SingleAgentEpisode(
                        initial_observation=obs[i]
                    )
                    self._pending_reset[i] = True
            self._obs = obs
            steps += recorded
            self._total_steps += recorded
            if num_episodes is not None:
                if len(done_eps) >= num_episodes:
                    return done_eps[:num_episodes]
            elif steps >= num_timesteps:
                # Ship unfinished episodes as truncated chunks so the
                # learner sees exactly this sample's experience.
                out = list(done_eps)
                for i, ep in enumerate(self._episodes):
                    if len(ep) > 0:
                        ep.is_truncated = True
                        out.append(ep.finalize())
                        self._episodes[i] = SingleAgentEpisode(
                            initial_observation=np.asarray(ep.observations[-1])
                        )
                return out

    def stats(self) -> Dict[str, Any]:
        return {"total_env_steps": self._total_steps,
                "worker_index": self.worker_index}

    def get_metrics(self) -> Dict[str, Any]:
        """Completed-episode returns since last call (drained)."""
        out = {"episode_returns": self._completed_returns}
        self._completed_returns = []
        return out

    def ping(self) -> str:
        return "ok"
