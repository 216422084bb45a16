"""Algorithm: the trainable facade over env runners + learners.

Reference: rllib/algorithms/algorithm.py (step :802, default
training_step :1576). Subclasses implement ``training_step``;
``train()`` (from the Tune Trainable API) wraps it with metric
aggregation, so every algorithm is directly tunable with
ray_tpu_torch.tune.Tuner.
"""
from __future__ import annotations

import os
import pickle
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ...tune.trainable import Trainable
from ..core.learner_group import LearnerGroup
from ..env.env_runner_group import EnvRunnerGroup


class Algorithm(Trainable):
    learner_class: Optional[type] = None

    def __init__(self, config=None, **kwargs):
        # Tune passes a dict; direct use passes an AlgorithmConfig.
        from .algorithm_config import AlgorithmConfig

        if isinstance(config, dict):
            cfg_obj = config.get("__algorithm_config__")
            if cfg_obj is None:
                raise ValueError(
                    "Pass an AlgorithmConfig (or a dict containing "
                    "'__algorithm_config__')"
                )
            config = cfg_obj
        assert isinstance(config, AlgorithmConfig)
        self._iteration = 0
        self._total_env_steps = 0
        self._episode_returns: deque = deque(maxlen=100)
        self._module_returns: Dict[str, deque] = {}
        self._start = time.monotonic()
        # Trainable.__init__ assigns self.config = the dict and calls
        # setup(); setup() re-binds self.config to the AlgorithmConfig.
        super().__init__(config={"__algorithm_config__": config})

    # ----------------------------------------------------------- setup
    def setup(self, config_dict) -> None:
        import gymnasium as gym

        self.config = config_dict["__algorithm_config__"].copy()
        # Tune-sampled hyperparams arrive as extra keys in the trial
        # config dict; apply them as overrides (lr, gamma, ...).
        for k, v in config_dict.items():
            if k != "__algorithm_config__" and hasattr(self.config, k):
                setattr(self.config, k, v)
        probe = (
            self.config.env(self.config.env_config)
            if callable(self.config.env)
            else gym.make(self.config.env, **(self.config.env_config or {}))
        )
        if self.config.is_multi_agent:
            from ..core.multi_agent_learner_group import (
                MultiAgentLearnerGroup,
            )

            self._module_spec = self.config.multi_module_spec(probe)
            group_cls = MultiAgentLearnerGroup
        else:
            self._module_spec = self.config.module_spec(
                probe.observation_space, probe.action_space
            )
            group_cls = LearnerGroup
        probe.close()
        # The learners first: a learner that cannot have its card raises
        # here, before any env runner has started.
        self.learner_group = group_cls(
            learner_cls=self.learner_class,
            module_spec=self._module_spec,
            config=self.learner_config(),
        )
        try:
            self.env_runner_group = EnvRunnerGroup(self.env_runner_config())
        except BaseException:
            self.learner_group.shutdown()
            raise
        # Push initial learner weights so runners and learner agree.
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def learner_config(self) -> Dict[str, Any]:
        return self.config.learner_config()  # subclass extras live on Config

    def env_runner_config(self) -> Dict[str, Any]:
        """Hook: algorithms may add connectors (e.g. DQN's ε-greedy)."""
        return self.config.env_runner_config(self._module_spec)

    # ------------------------------------------------------------ train
    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        learner_metrics = self.training_step()
        runner_metrics = self.env_runner_group.get_metrics()
        self._episode_returns.extend(runner_metrics["episode_returns"])
        for mid, rets in runner_metrics.get("module_returns", {}).items():
            self._module_returns.setdefault(
                mid, deque(maxlen=100)
            ).extend(rets)
        self._iteration += 1
        result = {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "time_total_s": time.monotonic() - self._start,
            "env_runners": {
                "episode_return_mean": (
                    float(np.mean(self._episode_returns))
                    if self._episode_returns
                    else float("nan")
                ),
                "num_episodes": len(self._episode_returns),
                "num_healthy_workers": (
                    self.env_runner_group.num_healthy_env_runners
                ),
                "num_restarts": self.env_runner_group.num_restarts,
            },
            "learners": learner_metrics,
        }
        if self._module_returns:
            result["env_runners"]["module_episode_return_mean"] = {
                mid: float(np.mean(rets))
                for mid, rets in self._module_returns.items()
                if rets
            }
        # Flat aliases used by Tune stoppers/schedulers.
        result["episode_return_mean"] = result["env_runners"][
            "episode_return_mean"
        ]
        return result

    def train(self) -> Dict[str, Any]:
        return self.step()

    def _record_episodes(self, episodes: List) -> None:
        # Returns are tracked in the runners (chunks spanning sample
        # boundaries must accumulate); here only step accounting.
        for ep in episodes:
            self._total_env_steps += len(ep)

    # ------------------------------------------------------- checkpoint
    def save_checkpoint(self, checkpoint_dir: str) -> str:
        state = {
            "learner": self.learner_group.get_state(),
            "iteration": self._iteration,
            "total_env_steps": self._total_env_steps,
        }
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(
            os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb"
        ) as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    save = save_checkpoint
    restore = load_checkpoint

    def stop(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.shutdown()

    cleanup = stop
