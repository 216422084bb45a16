"""DQN / double-DQN with (prioritized) replay.

Reference: rllib/algorithms/dqn/ — sample with ε-greedy exploration
into a replay buffer; update on uniform or PER samples with a target
network refreshed every N steps; double-Q action selection by the
online net. The learner is local (the replay lives with the
algorithm, on the host) and on the card unless `num_gpus_per_learner=0`
asks for the CPU: each sampled batch crosses to the device once per
update, and the target network is a detached copy on the learner's
device.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..connectors.connector_v2 import (
    ConnectorPipelineV2,
    EpisodesToBatch,
    EpsilonGreedyActions,
)
from ..core.learner import Learner, _to_host
from ..core.rl_module import Columns, QNetworkModule
from ..utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class DQNConfig(AlgorithmConfig):
    default_module_class = QNetworkModule

    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = False
        self.per_alpha = 0.6
        self.per_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500
        self.double_q = True
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 10_000
        self.sample_timesteps_per_iteration = 400
        self.updates_per_iteration = 100

    @property
    def algo_class(self):
        return DQN

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            gamma=self.gamma,
            double_q=self.double_q,
            # minibatching handled by replay sampling
            minibatch_size=None,
            num_epochs=1,
            target_updates_every=max(
                1,
                self.target_network_update_freq
                // max(1, self.train_batch_size),
            ),
        )
        return cfg


def frozen_copy(params: torch.nn.Module) -> torch.nn.Module:
    """A target network: a copy of `params` on their device that takes no
    gradient."""
    target = copy.deepcopy(params)
    target.requires_grad_(False)
    return target


class DQNLearner(Learner):
    def build(self):
        super().build()
        self.target_params = frozen_copy(self.params)
        self._updates = 0

    def build_batch(self, episodes):
        return EpisodesToBatch()(episodes=episodes)

    def _q_taken(self, params, batch):
        q_all = self.module.forward_train(params, batch)["q_values"]
        actions = batch[Columns.ACTIONS].long()
        return torch.take_along_dim(q_all, actions[:, None], dim=-1)[:, 0]

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        q = self._q_taken(params, batch)
        next_batch = {Columns.OBS: batch[Columns.NEXT_OBS]}
        with torch.no_grad():
            q_next_target = self.module.forward_train(
                self.target_params, next_batch
            )["q_values"]
            if cfg.get("double_q", True):
                q_next_online = self.module.forward_train(params, next_batch)[
                    "q_values"
                ]
                best = torch.argmax(q_next_online, dim=-1)
                q_next = torch.take_along_dim(q_next_target, best[:, None], dim=-1)[:, 0]
            else:
                q_next = torch.amax(q_next_target, dim=-1)
        target = (
            batch[Columns.REWARDS]
            + cfg["gamma"] * (1.0 - batch[Columns.TERMINATEDS]) * q_next
        )
        td = q - target
        weights = batch.get("weights")
        loss = torch.mean(
            (weights if weights is not None else 1.0) * huber(td)
        )
        return loss, {"qf_mean": torch.mean(q), "td_error_abs": torch.mean(torch.abs(td))}

    def update(self, batch, noise=None):
        # Refresh the target net on schedule (counted in update calls).
        metrics = super().update(batch, noise)
        self._updates += 1
        if self._updates % max(
            1, self.config.get("target_updates_every", 10)
        ) == 0:
            with torch.no_grad():
                self.target_params.load_state_dict(self.params.state_dict())
        return metrics

    def td_errors(self, batch) -> np.ndarray:
        """|TD| per transition for PER priority updates (max over the
        target net's Q, as the reference's)."""
        batch = self.device_batch(batch)
        with torch.no_grad():
            q = self._q_taken(self.params, batch)
            nb = {Columns.OBS: batch[Columns.NEXT_OBS]}
            qn = torch.amax(
                self.module.forward_train(self.target_params, nb)["q_values"], dim=-1
            )
            target = (
                batch[Columns.REWARDS]
                + self.config["gamma"] * (1.0 - batch[Columns.TERMINATEDS]) * qn
            )
            return torch.abs(q - target).cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["target_params"] = _to_host(self.target_params.state_dict())
        state["updates"] = self._updates
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "target_params" in state:
            self.target_params.load_state_dict(state["target_params"])
            self._updates = state["updates"]


class _EpsilonSchedule(EpsilonGreedyActions):
    """Linear ε decay; picklable (lambdas can't ship to runner actors).
    Its draws come from `seed` (the reference's are unseeded)."""

    def __init__(self, eps0: float, eps1: float, horizon: int, seed=None):
        self.eps0, self.eps1, self.horizon = eps0, eps1, horizon
        super().__init__(self._eps, rng=np.random.default_rng(seed))

    def _eps(self, step: int) -> float:
        return max(
            self.eps1,
            self.eps0 - (self.eps0 - self.eps1) * step / self.horizon,
        )


def huber(x, delta: float = 1.0):
    ax = torch.abs(x)
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def replay_for(cfg) -> ReplayBuffer:
    """The algorithm's replay: prioritized or uniform, drawing from its
    own generator seeded by the config."""
    if cfg.prioritized_replay:
        return PrioritizedReplayBuffer(
            cfg.replay_buffer_capacity,
            alpha=cfg.per_alpha,
            beta=cfg.per_beta,
            seed=cfg.seed,
        )
    return ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)


def mean_metrics(metrics_list) -> Dict[str, float]:
    return {
        k: float(np.mean([m[k] for m in metrics_list]))
        for k in metrics_list[0]
    }


class DQN(Algorithm):
    learner_class = DQNLearner

    def setup(self, config_dict) -> None:
        super().setup(config_dict)
        self.replay = replay_for(self.config)

    def env_runner_config(self) -> Dict[str, Any]:
        # ε-greedy exploration schedule lives in the runner's
        # module-to-env connector.
        cfg = self.config
        runner_cfg = super().env_runner_config()
        runner_cfg["module_to_env"] = ConnectorPipelineV2(
            [_EpsilonSchedule(cfg.epsilon_initial, cfg.epsilon_final,
                              cfg.epsilon_timesteps, seed=cfg.seed)]
        )
        return runner_cfg

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        episodes = self.env_runner_group.sample(
            num_timesteps=cfg.sample_timesteps_per_iteration
        )
        self._record_episodes(episodes)
        self.replay.add_episodes(episodes)
        if len(self.replay) < cfg.num_steps_sampled_before_learning_starts:
            return {"buffer_size": float(len(self.replay))}
        metrics_list = []
        assert self.learner_group.is_local, (
            "DQN uses a local learner (replay lives with the algorithm)"
        )
        learner: DQNLearner = self.learner_group._local
        for _ in range(cfg.updates_per_iteration):
            batch = self.replay.sample(cfg.train_batch_size)
            idx = batch.pop("batch_indexes")
            batch = learner.device_batch(batch)  # one copy per update
            m = learner.update(batch)
            if cfg.prioritized_replay:
                self.replay.update_priorities(
                    idx, learner.td_errors(batch)
                )
            metrics_list.append(m)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        out = mean_metrics(metrics_list)
        out["buffer_size"] = float(len(self.replay))
        return out
