"""SAC: soft actor-critic for continuous control.

Reference: rllib/algorithms/sac/ — off-policy maximum-entropy RL with a
squashed-Gaussian policy, twin Q networks with a polyak-averaged target
pair, and automatic entropy-temperature tuning. As the reference, the
actor, twin-critic and log-alpha losses are summed into one loss, with
detached tensors partitioning the flows (Adam is per-parameter, so a
summed loss whose gradients each touch only their own component's
parameters is exactly three optimizers), one backward and one Adam step
per update, eager torch on the learner's device. The loss takes its
Gaussian draws as an argument (`draw_noise`); the target pair is a
detached copy on the learner's device, moved toward the online pair by
one polyak step per update.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..connectors.connector_v2 import ConnectorPipelineV2, ConnectorV2, EpisodesToBatch
from ..core.learner import Learner, _to_host
from ..core.rl_module import MLP, Columns, RLModule
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .dqn import frozen_copy, mean_metrics, replay_for

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class Scalar(nn.Module):
    """One trainable scalar (SAC's log-alpha), as a module so it sits in
    the parameters' ModuleDict."""

    def __init__(self, value: float = 0.0):
        super().__init__()
        self.value = nn.Parameter(torch.tensor(float(value)))


def mlp_detached(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """`mlp(x)` through detached weights: the gradient reaches x and not
    the weights (the reference's stop_gradient on a critic's params)."""
    x = x.reshape(x.shape[0], -1)
    layers = mlp.layers
    for layer in layers[:-1]:
        x = torch.tanh(nn.functional.linear(x, layer.weight.detach(), layer.bias.detach()))
    last = layers[-1]
    return nn.functional.linear(x, last.weight.detach(), last.bias.detach())


class SACModule(RLModule):
    """Squashed-Gaussian actor + twin Q critics over MLP trunks
    (reference: rllib/algorithms/sac/sac_catalog.py — pi outputs
    [mean, log_std]; Q heads consume concat(obs, action))."""

    def setup(self) -> None:
        self._hidden = tuple(self.model_config.get("fcnet_hiddens", (256, 256)))
        low = np.asarray(self.action_space.low, np.float32)
        high = np.asarray(self.action_space.high, np.float32)
        self.action_scale = (high - low) / 2.0
        self.action_center = (high + low) / 2.0
        self._scale = torch.as_tensor(self.action_scale, device=self.device)
        self._center = torch.as_tensor(self.action_center, device=self.device)

    def init_params(self, generator):
        obs, act = self.input_dim(), self.num_actions()
        return nn.ModuleDict({
            "pi": MLP(obs, self._hidden, 2 * act, generator, out_scale=0.01),
            "q1": MLP(obs + act, self._hidden, 1, generator, out_scale=1.0),
            "q2": MLP(obs + act, self._hidden, 1, generator, out_scale=1.0),
            "log_alpha": Scalar(0.0),
        }).to(self.device)

    # --------------------------------------------------------- forwards
    def forward_exploration(self, params, batch):
        dist = params["pi"](self.to_device(batch[Columns.OBS]))
        return {Columns.ACTION_DIST_INPUTS: dist}

    def forward_train(self, params, batch):
        return self.forward_exploration(params, batch)

    def q_values(self, params, obs, actions, *, frozen: bool = False):
        """Both critics on (s, a); actions are env-scale. `frozen`: the
        gradient reaches the actions and not the critics' weights."""
        obs = self.to_device(obs)
        oa = torch.cat([obs.reshape(obs.shape[0], -1), self.to_device(actions)], dim=-1)
        q = mlp_detached if frozen else (lambda mlp, x: mlp(x))
        return q(params["q1"], oa)[..., 0], q(params["q2"], oa)[..., 0]

    def sample_action(self, params, obs, eps):
        """Reparameterized tanh-Gaussian sample → (env_action, logp);
        `eps` is the standard normal draw, shaped as the actions."""
        dist = params["pi"](self.to_device(obs))
        mean, log_std = torch.chunk(dist, 2, dim=-1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        std = torch.exp(log_std)
        u = mean + std * eps
        logp_u = torch.sum(
            -0.5 * torch.square((u - mean) / std)
            - log_std
            - 0.5 * math.log(2.0 * math.pi),
            dim=-1,
        )
        t = torch.tanh(u)
        # Change of variables for the tanh squash + affine scale
        # (SAC paper appendix C).
        logp = logp_u - torch.sum(
            torch.log(self._scale * (1.0 - torch.square(t)) + 1e-6),
            dim=-1,
        )
        return t * self._scale + self._center, logp


class SampleSquashedGaussianActions(ConnectorV2):
    """module-to-env: sample env-scale actions from [mean, log_std]
    dist inputs (exploration) or pass the squashed mean (inference)."""

    def __init__(self, action_scale, action_center, explore: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.action_scale = np.asarray(action_scale, np.float32)
        self.action_center = np.asarray(action_center, np.float32)
        self.explore = explore
        self.rng = rng or np.random.default_rng()

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        dist = np.asarray(batch[Columns.ACTION_DIST_INPUTS], np.float32)
        mean, log_std = np.split(dist, 2, axis=-1)
        if kwargs.get("explore", self.explore):
            std = np.exp(np.clip(log_std, LOG_STD_MIN, LOG_STD_MAX))
            u = mean + std * self.rng.standard_normal(mean.shape).astype(
                np.float32
            )
        else:
            u = mean
        batch["actions"] = (
            np.tanh(u) * self.action_scale + self.action_center
        )
        return batch


class SACConfig(AlgorithmConfig):
    default_module_class = SACModule

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 256
        self.tau = 0.005
        self.initial_alpha = 1.0
        self.target_entropy: Optional[float] = None  # None → -act_dim
        self.replay_buffer_capacity = 100_000
        self.prioritized_replay = False
        self.per_alpha = 0.6
        self.per_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 1000
        self.sample_timesteps_per_iteration = 500
        self.updates_per_iteration = 250
        self.model_config = {"fcnet_hiddens": (256, 256)}

    @property
    def algo_class(self):
        return SAC

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            gamma=self.gamma,
            tau=self.tau,
            initial_alpha=self.initial_alpha,
            target_entropy=self.target_entropy,
            minibatch_size=None,
            num_epochs=1,
        )
        return cfg


def _actions_2d(actions: torch.Tensor) -> torch.Tensor:
    return actions[:, None] if actions.ndim == 1 else actions


class SACLearner(Learner):
    def build(self):
        super().build()
        with torch.no_grad():
            self.params["log_alpha"].value.fill_(
                float(np.log(self.config.get("initial_alpha", 1.0)))
            )
        # Target critics start as copies of the online pair.
        self.target_q = frozen_copy(
            nn.ModuleDict({"q1": self.params["q1"], "q2": self.params["q2"]})
        )
        te = self.config.get("target_entropy")
        self._target_entropy = (
            float(te) if te is not None else -float(self.module.num_actions())
        )

    def build_batch(self, episodes):
        return EpisodesToBatch()(episodes=episodes)

    def draw_noise(self, batch) -> Dict[str, torch.Tensor]:
        """Standard normal draws for the next-state and the actor's
        actions (the reference's `rng_next`, `rng_pi`)."""
        shape = (len(batch[Columns.OBS]), self.module.num_actions())
        return {"next": self._normal(*shape), "pi": self._normal(*shape)}

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        obs = batch[Columns.OBS]
        next_obs = batch[Columns.NEXT_OBS]
        actions = _actions_2d(batch[Columns.ACTIONS])
        log_alpha = params["log_alpha"].value
        alpha = torch.exp(log_alpha)

        # ---- critic loss: entropy-regularized Bellman target from the
        # polyak target pair.
        with torch.no_grad():
            a_next, logp_next = self.module.sample_action(params, next_obs, noise["next"])
            tq1, tq2 = self.module.q_values(self.target_q, next_obs, a_next)
            target = batch[Columns.REWARDS] + cfg["gamma"] * (
                1.0 - batch[Columns.TERMINATEDS]
            ) * (torch.minimum(tq1, tq2) - alpha * logp_next)
        q1, q2 = self.module.q_values(params, obs, actions)
        weights = batch.get("weights", 1.0)
        critic_loss = torch.mean(
            weights * (torch.square(q1 - target) + torch.square(q2 - target))
        )

        # ---- actor loss: reparameterized sample through FROZEN critics
        # (gradient flows to the action, not the Q weights).
        a_pi, logp_pi = self.module.sample_action(params, obs, noise["pi"])
        fq1, fq2 = self.module.q_values(params, obs, a_pi, frozen=True)
        actor_loss = torch.mean(alpha.detach() * logp_pi - torch.minimum(fq1, fq2))

        # ---- temperature: drive policy entropy toward the target.
        alpha_loss = -torch.mean(
            log_alpha * (logp_pi + self._target_entropy).detach()
        )

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha": alpha,
            "entropy": -torch.mean(logp_pi),
            "qf_mean": torch.mean(q1),
        }

    def update(self, batch, noise=None):
        metrics = super().update(batch, noise)
        self._polyak()
        return metrics

    @torch.no_grad()
    def _polyak(self) -> None:
        tau = float(self.config["tau"])
        online = [self.params[k] for k in ("q1", "q2")]
        for t, o in zip(self.target_q.values(), online):
            t_params, o_params = list(t.parameters()), list(o.parameters())
            torch._foreach_mul_(t_params, 1.0 - tau)
            torch._foreach_add_(t_params, o_params, alpha=tau)

    def td_errors(self, batch, noise=None) -> np.ndarray:
        """|TD| per transition for PER priority updates; `noise` the
        next-state draw (the learner's own where not given)."""
        batch = self.device_batch(batch)
        if noise is None:
            noise = self._normal(len(batch[Columns.OBS]), self.module.num_actions())
        with torch.no_grad():
            actions = _actions_2d(batch[Columns.ACTIONS])
            a_next, logp_next = self.module.sample_action(
                self.params, batch[Columns.NEXT_OBS], noise
            )
            tq1, tq2 = self.module.q_values(self.target_q, batch[Columns.NEXT_OBS], a_next)
            alpha = torch.exp(self.params["log_alpha"].value)
            target = batch[Columns.REWARDS] + self.config["gamma"] * (
                1.0 - batch[Columns.TERMINATEDS]
            ) * (torch.minimum(tq1, tq2) - alpha * logp_next)
            q1, _ = self.module.q_values(self.params, batch[Columns.OBS], actions)
            return torch.abs(q1 - target).cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["target_q"] = _to_host(self.target_q.state_dict())
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "target_q" in state:
            self.target_q.load_state_dict(state["target_q"])


class SAC(Algorithm):
    learner_class = SACLearner

    def setup(self, config_dict) -> None:
        super().setup(config_dict)
        self.replay = replay_for(self.config)

    def env_runner_config(self) -> Dict[str, Any]:
        runner_cfg = super().env_runner_config()
        spec = self._module_spec
        low = np.asarray(spec.action_space.low, np.float32)
        high = np.asarray(spec.action_space.high, np.float32)
        runner_cfg["module_to_env"] = ConnectorPipelineV2(
            [
                SampleSquashedGaussianActions(
                    (high - low) / 2.0,
                    (high + low) / 2.0,
                    rng=np.random.default_rng(self.config.seed),
                )
            ]
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
        assert self.learner_group.is_local, (
            "SAC uses a local learner (replay lives with the algorithm)"
        )
        learner: SACLearner = self.learner_group._local
        metrics_list = []
        for _ in range(cfg.updates_per_iteration):
            batch = self.replay.sample(cfg.train_batch_size)
            idx = batch.pop("batch_indexes")
            batch = learner.device_batch(batch)  # one copy per update
            m = learner.update(batch)
            if cfg.prioritized_replay:
                self.replay.update_priorities(idx, learner.td_errors(batch))
            metrics_list.append(m)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        out = mean_metrics(metrics_list)
        out["buffer_size"] = float(len(self.replay))
        return out
