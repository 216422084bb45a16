"""CQL: conservative Q-learning for offline RL.

Reference: rllib/algorithms/cql/ — SAC's actor/twin-critic/temperature
machinery trained purely from a recorded dataset, with the CQL(H)
conservative regularizer pushing Q down on out-of-distribution actions
(logsumexp over random + policy actions, importance-corrected) and up
on dataset actions, plus a behavior-cloning warm-start for the actor.
Rides the same offline IO as MARWIL/BC and the SAC learner's summed
loss; the conservative term adds batched critic sweeps over tiled
(s, a') pairs, all in the same eager torch step on the learner's
device. Its random and policy actions come from draws passed in, as
SAC's do.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.rl_module import Columns
from ..utils.replay_buffers import ReplayBuffer
from .dqn import mean_metrics
from .sac import SAC, SACConfig, SACLearner, _actions_2d


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.input_: Any = None  # offline sample dir (rllib "input")
        # CQL(H) knobs (reference: cql/cql.py defaults).
        self.cql_n_actions = 4  # sampled actions per source per state
        self.min_q_weight = 5.0
        self.bc_iters = 200  # actor warm-start: BC before SAC objective
        self.num_steps_sampled_before_learning_starts = 0

    @property
    def algo_class(self):
        return CQL

    def offline_data(self, *, input_=None) -> "CQLConfig":
        if input_ is not None:
            self.input_ = input_
        return self

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            cql_n_actions=self.cql_n_actions,
            min_q_weight=self.min_q_weight,
        )
        return cfg


class CQLLearner(SACLearner):
    """SAC losses + the conservative regularizer; `bc_phase` rides in
    the batch as a scalar (1.0 during the BC warm-start, then 0.0)."""

    def draw_noise(self, batch) -> Dict[str, torch.Tensor]:
        """SAC's draws, plus the conservative term's: uniform random
        actions in [-1, 1) and normal draws for the policy's actions at s
        and s', N per state (the reference's `rng_r`, `rng_pi`, `rng_pi2`)."""
        noise = super().draw_noise(batch)
        shape = (int(self.config["cql_n_actions"]) * len(batch[Columns.OBS]),
                 self.module.num_actions())
        noise["rand"] = 2.0 * self._uniform(*shape) - 1.0
        noise["cql_pi"] = self._normal(*shape)
        noise["cql_pi2"] = self._normal(*shape)
        return noise

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        total, metrics = super().compute_loss(params, batch, noise)

        obs = batch[Columns.OBS]
        next_obs = batch[Columns.NEXT_OBS]
        actions = _actions_2d(batch[Columns.ACTIONS])
        B = obs.shape[0]
        N = int(cfg["cql_n_actions"])

        def tile(x):
            return torch.repeat_interleave(x, N, dim=0)  # [N*B, ...]

        scale, center = self.module._scale, self.module._center
        # Random actions, importance-corrected by the uniform density.
        rand_a = noise["rand"] * scale + center
        logp_rand = -torch.sum(torch.log(2.0 * scale))
        # Policy actions at s and s' (reparameterized, density-corrected).
        a_pi, logp_pi = self.module.sample_action(params, tile(obs), noise["cql_pi"])
        a_pi2, logp_pi2 = self.module.sample_action(params, tile(next_obs), noise["cql_pi2"])

        def cat_q(qname):
            mlp = params[qname]

            def q(o, a):
                oa = torch.cat([o.reshape(o.shape[0], -1), a], dim=-1)
                return mlp(oa)[..., 0]

            # tile() = repeat along axis 0: flat index k = b*N + n, so
            # the [N, B] view is reshape(B, N).T — reshape(N, B) would
            # mix DIFFERENT states into one logsumexp column.
            def nb(v):
                return v.reshape(B, N).T

            q_rand = nb(q(tile(obs), rand_a)) - logp_rand
            q_p = nb(q(tile(obs), a_pi.detach())) - nb(logp_pi.detach())
            q_p2 = nb(q(tile(obs), a_pi2.detach())) - nb(logp_pi2.detach())
            return torch.cat([q_rand, q_p, q_p2], dim=0)  # [3N, B]

        q1_data, q2_data = self.module.q_values(params, obs, actions)
        cql1 = torch.mean(torch.logsumexp(cat_q("q1"), dim=0) - q1_data)
        cql2 = torch.mean(torch.logsumexp(cat_q("q2"), dim=0) - q2_data)
        conservative = cfg["min_q_weight"] * (cql1 + cql2)

        # BC warm-start: replace the SAC actor objective with the
        # dataset-action log-likelihood for the first bc_iters updates.
        bc_phase = batch.get("bc_phase", torch.zeros((), device=obs.device))
        dist = params["pi"](obs)
        mean, log_std = torch.chunk(dist, 2, dim=-1)
        log_std = torch.clamp(log_std, -20.0, 2.0)
        # Invert the tanh squash on dataset actions (clipped for
        # numerical safety at the bounds).
        u_data = torch.atanh(
            torch.clamp((actions - center) / scale, -0.999999, 0.999999)
        )
        bc_logp = torch.sum(
            -0.5 * torch.square((u_data - mean) / torch.exp(log_std))
            - log_std
            - 0.5 * math.log(2.0 * math.pi),
            dim=-1,
        )
        bc_loss = -torch.mean(bc_logp)
        # total already includes the SAC actor loss; fade it out during
        # the BC phase by adding (bc - actor) weighted by bc_phase.
        total = total + conservative + bc_phase * (
            bc_loss - metrics["actor_loss"]
        )
        metrics.update(
            cql_loss=conservative, bc_loss=bc_loss, bc_phase=bc_phase
        )
        return total, metrics


class CQL(SAC):
    """Offline: the replay buffer is loaded once from the dataset and
    the env runners are used only by evaluate()."""

    learner_class = CQLLearner

    def setup(self, config_dict) -> None:
        super().setup(config_dict)
        cfg = self.config
        if not cfg.input_:
            raise ValueError(
                "CQL is an offline algorithm: set "
                "config.offline_data(input_=<sample dir>)"
            )
        from ..offline import SampleReader

        episodes = SampleReader(cfg.input_, seed=cfg.seed).read_all()
        # Offline training wants the whole dataset resident; grow past
        # the configured capacity only as far as the data requires.
        n_transitions = sum(len(ep) for ep in episodes)
        self.replay = ReplayBuffer(
            max(cfg.replay_buffer_capacity, n_transitions), seed=cfg.seed
        )
        self.replay.add_episodes(episodes)
        self._updates = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        assert self.learner_group.is_local
        learner: CQLLearner = self.learner_group._local
        metrics_list = []
        for _ in range(cfg.updates_per_iteration):
            batch = self.replay.sample(cfg.train_batch_size)
            batch.pop("batch_indexes", None)
            batch["bc_phase"] = np.float32(
                1.0 if self._updates < cfg.bc_iters else 0.0
            )
            metrics_list.append(learner.update(dict(batch)))
            self._updates += 1
        # No env sampling during training; evaluate() syncs weights.
        return mean_metrics(metrics_list)

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        episodes = self.env_runner_group.sample(
            num_episodes=num_episodes, explore=False
        )
        returns = [float(np.sum(ep.rewards)) for ep in episodes]
        return {
            "episode_return_mean": float(np.mean(returns)),
            "num_episodes": len(returns),
        }
