"""MARWIL + BC: offline RL from recorded experience.

Reference: rllib/algorithms/marwil/ (exponentially advantage-weighted
imitation, Wang et al. 2018) and rllib/algorithms/bc/ (BC = MARWIL with
beta=0, marwil.py:35). Training consumes a recorded sample dataset (see
rllib.offline) instead of env runners; the env is only probed for
spaces and used for explore=False evaluation rollouts.

Loss (marwil_torch_learner.py): vf trains toward the monte-carlo
return-to-go; the policy maximizes exp(beta * A / c) - weighted logp,
where c^2 is a running average of squared advantages (the paper's
normalizer): learner state, carried across updates and through
`get_state`/`set_state`, and passed to the loss in the batch as a
scalar like APPO's adaptive KL coefficient.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..connectors.connector_v2 import EpisodesToBatch
from ..core.learner import Learner
from ..core.rl_module import Columns
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0
        self.vf_coeff = 1.0
        self.grad_clip = 40.0
        self.lr = 1e-3
        self.train_batch_size = 2000
        self.input_: Any = None  # sample dir / file list (rllib "input")
        self.moving_average_sqd_adv_norm_update_rate = 1e-4

    @property
    def algo_class(self):
        return MARWIL

    def offline_data(self, *, input_=None) -> "MARWILConfig":
        if input_ is not None:
            self.input_ = input_
        return self

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            beta=self.beta,
            vf_coeff=self.vf_coeff,
            gamma=self.gamma,
            c_update_rate=self.moving_average_sqd_adv_norm_update_rate,
        )
        return cfg


class BCConfig(MARWILConfig):
    """Behavior cloning: pure -logp imitation (reference:
    rllib/algorithms/bc/bc.py — MARWIL with beta=0, no value head in
    the loss)."""

    def __init__(self):
        super().__init__()
        self.beta = 0.0
        self.vf_coeff = 0.0

    @property
    def algo_class(self):
        return BC


class MARWILLearner(Learner):
    def build(self):
        super().build()
        # c^2: running estimate of E[A^2] (paper's advantage normalizer).
        self._ma_sqd_adv = 100.0

    def build_batch(self, episodes) -> Dict[str, np.ndarray]:
        batch = EpisodesToBatch()(episodes=episodes)
        gamma = self.config["gamma"]
        returns = []
        for ep in episodes:
            r = np.asarray(ep.rewards, np.float32)
            out = np.zeros_like(r)
            acc = 0.0
            for t in range(len(r) - 1, -1, -1):
                acc = r[t] + gamma * acc
                out[t] = acc
            returns.append(out)
        batch[Columns.VALUE_TARGETS] = np.concatenate(returns)
        return batch

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        out = self.module.forward_train(params, batch)
        logits = out[Columns.ACTION_DIST_INPUTS]
        z = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        actions = batch[Columns.ACTIONS].long()
        logp = torch.take_along_dim(z, actions[:, None], dim=-1)[:, 0]

        if cfg["beta"] > 0.0:
            vf = out[Columns.VF_PREDS]
            adv = (batch[Columns.VALUE_TARGETS] - vf).detach()
            weight = torch.exp(
                torch.clamp(cfg["beta"] * adv * batch["marwil_c_inv"], -20.0, 2.0)
            )
            policy_loss = -torch.mean(weight * logp)
            vf_loss = torch.mean(torch.square(vf - batch[Columns.VALUE_TARGETS]))
            total = policy_loss + cfg["vf_coeff"] * vf_loss
            metrics = {
                "policy_loss": policy_loss,
                "vf_loss": vf_loss,
                "mean_advantage": torch.mean(adv),
                "mean_sqd_advantage": torch.mean(torch.square(adv)),
            }
        else:
            policy_loss = -torch.mean(logp)
            total = policy_loss
            metrics = {
                "policy_loss": policy_loss,
                "mean_sqd_advantage": torch.zeros((), device=logp.device),
            }
        metrics["logp_mean"] = torch.mean(logp)
        return total, metrics

    def update(self, batch, noise=None):
        if self.config["beta"] > 0.0:
            batch = dict(
                batch,
                marwil_c_inv=np.float32(
                    1.0 / float(np.sqrt(self._ma_sqd_adv) + 1e-8)
                ),
            )
        metrics = super().update(batch, noise)
        if self.config["beta"] > 0.0:
            rate = self.config.get("c_update_rate", 1e-4)
            self._ma_sqd_adv += rate * (
                metrics["mean_sqd_advantage"] - self._ma_sqd_adv
            )
            metrics["sqd_adv_norm"] = self._ma_sqd_adv
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["ma_sqd_adv"] = self._ma_sqd_adv
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "ma_sqd_adv" in state:
            self._ma_sqd_adv = state["ma_sqd_adv"]


class MARWIL(Algorithm):
    learner_class = MARWILLearner

    def setup(self, config_dict) -> None:
        super().setup(config_dict)
        if not self.config.input_:
            raise ValueError(
                "MARWIL/BC are offline algorithms: set "
                "config.offline_data(input_=<sample dir>)"
            )
        from ..offline import SampleReader

        self._reader = SampleReader(self.config.input_, seed=self.config.seed)
        self._batch_iter = self._reader.iter_episodes(
            self.config.train_batch_size
        )

    def training_step(self) -> Dict[str, Any]:
        episodes = next(self._batch_iter)
        self._record_episodes(episodes)
        return self.learner_group.update_from_episodes(episodes)

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Policy rollouts with the current learned weights (reference:
        Algorithm.evaluate)."""
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        episodes = self.env_runner_group.sample(
            num_episodes=num_episodes, explore=False
        )
        returns = [float(np.sum(ep.rewards)) for ep in episodes]
        return {
            "episode_return_mean": float(np.mean(returns)),
            "num_episodes": len(returns),
        }


class BC(MARWIL):
    pass
