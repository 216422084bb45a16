"""PPO: clipped-surrogate policy optimization.

Reference: rllib/algorithms/ppo/ppo.py (training_step:419) +
ppo_torch_learner loss. training_step = synchronous parallel sampling →
learner update (GAE + N epochs of minibatch SGD, eager torch on the
learner's device) → weight broadcast to env runners.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..connectors.connector_v2 import EpisodesToBatch, GeneralAdvantageEstimation
from ..core.learner import Learner
from ..core.rl_module import Columns
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.0  # adaptive-KL off by default (clip does the work)
        self.kl_target = 0.01
        self.num_epochs = 8
        self.minibatch_size = 128
        self.train_batch_size = 2000
        self.lr = 5e-4

    @property
    def algo_class(self):
        return PPO

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            lambda_=self.lambda_,
            clip_param=self.clip_param,
            vf_clip_param=self.vf_clip_param,
            vf_loss_coeff=self.vf_loss_coeff,
            entropy_coeff=self.entropy_coeff,
            kl_coeff=self.kl_coeff,
            gamma=self.gamma,
        )
        return cfg


class PPOLearner(Learner):
    """Loss matches the reference PPO learner: clipped surrogate +
    clipped value loss + entropy bonus (ppo/torch/ppo_torch_learner.py)."""

    def build(self):
        super().build()
        self._batch_pipeline = EpisodesToBatch()

    def build_batch(self, episodes) -> Dict[str, np.ndarray]:
        batch = self._batch_pipeline(episodes=episodes)
        gae = GeneralAdvantageEstimation(
            gamma=self.config["gamma"],
            lambda_=self.config["lambda_"],
            values_fn=self._batched_values,
        )
        batch = gae(batch=batch, episodes=episodes)
        # Advantage standardization (reference: PPO's
        # standardize_fields=["advantages"]).
        adv = batch[Columns.ADVANTAGES]
        batch[Columns.ADVANTAGES] = (adv - adv.mean()) / max(adv.std(), 1e-4)
        return batch

    def _batched_values(self, obs_list):
        """The value net over ALL episodes in one forward, on the
        learner's device (the reference pads to a bucket so that XLA
        compiles once; eager torch needs no padding)."""
        lens = [len(o) for o in obs_list]
        with torch.no_grad():
            values = self.module.compute_values(
                self.params, np.concatenate(obs_list)
            ).cpu().numpy()
        out, off = [], 0
        for L in lens:
            out.append(values[off : off + L])
            off += L
        return out

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        out = self.module.forward_train(params, batch)
        logits = out[Columns.ACTION_DIST_INPUTS]
        logp_all = _log_softmax(logits)
        actions = torch.as_tensor(batch[Columns.ACTIONS], device=logits.device).long()
        logp = torch.take_along_dim(logp_all, actions[:, None], dim=-1)[:, 0]
        old_logp = self.module.to_device(batch[Columns.ACTION_LOGP])
        ratio = torch.exp(logp - old_logp)
        adv = self.module.to_device(batch[Columns.ADVANTAGES])
        surrogate = torch.minimum(
            adv * ratio,
            adv * torch.clamp(ratio, 1 - cfg["clip_param"], 1 + cfg["clip_param"]),
        )
        policy_loss = -torch.mean(surrogate)

        vf = out[Columns.VF_PREDS]
        vf_err = torch.square(vf - self.module.to_device(batch[Columns.VALUE_TARGETS]))
        vf_loss = torch.mean(torch.clamp(vf_err, 0, cfg["vf_clip_param"]))

        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = (
            policy_loss
            + cfg["vf_loss_coeff"] * vf_loss
            - cfg["entropy_coeff"] * entropy
        )
        mean_kl = torch.mean(old_logp - logp)
        if cfg.get("kl_coeff"):
            total = total + cfg["kl_coeff"] * mean_kl
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": mean_kl,
        }


def _log_softmax(logits):
    """The reference's log-softmax, step for step."""
    z = logits - torch.amax(logits, dim=-1, keepdim=True)
    return z - torch.log(torch.sum(torch.exp(z), dim=-1, keepdim=True))


class PPO(Algorithm):
    learner_class = PPOLearner

    def training_step(self) -> Dict[str, Any]:
        episodes = self.env_runner_group.sample(
            num_timesteps=self.config.train_batch_size
        )
        self._record_episodes(episodes)
        metrics = self.learner_group.update_from_episodes(episodes)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return metrics
