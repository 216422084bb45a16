"""APPO: asynchronous PPO (IMPALA pipeline + clipped surrogate).

Reference: rllib/algorithms/appo/ — the IMPALA architecture (continuous
async sampling, V-trace off-policy correction) with PPO's clipped
surrogate objective replacing the plain policy gradient, plus an
optional KL penalty against a slow-moving target policy
(appo.py:88-104, appo_torch_learner.py). The learner update is eager
torch on the learner's device; the target policy is a detached copy
there, refreshed every `target_network_update_freq` updates like DQN's
target.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.learner import _to_host
from ..core.rl_module import Columns
from .dqn import frozen_copy
from .impala import IMPALA, IMPALAConfig, IMPALALearner


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.4
        self.use_kl_loss = False
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        # In learner updates (reference counts target updates in env
        # steps; one update == one train batch here).
        self.target_network_update_freq = 2

    @property
    def algo_class(self):
        return APPO

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            clip_param=self.clip_param,
            use_kl_loss=self.use_kl_loss,
            kl_coeff=self.kl_coeff,
            kl_target=self.kl_target,
            target_network_update_freq=self.target_network_update_freq,
        )
        return cfg


class APPOLearner(IMPALALearner):
    """V-trace targets exactly as IMPALA; the policy term swaps the
    plain PG for PPO's clipped surrogate, with the ratio taken against
    the behavior policy's logp recorded at sample time."""

    def build(self):
        super().build()
        self.target_params = frozen_copy(self.params)
        self._updates = 0
        # The adaptive KL coefficient changes between updates, not
        # within one: it rides in the batch as a scalar.
        self._kl_coeff = float(self.config.get("kl_coeff", 0.2))

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        z, target_logp, pg_adv, vf_loss, entropy, rho, denom = self._advantages(params, batch)
        mask = batch["mask"]
        # ---- PPO clip on the importance ratio (the APPO difference).
        ratio = torch.exp(target_logp - batch["action_logp"])
        clipped = torch.clamp(ratio, 1.0 - cfg["clip_param"], 1.0 + cfg["clip_param"])
        surrogate = torch.minimum(ratio * pg_adv, clipped * pg_adv)
        policy_loss = -torch.sum(surrogate * mask) / denom
        total = (
            policy_loss
            + cfg["vf_loss_coeff"] * vf_loss
            - cfg["entropy_coeff"] * entropy
        )
        metrics = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": torch.sum(rho * mask) / denom,
        }
        if cfg.get("use_kl_loss"):
            # KL(target || online) against the slow policy, averaged
            # over valid steps (reference: appo_torch_learner KL term).
            B, T = batch["actions"].shape
            obs_flat = batch["obs"].reshape((B * T,) + batch["obs"].shape[2:])
            with torch.no_grad():
                t_logits = self.module.forward_train(
                    self.target_params, {Columns.OBS: obs_flat}
                )[Columns.ACTION_DIST_INPUTS].reshape(B, T, -1)
                tz = t_logits - torch.logsumexp(t_logits, dim=-1, keepdim=True)
            kl = torch.sum(torch.exp(tz) * (tz - z), dim=-1)
            mean_kl = torch.sum(kl * mask) / denom
            total = total + batch["appo_kl_coeff"] * mean_kl
            metrics["mean_kl"] = mean_kl
        return total, metrics

    def update(self, batch, noise=None):
        if self.config.get("use_kl_loss"):
            batch = dict(batch, appo_kl_coeff=np.float32(self._kl_coeff))
        metrics = super().update(batch, noise)
        self._updates += 1
        if self.config.get("use_kl_loss") and "mean_kl" in metrics:
            # Reference's adaptive KL: 1.5x band around the target.
            if metrics["mean_kl"] > 2.0 * self.config["kl_target"]:
                self._kl_coeff *= 1.5
            elif metrics["mean_kl"] < 0.5 * self.config["kl_target"]:
                self._kl_coeff *= 0.5
            metrics["kl_coeff"] = self._kl_coeff
        if self._updates % max(
            1, int(self.config.get("target_network_update_freq", 2))
        ) == 0:
            with torch.no_grad():
                self.target_params.load_state_dict(self.params.state_dict())
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["target_params"] = _to_host(self.target_params.state_dict())
        state["updates"] = self._updates
        state["kl_coeff"] = self._kl_coeff
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "target_params" in state:
            self.target_params.load_state_dict(state["target_params"])
            self._updates = state["updates"]
            self._kl_coeff = state["kl_coeff"]


class APPO(IMPALA):
    learner_class = APPOLearner
