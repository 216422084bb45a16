"""Connector-v2: composable transforms between env, module, and learner.

Reference: rllib/connectors/connector_v2.py:18 +
connector_pipeline_v2.py:18. Three pipeline positions:
env-to-module (raw observations → inference batch), module-to-env
(module outputs → env actions), and learner (episodes → train batch).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class ConnectorV2:
    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        raise NotImplementedError


class ConnectorPipelineV2(ConnectorV2):
    def __init__(self, connectors: Optional[List[ConnectorV2]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        for c in self.connectors:
            batch = c(rl_module=rl_module, batch=batch, episodes=episodes, **kwargs)
        return batch


# ----------------------------------------------------------- env-to-module
class BatchObservations(ConnectorV2):
    """Stack per-env current observations into the inference batch
    (reference: AddObservationsFromEpisodesToBatch + BatchIndividualItems)."""

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        obs = np.stack([np.asarray(ep.observations[-1]) for ep in episodes])
        return {"obs": obs.astype(np.float32)}


# ----------------------------------------------------------- module-to-env
class SampleCategoricalActions(ConnectorV2):
    """Sample discrete actions from logits; record logp so PPO's loss
    can importance-weight (reference: GetActions + action-dist
    connectors)."""

    def __init__(self, explore: bool = True, rng: Optional[np.random.Generator] = None):
        self.explore = explore
        self.rng = rng or np.random.default_rng()

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        logits = np.asarray(batch["action_dist_inputs"], np.float32)
        z = logits - logits.max(axis=-1, keepdims=True)
        logp_all = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
        if kwargs.get("explore", self.explore):
            # Gumbel-max sampling, vectorized over envs.
            g = self.rng.gumbel(size=logits.shape)
            actions = np.argmax(logits + g, axis=-1)
        else:
            actions = np.argmax(logits, axis=-1)
        logp = np.take_along_axis(logp_all, actions[:, None], axis=-1)[:, 0]
        batch["actions"] = actions
        batch["action_logp"] = logp.astype(np.float32)
        return batch


class EpsilonGreedyActions(ConnectorV2):
    """ε-greedy over Q-values for value-based algorithms (DQN)."""

    def __init__(self, epsilon_fn, rng: Optional[np.random.Generator] = None):
        self.epsilon_fn = epsilon_fn  # step -> epsilon
        self.rng = rng or np.random.default_rng()
        self.step = 0

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        q = np.asarray(batch["q_values"] if "q_values" in batch
                       else batch["action_dist_inputs"])
        eps = (
            self.epsilon_fn(self.step)
            if kwargs.get("explore", True)
            else 0.0
        )
        self.step += q.shape[0]
        greedy = np.argmax(q, axis=-1)
        random = self.rng.integers(0, q.shape[-1], size=q.shape[0])
        mask = self.rng.random(q.shape[0]) < eps
        batch["actions"] = np.where(mask, random, greedy)
        return batch


# --------------------------------------------------------------- learner
class EpisodesToBatch(ConnectorV2):
    """Concatenate finalized episodes into one flat train batch with
    per-timestep columns (reference: learner pipeline batching)."""

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        out: Dict[str, Any] = {
            "obs": np.concatenate([ep.observations[:-1] for ep in episodes]),
            "next_obs": np.concatenate([ep.observations[1:] for ep in episodes]),
            "actions": np.concatenate([ep.actions for ep in episodes]),
            "rewards": np.concatenate([ep.rewards for ep in episodes]),
            "terminateds": np.concatenate(
                [
                    _done_mask(len(ep), ep.is_terminated)
                    for ep in episodes
                ]
            ),
        }
        for key in episodes[0].extra_model_outputs:
            out[key] = np.concatenate(
                [ep.extra_model_outputs[key] for ep in episodes]
            )
        out["obs"] = out["obs"].astype(np.float32)
        out["next_obs"] = out["next_obs"].astype(np.float32)
        return out


class GeneralAdvantageEstimation(ConnectorV2):
    """GAE(λ) per episode, appended as advantages/value_targets columns
    (reference: rllib/connectors/learner/general_advantage_estimation.py)."""

    def __init__(self, gamma: float = 0.99, lambda_: float = 0.95,
                 values_fn=None):
        self.gamma = gamma
        self.lambda_ = lambda_
        # (list of obs[T_i+1, ...]) -> list of values[T_i+1]; batched so
        # the value net runs one forward for all episodes.
        self.values_fn = values_fn

    def __call__(self, *, rl_module=None, batch=None, episodes=None, **kwargs):
        obs_list = [np.asarray(ep.observations, np.float32) for ep in episodes]
        values_list = self.values_fn(obs_list)
        advantages, targets, vf_preds = [], [], []
        for ep, values in zip(episodes, values_list):
            values = np.asarray(values, np.float32)
            rewards = np.asarray(ep.rewards, np.float32)
            T = len(rewards)
            # Bootstrap value is 0 at true terminations, V(s_T) otherwise.
            last_v = 0.0 if ep.is_terminated else float(values[T])
            adv = np.zeros(T, np.float32)
            gae = 0.0
            for t in range(T - 1, -1, -1):
                next_v = last_v if t == T - 1 else values[t + 1]
                delta = rewards[t] + self.gamma * next_v - values[t]
                gae = delta + self.gamma * self.lambda_ * gae
                adv[t] = gae
            advantages.append(adv)
            targets.append(adv + values[:T])
            vf_preds.append(values[:T])
        batch = dict(batch or {})
        batch["advantages"] = np.concatenate(advantages)
        batch["value_targets"] = np.concatenate(targets)
        batch["vf_preds"] = np.concatenate(vf_preds)
        return batch


def _done_mask(length: int, terminated: bool) -> np.ndarray:
    m = np.zeros(length, np.float32)
    if terminated and length:
        m[-1] = 1.0
    return m
