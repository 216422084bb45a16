"""MultiAgentEnvRunner: samples per-agent episodes from a MultiAgentEnv.

Reference: rllib/env/multi_agent_env_runner.py — one (non-vectorized)
multi-agent env per runner; each tick groups the live agents by the
module their policy_mapping_fn assigns, forwards each module once on
its group's stacked observations, and scatters sampled actions back
into the env's action dict. Output is per-agent SingleAgentEpisode
chunks tagged with ``module_id`` so the learner side can route each
trajectory to its policy's learner. Runs on CPU actors, which see no
card: each module's forward is torch on the CPU under no_grad, with
the learners' weights pushed as host copies.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..connectors.connector_v2 import (
    ConnectorPipelineV2,
    SampleCategoricalActions,
)
from .episode import SingleAgentEpisode


class MultiAgentEnvRunner:
    def __init__(self, config_blob: bytes, worker_index: int = 0):
        import pickle

        cfg = pickle.loads(config_blob)
        self.config = cfg
        self.worker_index = worker_index
        seed = (cfg.get("seed") or 0) + 1000 * worker_index
        self._rng = np.random.default_rng(seed)
        env_spec = cfg["env"]
        assert callable(env_spec), (
            "multi-agent env must be a callable env maker"
        )
        self.env = env_spec(cfg.get("env_config") or {})
        self.policy_mapping_fn = cfg["policy_mapping_fn"]

        spec = cfg["module_spec"]  # MultiRLModuleSpec
        for mid, mspec in spec.module_specs.items():
            if mspec.observation_space is None or mspec.action_space is None:
                aid = self._agent_for_module(mid)
                mspec.observation_space = self.env.observation_space(aid)
                mspec.action_space = self.env.action_space(aid)
        self.module = spec.build("cpu")
        with torch.no_grad():
            self.params = self.module.init_params(
                torch.Generator().manual_seed(seed)
            )
        self.module_to_env = cfg.get("module_to_env") or ConnectorPipelineV2(
            [SampleCategoricalActions(rng=self._rng)]
        )

        self._obs: Optional[Dict[str, Any]] = None
        self._episodes: Dict[str, SingleAgentEpisode] = {}
        self._total_steps = 0
        self._return_acc: Dict[str, float] = {}
        # Rewards delivered on ticks where the agent had no action
        # (turn-based envs) — credited to the agent's next recorded
        # step so the trajectory's reward stream stays complete.
        self._pending_rew: Dict[str, float] = {}
        self._completed_returns: List[float] = []
        self._module_returns: Dict[str, List[float]] = {}

    def _agent_for_module(self, module_id: str) -> str:
        for aid in self.env.possible_agents:
            if self.policy_mapping_fn(aid) == module_id:
                return aid
        raise ValueError(f"no agent maps to module {module_id!r}")

    # ----------------------------------------------------------- weights
    def set_weights(self, weights: Dict[str, Any]) -> None:
        """Host copies (state dicts) of some or all modules' weights."""
        for mid, w in weights.items():
            self.params[mid].load_state_dict(w)

    def get_weights(self) -> Dict[str, Any]:
        return {
            mid: {k: v.clone() for k, v in p.state_dict().items()}
            for mid, p in self.params.items()
        }

    # ------------------------------------------------------------ sample
    def _forward_module(self, module_id: str, obs: np.ndarray):
        # Rollouts stay on the host CPU — the learners own the card.
        with torch.no_grad():
            out = self.module[module_id].forward_exploration(
                self.params[module_id], {"obs": obs}
            )
        return {k: v.numpy() for k, v in out.items()}

    def _reset(self):
        obs, _ = self.env.reset(seed=int(self._rng.integers(0, 2**31)))
        self._obs = obs
        self._episodes = {
            aid: SingleAgentEpisode(initial_observation=o)
            for aid, o in obs.items()
        }
        self._return_acc = {aid: 0.0 for aid in obs}
        self._pending_rew = {}

    def sample(
        self,
        *,
        num_timesteps: Optional[int] = None,
        num_episodes: Optional[int] = None,
        explore: bool = True,
    ) -> List[SingleAgentEpisode]:
        """Collect env steps (one per tick regardless of agent count) or
        complete multi-agent episodes; returns per-agent chunks."""
        if self._obs is None:
            self._reset()
        if num_timesteps is None and num_episodes is None:
            num_timesteps = self.config.get("rollout_fragment_length", 200)
        done_eps: List[SingleAgentEpisode] = []
        completed_episodes = 0
        steps = 0
        while True:
            live = [aid for aid in self._obs if aid in self._episodes]
            by_module: Dict[str, List[str]] = {}
            for aid in live:
                by_module.setdefault(self.policy_mapping_fn(aid), []).append(
                    aid
                )
            action_dict: Dict[str, Any] = {}
            extras: Dict[str, Dict[str, Any]] = {}
            for mid, aids in by_module.items():
                obs = np.stack(
                    [np.asarray(self._obs[a], np.float32) for a in aids]
                )
                outs = self._forward_module(mid, obs)
                outs = self.module_to_env(
                    batch=outs, episodes=None, explore=explore
                )
                for i, aid in enumerate(aids):
                    action_dict[aid] = outs["actions"][i]
                    extras[aid] = {
                        k: outs[k][i]
                        for k in ("action_logp",)
                        if k in outs
                    }
            obs, rewards, terms, truncs, _ = self.env.step(action_dict)
            finished_now: set = set()
            for aid in action_dict:
                ep = self._episodes[aid]
                r = rewards.get(aid, 0.0) + self._pending_rew.pop(aid, 0.0)
                self._return_acc[aid] += r
                ep.add_env_step(
                    obs.get(aid, self._obs[aid]),
                    action_dict[aid],
                    r,
                    terminated=bool(terms.get(aid, False)),
                    truncated=bool(truncs.get(aid, False)),
                    extra_model_outputs=extras[aid],
                )
                if ep.is_done:
                    finished_now.add(aid)
                    done_eps.append(self._finish(aid, ep))
            # Rewards for agents that did not act this tick (turn-based
            # envs): accumulate into the return now, credit the reward
            # to the agent's next recorded step.
            for aid, r in rewards.items():
                if aid in action_dict or aid not in self._episodes:
                    continue
                self._return_acc[aid] = self._return_acc.get(aid, 0.0) + r
                self._pending_rew[aid] = self._pending_rew.get(aid, 0.0) + r
            # Agents appearing mid-episode get a fresh trajectory from
            # their first observation (the API allows agents to
            # appear/disappear between steps).
            for aid, o in obs.items():
                if aid not in self._episodes and aid not in finished_now:
                    self._episodes[aid] = SingleAgentEpisode(
                        initial_observation=o
                    )
                    self._return_acc.setdefault(aid, 0.0)
            self._obs = {
                aid: o for aid, o in obs.items() if aid in self._episodes
            }
            steps += 1
            self._total_steps += 1
            if terms.get("__all__") or truncs.get("__all__"):
                # Flush agents the env never individually terminated.
                for aid, ep in list(self._episodes.items()):
                    if len(ep) > 0:
                        ep.is_truncated = True
                        done_eps.append(self._finish(aid, ep))
                completed_episodes += 1
                self._reset()
            if num_episodes is not None:
                if completed_episodes >= num_episodes:
                    return done_eps
            elif steps >= num_timesteps:
                # Cut live episodes into shipped chunks.
                for aid, ep in list(self._episodes.items()):
                    if len(ep) > 0:
                        mid = self.policy_mapping_fn(aid)
                        chunk = ep.finalize()
                        chunk.module_id = mid
                        chunk.agent_id = aid
                        done_eps.append(chunk)
                        self._episodes[aid] = SingleAgentEpisode(
                            initial_observation=np.asarray(
                                chunk.observations[-1]
                            )
                        )
                return done_eps

    def _finish(self, aid: str, ep: SingleAgentEpisode) -> SingleAgentEpisode:
        mid = self.policy_mapping_fn(aid)
        # Credit any off-turn reward that never met another action step
        # to the final recorded step (the return already counted it).
        leftover = self._pending_rew.pop(aid, 0.0)
        if leftover and ep.rewards:
            ep.rewards[-1] += leftover
        ret = float(self._return_acc[aid])
        self._completed_returns.append(ret)
        self._module_returns.setdefault(mid, []).append(ret)
        self._return_acc[aid] = 0.0
        del self._episodes[aid]
        chunk = ep.finalize()
        chunk.module_id = mid
        chunk.agent_id = aid
        return chunk

    # ------------------------------------------------------------- misc
    def stats(self) -> Dict[str, Any]:
        return {
            "total_env_steps": self._total_steps,
            "worker_index": self.worker_index,
        }

    def get_metrics(self) -> Dict[str, Any]:
        out = {
            "episode_returns": self._completed_returns,
            "module_returns": self._module_returns,
        }
        self._completed_returns = []
        self._module_returns = {}
        return out

    def ping(self) -> str:
        return "ok"
