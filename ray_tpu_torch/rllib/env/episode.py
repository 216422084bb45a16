"""SingleAgentEpisode: the trajectory container.

Reference: rllib/env/single_agent_episode.py — append-only arrays of
observations/actions/rewards plus per-step extra model outputs (e.g.
action logp), finalized to numpy for transport between env runners and
learners.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class SingleAgentEpisode:
    def __init__(self, initial_observation=None):
        self.observations: List[Any] = (
            [] if initial_observation is None else [initial_observation]
        )
        self.actions: List[Any] = []
        self.rewards: List[float] = []
        self.extra_model_outputs: Dict[str, List[Any]] = {}
        self.is_terminated = False
        self.is_truncated = False
        self._finalized = False

    def add_env_step(
        self,
        observation,
        action,
        reward: float,
        *,
        terminated: bool = False,
        truncated: bool = False,
        extra_model_outputs: Optional[Dict[str, Any]] = None,
    ) -> None:
        assert not self._finalized
        self.observations.append(observation)
        self.actions.append(action)
        self.rewards.append(float(reward))
        self.is_terminated = terminated
        self.is_truncated = truncated
        for k, v in (extra_model_outputs or {}).items():
            self.extra_model_outputs.setdefault(k, []).append(v)

    def __len__(self) -> int:
        return len(self.actions)

    @property
    def is_done(self) -> bool:
        return self.is_terminated or self.is_truncated

    def get_return(self) -> float:
        return float(sum(self.rewards))

    def finalize(self) -> "SingleAgentEpisode":
        """Convert python lists to stacked numpy arrays for transport."""
        if not self._finalized:
            self.observations = np.stack([np.asarray(o) for o in self.observations])
            self.actions = np.asarray(self.actions)
            self.rewards = np.asarray(self.rewards, dtype=np.float32)
            self.extra_model_outputs = {
                k: np.asarray(v) for k, v in self.extra_model_outputs.items()
            }
            self._finalized = True
        return self

    def cut(self) -> "SingleAgentEpisode":
        """Continue an unfinished episode in a fresh chunk starting from
        the last observation (reference: episode.cut for truncation at
        sample boundaries)."""
        chunk = SingleAgentEpisode(initial_observation=self.observations[-1])
        return chunk
