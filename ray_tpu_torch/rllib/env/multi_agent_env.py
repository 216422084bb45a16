"""MultiAgentEnv: the N-agents-one-environment API.

Reference: rllib/env/multi_agent_env.py — reset/step speak per-agent
dicts keyed by agent id; termination dicts carry the special "__all__"
key ending the whole episode; agents may appear/disappear between
steps. ``make_multi_agent`` wraps a single-agent gym env into N
independent copies sharing one step clock (reference
multi_agent_env.py:414 make_multi_agent).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set, Tuple, Union


class MultiAgentEnv:
    """Subclass and implement reset() and step().

    - ``possible_agents``: all agent ids that may ever appear.
    - ``observation_space(agent_id)`` / ``action_space(agent_id)``.
    - ``reset() -> (obs_dict, info_dict)``
    - ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
      infos)`` — all per-agent dicts; terminateds/truncateds also carry
      "__all__".
    """

    possible_agents: Tuple[str, ...] = ()

    def observation_space(self, agent_id: str):
        raise NotImplementedError

    def action_space(self, agent_id: str):
        raise NotImplementedError

    def reset(
        self, *, seed: Optional[int] = None
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(
        self, action_dict: Dict[str, Any]
    ) -> Tuple[
        Dict[str, Any],
        Dict[str, float],
        Dict[str, bool],
        Dict[str, bool],
        Dict[str, Any],
    ]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class _IndependentCopies(MultiAgentEnv):
    """N copies of a single-agent env behind the multi-agent API; copy i
    is agent ``agent_{i}``. Episodes end when every copy is done."""

    def __init__(self, env_maker: Callable[[], Any], num_agents: int):
        self._envs = {f"agent_{i}": env_maker() for i in range(num_agents)}
        self.possible_agents = tuple(self._envs)
        self._done: Set[str] = set()

    def observation_space(self, agent_id: str):
        return self._envs[agent_id].observation_space

    def action_space(self, agent_id: str):
        return self._envs[agent_id].action_space

    def reset(self, *, seed=None):
        self._done = set()
        obs, infos = {}, {}
        for i, (aid, env) in enumerate(self._envs.items()):
            o, info = env.reset(seed=None if seed is None else seed + i)
            obs[aid], infos[aid] = o, info
        return obs, infos

    def step(self, action_dict):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for aid, action in action_dict.items():
            if aid in self._done:
                continue
            o, r, te, tr, info = self._envs[aid].step(action)
            obs[aid], rewards[aid] = o, float(r)
            terms[aid], truncs[aid] = bool(te), bool(tr)
            infos[aid] = info
            if te or tr:
                self._done.add(aid)
        terms["__all__"] = len(self._done) == len(self._envs)
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, infos

    def close(self):
        for env in self._envs.values():
            env.close()


def agent_id_mapping(agent_id: str) -> str:
    """Picklable default policy_mapping_fn: one module per agent id."""
    return agent_id


class ConstantMapping:
    """Picklable mapping sending every agent to one shared module."""

    def __init__(self, module_id: str):
        self.module_id = module_id

    def __call__(self, agent_id: str) -> str:
        return self.module_id


class _MultiAgentMaker:
    """Picklable env-maker returned by make_multi_agent (closures can't
    ship to remote env-runner actors)."""

    def __init__(self, env_spec: Union[str, Callable], num_agents: int):
        self.env_spec = env_spec
        self.num_agents = num_agents

    def __call__(
        self, env_config: Optional[Dict[str, Any]] = None
    ) -> MultiAgentEnv:
        import functools

        import gymnasium as gym

        cfg = dict(env_config or {})
        n = int(cfg.pop("num_agents", self.num_agents))
        if callable(self.env_spec):
            return _IndependentCopies(
                functools.partial(self.env_spec, cfg), n
            )
        return _IndependentCopies(
            functools.partial(gym.make, self.env_spec, **cfg), n
        )


def make_multi_agent(
    env_spec: Union[str, Callable], num_agents: int = 2
) -> Callable[[Dict[str, Any]], MultiAgentEnv]:
    """Factory: multi-agent wrapper of ``num_agents`` independent
    copies of a gym env id or env-maker callable."""
    return _MultiAgentMaker(env_spec, num_agents)
