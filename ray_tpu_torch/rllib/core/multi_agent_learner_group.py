"""MultiAgentLearnerGroup: one LearnerGroup per policy module.

Reference: the reference trains a single MultiRLModule inside one
learner (multi_rl_module.py + learner.py MultiAgentBatch path). Here
each module gets its own (possibly remote) LearnerGroup and episodes
route by their ``module_id`` tag — simpler, and the per-module update
is eager torch on its own learner's device. The facade mirrors
LearnerGroup's surface so Algorithm.training_step code is agnostic to
single- vs multi-agent.

Learner actors with `num_gpus_per_learner` unset take a card each, for
every module: where the cluster has fewer cards than all the groups'
learners together, building raises rather than queue the last group's
actors forever. On one card, use local learners (`num_learners=0`) or
a share of it (`num_gpus_per_learner=0.5`).
"""
from __future__ import annotations

from typing import Any, Dict, List

from .learner_group import LearnerGroup, _gpus_per_learner
from .multi_rl_module import MultiRLModuleSpec


class MultiAgentLearnerGroup:
    def __init__(
        self, *, learner_cls, module_spec: MultiRLModuleSpec, config
    ):
        n = config.get("num_learners", 0)
        if n and config.get("num_gpus_per_learner") is None:
            _gpus_per_learner(None, n * len(module_spec.module_specs))
        self._groups: Dict[str, LearnerGroup] = {
            mid: LearnerGroup(
                learner_cls=learner_cls, module_spec=spec, config=config
            )
            for mid, spec in module_spec.module_specs.items()
        }

    @property
    def is_local(self) -> bool:
        return all(g.is_local for g in self._groups.values())

    def update_from_episodes(self, episodes: List) -> Dict[str, Any]:
        by_module: Dict[str, List] = {}
        for ep in episodes:
            mid = getattr(ep, "module_id", None)
            if mid is None:
                raise ValueError(
                    "episode missing module_id tag — multi-agent episodes "
                    "must come from MultiAgentEnvRunner"
                )
            by_module.setdefault(mid, []).append(ep)
        out: Dict[str, Any] = {}
        for mid, eps in by_module.items():
            for k, v in self._groups[mid].update_from_episodes(eps).items():
                out[f"{mid}/{k}"] = v
        return out

    def get_weights(self) -> Dict[str, Any]:
        return {mid: g.get_weights() for mid, g in self._groups.items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for mid, w in weights.items():
            self._groups[mid].set_weights(w)

    def get_state(self) -> Dict[str, Any]:
        return {mid: g.get_state() for mid, g in self._groups.items()}

    def set_state(self, state: Dict[str, Any]) -> None:
        for mid, s in state.items():
            if mid in self._groups:
                self._groups[mid].set_state(s)

    def shutdown(self) -> None:
        for g in self._groups.values():
            g.shutdown()
