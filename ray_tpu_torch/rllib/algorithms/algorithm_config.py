"""AlgorithmConfig: fluent builder for RL algorithms.

Reference: rllib/algorithms/algorithm_config.py — chained
``.environment().env_runners().training().build()``. Each algorithm
subclasses it with algorithm-specific training knobs.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Type, Union

from ..core.rl_module import DiscretePolicyModule, RLModuleSpec


class AlgorithmConfig:
    algo_class: Optional[type] = None
    default_module_class: type = DiscretePolicyModule

    def __init__(self):
        # environment
        self.env: Union[str, Callable, None] = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 1
        self.num_cpus_per_env_runner = 1
        self.rollout_fragment_length = 200
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 4000
        self.minibatch_size: Optional[int] = None
        self.num_epochs = 1
        self.grad_clip: Optional[float] = None
        # learners
        self.num_learners = 0
        self.num_cpus_per_learner = 1
        # None: the card (one per learner actor); 0 asks for the CPU.
        self.num_gpus_per_learner: Optional[float] = None
        # module
        self.module_class: Optional[type] = None
        self.model_config: Dict[str, Any] = {}
        # multi-agent (reference: AlgorithmConfig.multi_agent —
        # policies + policy_mapping_fn; None means single-agent)
        self.policies: Optional[Dict[str, Any]] = None
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        # misc
        self.seed: Optional[int] = None

    # ----------------------------------------------------------- builder
    def environment(self, env=None, *, env_config=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(
        self,
        *,
        num_env_runners=None,
        num_envs_per_env_runner=None,
        num_cpus_per_env_runner=None,
        rollout_fragment_length=None,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_env_runner = num_cpus_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(
        self,
        *,
        num_learners=None,
        num_cpus_per_learner=None,
        num_gpus_per_learner=None,
    ) -> "AlgorithmConfig":
        """Learners run on the card unless `num_gpus_per_learner=0` asks
        for the CPU. Left unset, a local learner (num_learners=0) takes the
        calling process's current card and each learner actor one card of
        the cluster's; with no card to take, building raises. The
        reference's `num_devices_per_learner` built a data mesh its update
        never used, and has no counterpart."""
        if num_learners is not None:
            self.num_learners = num_learners
        if num_cpus_per_learner is not None:
            self.num_cpus_per_learner = num_cpus_per_learner
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def rl_module(self, *, module_class=None, model_config=None) -> "AlgorithmConfig":
        if module_class is not None:
            self.module_class = module_class
        if model_config is not None:
            self.model_config = dict(model_config)
        return self

    def multi_agent(
        self, *, policies=None, policy_mapping_fn=None
    ) -> "AlgorithmConfig":
        """Declare the policy modules and the agent→module mapping.

        ``policies``: dict {module_id: None | RLModuleSpec |
        (module_class, model_config)}. None uses the algorithm's
        default module. ``policy_mapping_fn(agent_id) -> module_id``
        must be picklable (module-level function / functools.partial)
        to ship to remote env runners.
        """
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    @property
    def is_multi_agent(self) -> bool:
        return bool(self.policies)

    def resolved_policy_mapping_fn(self):
        """The configured mapping, or a picklable default: all agents →
        the single module if there is exactly one, else agent_id ==
        module_id."""
        from ..env.multi_agent_env import ConstantMapping, agent_id_mapping

        if self.policy_mapping_fn is not None:
            return self.policy_mapping_fn
        if self.policies and len(self.policies) == 1:
            return ConstantMapping(next(iter(self.policies)))
        return agent_id_mapping

    def debugging(self, *, seed=None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # ------------------------------------------------------------- build
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def module_spec(self, observation_space=None, action_space=None) -> RLModuleSpec:
        return RLModuleSpec(
            module_class=self.module_class or self.default_module_class,
            observation_space=observation_space,
            action_space=action_space,
            model_config=dict(self.model_config),
        )

    def multi_module_spec(self, env) -> "Any":
        """MultiRLModuleSpec with spaces probed from the multi-agent env
        (one representative agent per module)."""
        from ..core.multi_rl_module import MultiRLModuleSpec
        from ..core.rl_module import RLModuleSpec as _Spec

        mapping = self.resolved_policy_mapping_fn()
        specs: Dict[str, _Spec] = {}
        for mid, policy in (self.policies or {}).items():
            rep = next(
                (a for a in env.possible_agents if mapping(a) == mid), None
            )
            if rep is None:
                raise ValueError(f"no agent maps to module {mid!r}")
            if isinstance(policy, _Spec):
                spec = policy
                if spec.observation_space is None:
                    spec.observation_space = env.observation_space(rep)
                if spec.action_space is None:
                    spec.action_space = env.action_space(rep)
            else:
                cls, mcfg = (
                    policy
                    if isinstance(policy, tuple)
                    else (None, None)
                )
                spec = _Spec(
                    module_class=cls
                    or self.module_class
                    or self.default_module_class,
                    observation_space=env.observation_space(rep),
                    action_space=env.action_space(rep),
                    model_config=dict(mcfg or self.model_config),
                )
            specs[mid] = spec
        return MultiRLModuleSpec(specs)

    def env_runner_config(self, module_spec) -> Dict[str, Any]:
        cfg = {
            "env": self.env,
            "env_config": self.env_config,
            "num_env_runners": self.num_env_runners,
            "num_envs_per_env_runner": self.num_envs_per_env_runner,
            "num_cpus_per_env_runner": self.num_cpus_per_env_runner,
            "rollout_fragment_length": self.rollout_fragment_length,
            "module_spec": module_spec,
            "seed": self.seed,
        }
        if self.is_multi_agent:
            from ..env.multi_agent_env_runner import MultiAgentEnvRunner

            cfg["runner_cls"] = MultiAgentEnvRunner
            cfg["policy_mapping_fn"] = self.resolved_policy_mapping_fn()
        return cfg

    def learner_config(self) -> Dict[str, Any]:
        return {
            "lr": self.lr,
            "gamma": self.gamma,
            "minibatch_size": self.minibatch_size,
            "num_epochs": self.num_epochs,
            "grad_clip": self.grad_clip,
            "num_learners": self.num_learners,
            "num_cpus_per_learner": self.num_cpus_per_learner,
            "num_gpus_per_learner": self.num_gpus_per_learner,
            "seed": self.seed,
        }

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    def build(self):
        if self.algo_class is None:
            raise ValueError(f"{type(self).__name__}.algo_class not set")
        return self.algo_class(config=self)
