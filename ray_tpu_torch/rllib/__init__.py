"""ray_tpu_torch.rllib: reinforcement learning on the port's actor runtime.

The port's copy of ray_tpu.rllib: PPO, DQN, IMPALA, APPO, SAC, CQL,
MARWIL, BC and DreamerV3, multi-agent training, offline data through
the port's Data, replay buffers and the tuned examples. Architecture
mirrors the reference's new API stack (rllib/ — SURVEY.md §2.4):
`EnvRunnerGroup` of CPU actors sampling gymnasium vector envs, connector
pipelines between env and module, torch `RLModule`s, and a
`Learner`/`LearnerGroup` whose update is eager torch on the learner's
device: the card, unless `num_gpus_per_learner=0` asks for the CPU.
Learners of a group average their gradients through `util.collective`;
a loss that samples takes its draws as an argument.

    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2)
        .learners(num_learners=1, num_gpus_per_learner=1)
        .build()
    )
    for _ in range(10):
        result = algo.train()
"""
from __future__ import annotations

from .core.multi_rl_module import MultiRLModule, MultiRLModuleSpec  # noqa: F401
from .core.rl_module import RLModule, RLModuleSpec  # noqa: F401
from .env.episode import SingleAgentEpisode  # noqa: F401
from .env.multi_agent_env import MultiAgentEnv, make_multi_agent  # noqa: F401

__all__ = [
    "MultiAgentEnv",
    "MultiRLModule",
    "MultiRLModuleSpec",
    "RLModule",
    "RLModuleSpec",
    "SingleAgentEpisode",
    "make_multi_agent",
]

from ray_tpu_torch._private import usage_stats as _usage

_usage.record_library_usage("rllib")
