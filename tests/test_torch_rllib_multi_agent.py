"""The port's multi-agent RLlib (`MultiAgentEnvRunner`,
`MultiAgentLearnerGroup`) against the reference's, on the CPU.

The same multi-agent env, seeds and module weights (carried by
`convert.rl_module_params_from_flax`) give the reference's per-agent
episodes, tagged with their modules; a `MultiAgentLearnerGroup` update
of two PPO policies leaves each policy's weights equal to a single-agent
learner's given that policy's episodes. Then tests/test_rllib_breadth.py's
multi-agent cases on the port: the env wrapper, two policies learning
multi-agent CartPole (best >= 60 within 25 iterations) and one policy
shared by both agents.

Every test has a deadline after which it fails instead of hanging.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import make_multi_agent as ref_make_multi_agent
from ray_tpu.rllib.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner as RefRunner
from ray_tpu_torch.convert import rl_module_params_from_flax
from ray_tpu_torch.rllib import make_multi_agent
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.multi_agent_learner_group import MultiAgentLearnerGroup
from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner
from torch_rllib_cases import (
    ATOL,
    assert_metrics_close,
    cluster,  # noqa: F401
    deadline,
    one_torch_thread,  # noqa: F401
)

_deadline = deadline(240)


def _map_agent_to_policy(agent_id: str) -> str:
    return {"agent_0": "p0", "agent_1": "p1"}[agent_id]


def _configs(policies=("p0", "p1")):
    mapping = _map_agent_to_policy if len(policies) > 1 else None
    out = {}
    for name, cfg, make in [("ray_tpu", RefPPOConfig(), ref_make_multi_agent),
                            ("ray_tpu_torch", PPOConfig(), make_multi_agent)]:
        out[name] = (cfg.environment(make("CartPole-v1", num_agents=2))
                     .multi_agent(policies={p: None for p in policies}, policy_mapping_fn=mapping)
                     .training(train_batch_size=400, minibatch_size=64, num_epochs=2)
                     .debugging(seed=0))
    out["ray_tpu_torch"].learners(num_gpus_per_learner=0)
    return out


def _runner_config(cfg):
    env = cfg.env(cfg.env_config)
    spec = cfg.multi_module_spec(env)
    env.close()
    return cfg.env_runner_config(spec)


def test_multi_agent_env_wrapper():
    """tests/test_rllib_breadth.py's case, on the port's wrapper."""
    env = make_multi_agent("CartPole-v1", num_agents=3)({})
    assert len(env.possible_agents) == 3
    obs, _ = env.reset(seed=0)
    assert set(obs) == set(env.possible_agents)
    actions = {aid: 0 for aid in obs}
    obs, rew, term, trunc, _ = env.step(actions)
    assert set(rew) == set(env.possible_agents)
    assert "__all__" in term
    env.close()


def test_the_config_wires_the_multi_agent_runner():
    runner_cfg = _runner_config(_configs()["ray_tpu_torch"])
    assert runner_cfg["runner_cls"] is MultiAgentEnvRunner
    assert runner_cfg["policy_mapping_fn"] is _map_agent_to_policy


def test_multi_agent_env_runner_samples_the_references_episodes():
    """One runner of each, the same seed and carried weights per module:
    the same per-agent chunks (module and agent tags, actions,
    observations, rewards, ends), logps within float32 rounding, and the
    same per-module returns."""
    cfgs = _configs()
    ref = RefRunner(pickle.dumps(_runner_config(cfgs["ray_tpu"])))
    port = MultiAgentEnvRunner(pickle.dumps(_runner_config(cfgs["ray_tpu_torch"])))
    weights = {mid: jax.device_get(m.init_params(jax.random.PRNGKey(i + 3)))
               for i, (mid, m) in enumerate(sorted(ref.module.items()))}
    ref.set_weights(weights)
    port.set_weights({mid: rl_module_params_from_flax(w) for mid, w in weights.items()})
    for _ in range(2):
        want = ref.sample(num_timesteps=150)
        got = port.sample(num_timesteps=150)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert (g.module_id, g.agent_id) == (w.module_id, w.agent_id)
            np.testing.assert_array_equal(g.actions, w.actions)
            np.testing.assert_array_equal(g.observations, w.observations)
            np.testing.assert_array_equal(g.rewards, w.rewards)
            assert (g.is_terminated, g.is_truncated) == (w.is_terminated, w.is_truncated)
            np.testing.assert_allclose(g.extra_model_outputs["action_logp"],
                                       w.extra_model_outputs["action_logp"], atol=ATOL, rtol=0)
    assert port.get_metrics() == ref.get_metrics()
    assert set(port.get_weights()) == {"p0", "p1"}


def test_each_policy_updates_as_a_single_agent_learner_on_its_episodes():
    """One MultiAgentLearnerGroup update of two PPO policies (local
    learners): each policy's metrics and weights equal a single-agent
    learner's, from the same start, given only that policy's episodes."""
    cfg = _configs()["ray_tpu_torch"]
    env = cfg.env(cfg.env_config)
    spec = cfg.multi_module_spec(env)
    runner = MultiAgentEnvRunner(pickle.dumps(cfg.env_runner_config(spec)))
    env.close()
    episodes = runner.sample(num_timesteps=300)
    group = MultiAgentLearnerGroup(learner_cls=PPOLearner, module_spec=spec,
                                   config=cfg.learner_config())
    start = group.get_weights()
    got = group.update_from_episodes(episodes)
    after = group.get_weights()
    for mid, mspec in spec.module_specs.items():
        single = LearnerGroup(learner_cls=PPOLearner, module_spec=mspec, config=cfg.learner_config())
        single.set_weights(start[mid])
        want = single.update_from_episodes([ep for ep in episodes if ep.module_id == mid])
        assert_metrics_close({k.split("/", 1)[1]: v for k, v in got.items()
                              if k.startswith(mid + "/")}, want)
        for k, w in single.get_weights().items():
            assert torch.equal(after[mid][k], w), (mid, k)
        assert any(not torch.equal(start[mid][k], after[mid][k]) for k in start[mid])
    group.shutdown()


def test_learner_actors_for_every_module_need_a_card_each(monkeypatch):
    """Two policies' learner actors, one card each when
    `num_gpus_per_learner` is unset, on a one-card cluster: building
    raises instead of queueing the second policy's actor forever."""
    cfg = _configs()["ray_tpu_torch"]
    cfg.learners(num_learners=1)
    cfg.num_gpus_per_learner = None  # unset: a card per learner actor
    env = cfg.env(cfg.env_config)
    spec = cfg.multi_module_spec(env)
    env.close()
    monkeypatch.setattr(ray_tpu_torch, "cluster_resources", lambda: {"CPU": 8, "GPU": 1})
    with pytest.raises(ValueError, match="num_gpus_per_learner=0"):
        MultiAgentLearnerGroup(learner_cls=PPOLearner, module_spec=spec,
                               config=cfg.learner_config())


# --------------------------------------------- learning, on the port's runtime


def test_multi_agent_ppo_two_policies_learn(cluster):  # noqa: F811
    """tests/test_rllib_breadth.py's settings, threshold and budget."""
    algo = (
        PPOConfig()
        .environment(make_multi_agent("CartPole-v1", num_agents=2))
        .multi_agent(policies={"p0": None, "p1": None}, policy_mapping_fn=_map_agent_to_policy)
        .env_runners(num_env_runners=0)
        .training(train_batch_size=2000, minibatch_size=128, num_epochs=8, lr=5e-4)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    best = 0.0
    last_modules = {}
    for _ in range(25):
        r = algo.train()
        last_modules = r["env_runners"].get("module_episode_return_mean", last_modules)
        if np.isfinite(r["episode_return_mean"]):
            best = max(best, r["episode_return_mean"])
        if best >= 60.0 and len(last_modules) == 2:
            break
    algo.stop()
    assert best >= 60.0, f"multi-agent PPO failed: best={best}"
    assert set(last_modules) == {"p0", "p1"}, last_modules


def test_multi_agent_shared_policy(cluster):  # noqa: F811
    algo = (
        PPOConfig()
        .environment(make_multi_agent("CartPole-v1", num_agents=2))
        .multi_agent(policies={"shared": None})
        .env_runners(num_env_runners=0)
        .training(train_batch_size=1000, minibatch_size=128, num_epochs=6)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    r = {}
    for _ in range(5):
        r = algo.train()
    algo.stop()
    assert any(k.startswith("shared/") for k in r["learners"]), r
