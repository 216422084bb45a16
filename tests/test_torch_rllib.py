"""The port's RLlib (`ray_tpu_torch.rllib`) against the reference's
(`ray_tpu.rllib`), on the CPU.

Parameters of the reference's flax modules are carried to the port's
torch modules by `convert.rl_module_params_from_flax`, and inputs come from
`numpy.random.RandomState(0)`. Held to the reference: the module's
forwards (float32, atol 1e-5), GAE (bitwise, the same numpy on both
sides), env runners' sampling, and one `PPOLearner.update` on the same
batch, minibatches and start parameters (its metrics and the updated
parameters, atol 1e-5). Then tests/test_rllib.py's cases on the port:
learning CartPole with the reference's threshold and budget, remote env
runners, fault tolerance, checkpoints, two learners kept in lockstep by
the port's `util.collective`, and PPO under the port's Tune. The pinned
divergences: a fresh module's weights are drawn from a torch.Generator
(not jax's key), the update is eager torch (not jitted), and a learner
given a GPU that sees no card raises. Multi-agent training, the
off-policy, offline and asynchronous algorithms and DreamerV3 have
files of their own (`test_torch_rllib_*.py`).

The port's runtime runs as one module-scoped cluster; every test has a
deadline after which it fails instead of hanging, and every `get` a
timeout.
"""
import pickle
import signal

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu.rllib.algorithms.ppo import PPOLearner as RefPPOLearner
from ray_tpu.rllib.connectors import connector_v2 as ref_connectors
from ray_tpu.rllib.core import rl_module as ref_rl_module
from ray_tpu.rllib.env import episode as ref_episode
from ray_tpu.rllib.env.single_agent_env_runner import SingleAgentEnvRunner as RefEnvRunner
from ray_tpu_torch.convert import rl_module_params_from_flax
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.connectors import connector_v2 as port_connectors
from ray_tpu_torch.rllib.core import rl_module as port_rl_module
from ray_tpu_torch.rllib.env import episode as port_episode
from ray_tpu_torch.rllib.env.single_agent_env_runner import SingleAgentEnvRunner

DEADLINE_S = 240
GET_TIMEOUT_S = 60
ATOL = 1e-5
ENV = gym.make("CartPole-v1")
CONNECTORS = {"ray_tpu": ref_connectors, "ray_tpu_torch": port_connectors}
EPISODES = {"ray_tpu": ref_episode, "ray_tpu_torch": port_episode}


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other RLlib test files take: the
    whole run's workers share the host's cores (with a thread per core
    each, PPO's learning run took 175 s of its 240 s deadline there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _spec(rl_module, cls_name="DiscretePolicyModule"):
    return rl_module.RLModuleSpec(
        module_class=getattr(rl_module, cls_name),
        observation_space=ENV.observation_space,
        action_space=ENV.action_space,
    )


def _ref_params(cls_name="DiscretePolicyModule", seed=0):
    module = _spec(ref_rl_module, cls_name).build()
    return module, jax.device_get(module.init_params(jax.random.PRNGKey(seed)))


def _carried(ref_params, cls_name="DiscretePolicyModule"):
    """The port's module and the reference's parameters, loaded into it."""
    module = _spec(port_rl_module, cls_name).build("cpu")
    params = module.init_params(torch.Generator().manual_seed(0))
    params.load_state_dict(rl_module_params_from_flax(ref_params))
    return module, params


def _obs(n=64, seed=0):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


# --------------------------------------------------------------- modules


def test_forward_train_matches_the_reference():
    ref, ref_params = _ref_params()
    port, params = _carried(ref_params)
    batch = {"obs": _obs()}
    want = ref.forward_train(ref_params, batch)
    with torch.no_grad():
        got = port.forward_train(params, batch)
    for key in ("action_dist_inputs", "vf_preds"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
    with torch.no_grad():
        values = port.compute_values(params, batch["obs"]).numpy()
        logits = port.forward_exploration(params, batch)["action_dist_inputs"].numpy()
    np.testing.assert_allclose(values, np.asarray(ref.compute_values(ref_params, batch["obs"])),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        logits, np.asarray(ref.forward_exploration(ref_params, batch)["action_dist_inputs"]),
        atol=ATOL, rtol=0)


def test_q_network_forward_matches_the_reference():
    ref, ref_params = _ref_params("QNetworkModule")
    port, params = _carried(ref_params, "QNetworkModule")
    batch = {"obs": _obs(seed=1)}
    with torch.no_grad():
        got = port.forward_train(params, batch)["q_values"].numpy()
    np.testing.assert_allclose(got, np.asarray(ref.forward_train(ref_params, batch)["q_values"]),
                               atol=ATOL, rtol=0)


def test_num_actions_equals_the_references_on_every_space():
    """The port reads a discrete count from the space's `n` rather than an
    isinstance check on gymnasium's Discrete: the same count for every
    gymnasium space, and a space needs no gymnasium (phase 22 builds its
    learner so where gymnasium is not installed)."""
    from types import SimpleNamespace

    spaces = [gym.spaces.Discrete(3), gym.spaces.Box(-1, 1, (2, 3)), gym.spaces.MultiBinary(5),
              gym.spaces.MultiBinary((2, 3)), gym.spaces.MultiDiscrete([2, 3])]
    for space in spaces:
        ref = ref_rl_module.QNetworkModule(ENV.observation_space, space, {})
        port = port_rl_module.QNetworkModule(ENV.observation_space, space, {})
        assert port.num_actions() == ref.num_actions(), space
    plain = port_rl_module.DiscretePolicyModule(SimpleNamespace(shape=(4,)),
                                                SimpleNamespace(n=2, shape=()), {})
    assert plain.num_actions() == 2 and plain.input_dim() == 4


def test_multi_rl_module_seeds_each_module_from_the_parents_generator():
    """One generator a module, each seeded by a draw from the parent's (the
    reference splits its jax key): the same seed gives the same weights,
    and two modules of one spec get different ones."""
    from ray_tpu_torch.rllib import MultiRLModuleSpec

    multi = MultiRLModuleSpec({"a": _spec(port_rl_module), "b": _spec(port_rl_module)}).build()
    first = multi.init_params(torch.Generator().manual_seed(0))
    again = multi.init_params(torch.Generator().manual_seed(0))
    assert sorted(first) == ["a", "b"]
    for k, v in first["a"].state_dict().items():
        assert torch.equal(v, again["a"].state_dict()[k])
        if k.endswith("weight"):
            assert not torch.equal(v, first["b"].state_dict()[k]), k


def test_rl_module_params_from_flax_transposes_every_dense():
    _, ref_params = _ref_params()
    state = rl_module_params_from_flax(ref_params)
    assert sorted(state) == sorted(
        f"{h}.layers.{i}.{w}" for h in ("pi", "vf") for i in range(3) for w in ("weight", "bias"))
    for head in ("pi", "vf"):
        for i in range(3):
            kernel = ref_params[head]["params"][f"Dense_{i}"]["kernel"]
            assert torch.equal(state[f"{head}.layers.{i}.weight"],
                               torch.from_numpy(np.array(kernel)).T)


def test_a_fresh_modules_weights_differ_from_the_references_for_the_same_seed():
    """The pinned divergence: init draws from a torch.Generator, not jax's
    key, so seed 0 gives other weights; their shapes, zero biases and
    scales (lecun normal, and 0.01 fan-in variance on the head) agree."""
    _, ref_params = _ref_params(seed=0)
    port = _spec(port_rl_module).build("cpu")
    fresh = port.init_params(torch.Generator().manual_seed(0)).state_dict()
    again = port.init_params(torch.Generator().manual_seed(0)).state_dict()
    want = rl_module_params_from_flax(ref_params)
    assert sorted(fresh) == sorted(want)
    for k, v in fresh.items():
        assert v.shape == want[k].shape and torch.equal(v, again[k]), k
        if k.endswith("bias"):
            assert not v.any(), k
            continue
        assert not torch.allclose(v, want[k]), k
        fan_in = v.shape[1]
        scale = 0.01 if ".layers.2." in k else 1.0
        # both draw a truncated normal of this std over fan_in inputs
        std = (scale / fan_in) ** 0.5
        assert 0.7 * std < float(v.std()) < 1.3 * std, (k, float(v.std()), std)
        assert 0.7 * std < float(want[k].std()) < 1.3 * std, k


# -------------------------------------------------------- connectors, GAE


def _episodes(episode_module, seed=0, n=6):
    """Episodes of CartPole's shapes from RandomState(seed): random
    lengths, the last one truncated, action logps recorded."""
    rng = np.random.RandomState(seed)
    out = []
    for e in range(n):
        length = int(rng.randint(5, 40))
        ep = episode_module.SingleAgentEpisode(initial_observation=rng.randn(4).astype(np.float32))
        for t in range(length):
            last = t == length - 1
            ep.add_env_step(rng.randn(4).astype(np.float32), int(rng.randint(2)), 1.0,
                            terminated=last and e < n - 1, truncated=last and e == n - 1,
                            extra_model_outputs={"action_logp": np.float32(-rng.rand())})
        out.append(ep.finalize())
    return out


@pytest.mark.parametrize("name", sorted(CONNECTORS))
def test_episode_and_batch_connector(name):
    """tests/test_rllib.py's case, on either module."""
    ep = EPISODES[name].SingleAgentEpisode(initial_observation=np.zeros(3))
    for t in range(5):
        ep.add_env_step(np.full(3, t + 1.0), t % 2, 1.0, terminated=(t == 4),
                        extra_model_outputs={"action_logp": -0.5})
    ep.finalize()
    batch = CONNECTORS[name].EpisodesToBatch()(episodes=[ep])
    assert batch["obs"].shape == (5, 3)
    assert batch["next_obs"].shape == (5, 3)
    assert batch["terminateds"][-1] == 1.0 and batch["terminateds"][0] == 0.0
    assert np.allclose(batch["action_logp"], -0.5)


def test_gae_is_bitwise_the_references():
    """GAE over the same episodes and values (numpy on both sides): every
    column bitwise equal, as is the train batch it extends."""
    values = {}
    rng = np.random.RandomState(0)

    def values_fn(obs_list):
        key = tuple(len(o) for o in obs_list)
        if key not in values:
            values[key] = [rng.randn(len(o)).astype(np.float32) for o in obs_list]
        return values[key]

    out = {}
    for name, connectors in CONNECTORS.items():
        episodes = _episodes(EPISODES[name])
        batch = connectors.EpisodesToBatch()(episodes=episodes)
        gae = connectors.GeneralAdvantageEstimation(gamma=0.99, lambda_=0.95,
                                                    values_fn=values_fn)
        out[name] = gae(batch=batch, episodes=episodes)
    want, got = out["ray_tpu"], out["ray_tpu_torch"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ env runners


def test_env_runner_samples_the_references_episodes():
    """One env runner of each, the same seed, config and carried weights:
    the same actions, so the same episodes, and their logps within float32
    rounding."""
    ref_cfg = RefPPOConfig().environment("CartPole-v1").env_runners(
        num_envs_per_env_runner=4).debugging(seed=0)
    port_cfg = PPOConfig().environment("CartPole-v1").env_runners(
        num_envs_per_env_runner=4).debugging(seed=0)
    ref_runner = RefEnvRunner(pickle.dumps(ref_cfg.env_runner_config(_spec(ref_rl_module))))
    port_runner = SingleAgentEnvRunner(pickle.dumps(port_cfg.env_runner_config(_spec(port_rl_module))))
    _, ref_params = _ref_params(seed=3)
    ref_runner.set_weights(ref_params)
    port_runner.set_weights(rl_module_params_from_flax(ref_params))
    want = ref_runner.sample(num_timesteps=400)
    got = port_runner.sample(num_timesteps=400)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.actions, w.actions)
        np.testing.assert_array_equal(g.observations, w.observations)
        np.testing.assert_array_equal(g.rewards, w.rewards)
        assert (g.is_terminated, g.is_truncated) == (w.is_terminated, w.is_truncated)
        np.testing.assert_allclose(g.extra_model_outputs["action_logp"],
                                   w.extra_model_outputs["action_logp"], atol=ATOL, rtol=0)
    assert port_runner.get_metrics() == ref_runner.get_metrics()


# ---------------------------------------------------------------- learner


def _learners(minibatch_size=64, num_epochs=2, grad_clip=None):
    ref_cfg = RefPPOConfig().training(minibatch_size=minibatch_size, num_epochs=num_epochs,
                                      grad_clip=grad_clip).debugging(seed=0)
    port_cfg = PPOConfig().training(minibatch_size=minibatch_size, num_epochs=num_epochs,
                                    grad_clip=grad_clip).learners(
        num_gpus_per_learner=0).debugging(seed=0)
    ref = RefPPOLearner(module_spec=_spec(ref_rl_module), config=ref_cfg.learner_config())
    ref.build()
    port = PPOLearner(module_spec=_spec(port_rl_module), config=port_cfg.learner_config())
    port.build()
    port.set_weights(rl_module_params_from_flax(jax.device_get(ref.params)))
    return ref, port


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_one_ppo_update_matches_the_reference(grad_clip):
    """One `update` (2 epochs of 64-row minibatches, the permutations from
    the same numpy seed) on the reference's batch from the same start
    parameters: every metric and every updated parameter within 1e-5. The
    port's own batch from the same episodes equals it within float32
    rounding of the values (GAE itself is bitwise, above)."""
    ref, port = _learners(grad_clip=grad_clip)
    batch = ref.build_batch(_episodes(ref_episode))
    port_batch = port.build_batch(_episodes(port_episode))
    assert sorted(port_batch) == sorted(batch)
    for k in batch:
        np.testing.assert_allclose(port_batch[k], batch[k], atol=ATOL, rtol=0, err_msg=k)
    want = ref.update({k: v.copy() for k, v in batch.items()})
    got = port.update({k: v.copy() for k, v in batch.items()})
    assert sorted(got) == sorted(want) == sorted(
        ["policy_loss", "vf_loss", "entropy", "mean_kl", "total_loss"])
    for k in want:
        assert abs(got[k] - want[k]) <= ATOL, (k, got[k], want[k])
    want_params = rl_module_params_from_flax(ref.get_weights())
    got_params = port.get_weights()
    for k in want_params:
        assert got_params[k].device.type == "cpu"
        np.testing.assert_allclose(got_params[k].numpy(), want_params[k].numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)


def test_the_update_is_eager_torch_where_the_reference_jits():
    """The pinned divergence: the reference's update is one jitted program;
    the port's runs eagerly, one autograd backward and one Adam step per
    minibatch, leaving the last minibatch's gradients on its parameters."""
    ref, port = _learners(minibatch_size=64, num_epochs=1)
    batch = ref.build_batch(_episodes(ref_episode))
    ref.update(batch)
    assert hasattr(ref._jit_update, "lower")  # a jax.jit function
    steps = []
    step = port._update_step
    port._update_step = lambda mb, noise=None: steps.append(len(mb["obs"])) or step(mb, noise)
    port.update(batch)
    assert steps == [64] * (len(batch["obs"]) // 64)
    assert isinstance(port.params, torch.nn.ModuleDict)
    assert all(p.grad is not None for p in port.params.parameters())
    assert isinstance(port.optimizer, torch.optim.Adam)
    assert port.optimizer.defaults["betas"] == (0.9, 0.999)
    assert port.optimizer.defaults["eps"] == 1e-8


def test_a_learner_given_a_gpu_without_a_card_raises():
    """No fallback: a learner with num_gpus_per_learner that sees no card
    raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = PPOConfig().learners(num_gpus_per_learner=1).debugging(seed=0)
    learner = PPOLearner(module_spec=_spec(port_rl_module), config=cfg.learner_config())
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        learner.build()


def test_a_learner_runs_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    """The default: `num_gpus_per_learner` left unset puts a learner on the
    current card; only 0 puts it on the CPU, even where a card is there;
    unset on a host without a card, building raises rather than train on
    the CPU."""
    from ray_tpu_torch.rllib.core import learner as learner_module

    assert PPOConfig().num_gpus_per_learner is None
    assert PPOConfig().learner_config()["num_gpus_per_learner"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    assert learner_module._learner_device({}) == card
    assert learner_module._learner_device({"num_gpus_per_learner": None}) == card
    assert learner_module._learner_device({"num_gpus_per_learner": 1}) == card
    assert learner_module._learner_device({"num_gpus_per_learner": 0}) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    learner = PPOLearner(module_spec=_spec(port_rl_module),
                         config=PPOConfig().debugging(seed=0).learner_config())
    with pytest.raises(RuntimeError, match="runs on the card by default"):
        learner.build()


def test_learner_actors_take_a_card_each_unless_the_cpu_is_asked_for(monkeypatch):
    """A learner actor asks for one GPU when `num_gpus_per_learner` is
    unset, and the group raises where the cluster has fewer cards than
    learners instead of queueing them forever or training on the CPU."""
    from ray_tpu_torch.rllib.core import learner_group

    for have, n, want in [({"GPU": 1}, 1, 1), ({"GPU": 4}, 2, 1), ({"GPU": 1}, 2, None),
                          ({"CPU": 4}, 1, None)]:
        monkeypatch.setattr(ray_tpu_torch, "cluster_resources", lambda have=have: have)
        if want is None:
            with pytest.raises(ValueError, match="num_gpus_per_learner=0"):
                learner_group._gpus_per_learner(None, n)
        else:
            assert learner_group._gpus_per_learner(None, n) == want
        assert learner_group._gpus_per_learner(0, n) == 0
        assert learner_group._gpus_per_learner(0.5, n) == 0.5


def test_building_with_the_default_learner_and_no_card_raises(cluster):
    """`PPOConfig().build()` on a host without a card raises before any
    env runner starts, for a local learner and for a learner actor
    alike: the CPU is taken only where the caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = PPOConfig().environment("CartPole-v1").env_runners(num_env_runners=1)
    with pytest.raises(RuntimeError, match="runs on the card by default"):
        cfg.build()
    with pytest.raises(ValueError, match="num_gpus_per_learner=0"):
        cfg.copy().learners(num_learners=1).build()


# ------------------------------------------- tests/test_rllib.py, on the port


def test_ppo_cartpole_learns(cluster):
    """The reference's settings, threshold and budget (best >= 80 within
    20 iterations)."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
        .training(train_batch_size=2000, minibatch_size=128, num_epochs=8, lr=5e-4)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    best = 0.0
    for _ in range(20):
        r = algo.train()
        best = max(best, r["episode_return_mean"])
        if best >= 80.0:
            break
    algo.stop()
    assert best >= 80.0, f"PPO failed to learn CartPole: best={best}"


def test_ppo_remote_env_runners(cluster):
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
        .training(train_batch_size=1000, minibatch_size=128, num_epochs=4)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    algo.train()
    r2 = algo.train()
    assert r2["num_env_steps_sampled_lifetime"] >= 2000
    assert r2["env_runners"]["num_healthy_workers"] == 2
    algo.stop()


def test_env_runner_fault_tolerance(cluster):
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2)
        .training(train_batch_size=400, minibatch_size=64, num_epochs=2)
        .learners(num_gpus_per_learner=0)
        .build()
    )
    algo.train()
    mgr = algo.env_runner_group._manager
    ray_tpu_torch.kill(mgr.actor(0))
    algo.train()  # triggers restart path
    r = algo.train()
    assert r["env_runners"]["num_healthy_workers"] == 2
    assert algo.env_runner_group.num_restarts >= 1
    algo.stop()


def test_algorithm_checkpoint_restore(cluster, tmp_path):
    def build():
        return (
            PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4)
            .training(train_batch_size=400, minibatch_size=64, num_epochs=2)
            .learners(num_gpus_per_learner=0)
            .debugging(seed=0)
            .build()
        )

    algo = build()
    algo.train()
    algo.save_checkpoint(str(tmp_path))
    w1 = algo.learner_group.get_weights()
    state1 = algo.learner_group.get_state()["opt_state"]
    it1 = algo._iteration
    algo.stop()

    algo2 = build()
    algo2.load_checkpoint(str(tmp_path))
    w2 = algo2.learner_group.get_weights()
    assert sorted(w1) == sorted(w2)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    state2 = algo2.learner_group.get_state()["opt_state"]
    for i, s in state1["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], state2["state"][i][k]), (i, k)
    assert algo2._iteration == it1
    # the env runner samples with the restored weights
    runner = algo2.env_runner_group._local.get_weights()
    assert all(torch.equal(runner[k], w2[k]) for k in w2)
    algo2.stop()


def test_multi_learner_gradient_sync(cluster):
    """num_learners=2: the gradient mean through the port's util.collective
    keeps both learners' weights equal; stopping leaves the group, and its
    coordinator ends with the last learner."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4)
        .training(train_batch_size=400, minibatch_size=None, num_epochs=1)
        .learners(num_learners=2, num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    before = algo.learner_group.get_weights()
    algo.train()
    actors = algo.learner_group._actors
    w0, w1 = ray_tpu_torch.get([a.get_weights.remote() for a in actors], timeout=GET_TIMEOUT_S)
    assert ray_tpu_torch.get([a.device.remote() for a in actors],
                             timeout=GET_TIMEOUT_S) == ["cpu", "cpu"]
    for k in w0:
        np.testing.assert_allclose(w0[k].numpy(), w1[k].numpy(), atol=1e-5, err_msg=k)
    assert any(not torch.equal(before[k], w0[k]) for k in w0)
    group = algo.learner_group.collective_group
    assert ray_tpu_torch.get_actor(f"__collective_{group}")
    algo.stop()
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor(f"__collective_{group}")


def test_two_learners_update_as_one_learner_on_the_whole_batch(cluster):
    """Two learners, each on half of a batch, against one learner on all of
    it, from the same start weights: the group's gradient is the mean of
    the halves', so every metric, updated weight and Adam moment agrees.
    grad_clip sits between the whole batch's first gradient norm and twice
    it, so a sum in place of the mean is clipped where the mean is not;
    the moments hold the gradients' scale, which Adam's steps do not."""
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup

    def config(**kwargs):
        return PPOConfig().training(minibatch_size=None, **kwargs).learners(
            num_gpus_per_learner=0).debugging(seed=0)

    probe = PPOLearner(module_spec=_spec(port_rl_module),
                       config=config(num_epochs=1).learner_config())
    probe.build()
    batch = probe.build_batch(_episodes(port_episode, n=10))
    even = len(batch["obs"]) // 2 * 2
    batch = {k: v[:even] for k, v in batch.items()}
    start = probe.get_weights()
    probe.update({k: v.copy() for k, v in batch.items()})
    norm = float(torch.sqrt(sum(p.grad.square().sum() for p in probe.params.parameters())))
    cfg = config(num_epochs=3, grad_clip=1.5 * norm)

    one = PPOLearner(module_spec=_spec(port_rl_module), config=cfg.learner_config())
    one.build()
    one.set_weights(start)
    want = one.update({k: v.copy() for k, v in batch.items()})
    two = LearnerGroup(learner_cls=PPOLearner, module_spec=_spec(port_rl_module),
                       config=cfg.copy().learners(num_learners=2).learner_config())
    try:
        two.set_weights(start)
        got = two.update_from_batch({k: v.copy() for k, v in batch.items()})
        states = ray_tpu_torch.get([a.get_state.remote() for a in two._actors],
                                   timeout=GET_TIMEOUT_S)
    finally:
        two.shutdown()
    for k in want:
        assert abs(got[k] - want[k]) <= ATOL, (k, got[k], want[k])
    want_state = one.get_state()
    for state in states:
        for k, w in want_state["params"].items():
            np.testing.assert_allclose(state["params"][k].numpy(), w.numpy(), atol=ATOL, rtol=0,
                                       err_msg=k)
        for i, moments in want_state["opt_state"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(state["opt_state"]["state"][i][k].numpy(),
                                           moments[k].numpy(), rtol=1e-3, atol=1e-9,
                                           err_msg=(i, k))


def test_tune_integration(cluster, tmp_path):
    """Algorithms are the port's Tune trainables (the class API)."""
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.rllib.algorithms.ppo import PPO

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4)
        .training(train_batch_size=400, minibatch_size=64, num_epochs=2)
        .learners(num_gpus_per_learner=0)
    )
    results = tune.Tuner(
        PPO,
        param_space={
            "__algorithm_config__": cfg,
            "lr": tune.grid_search([1e-4, 5e-4]),
        },
        tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=train.RunConfig(
            storage_path=str(tmp_path), name="rl", stop={"training_iteration": 2}
        ),
    ).fit()
    assert len(results) == 2
    assert all(r.error is None for r in results.results)
    assert sorted(r.config["lr"] for r in results.results) == [1e-4, 5e-4]
    assert all(r.metrics["training_iteration"] == 2 for r in results.results)
