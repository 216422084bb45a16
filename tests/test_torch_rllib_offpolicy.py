"""The port's replay buffers, DQN and SAC (`ray_tpu_torch.rllib`) against
the reference's (`ray_tpu.rllib`), on the CPU.

The buffers are numpy on both sides: the same adds, samples and priority
updates from the same seed give bitwise the same samples, indexes and
weights. One update of each learner runs on the same batch from the same
start parameters (carried by `convert.rl_module_params_from_flax`), with
SAC's Gaussian draws made from the reference's key: its metrics and the
updated parameters, the targets and the TD errors agree within float32's
atol 1e-5. Then tests/test_rllib.py's and tests/test_rllib_breadth.py's
cases on the port: the buffers, DQN on CartPole (best >= 60 within 60
iterations), SAC's squashed-Gaussian actions, and SAC on Pendulum (best >
-900 within 12 iterations), with the reference's settings and seeds; the
port seeds its exploration too, where the reference's draws are
unseeded, so its runs repeat.

Every test has a deadline after which it fails instead of hanging.
"""
import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import dqn as ref_dqn
from ray_tpu.rllib.algorithms import sac as ref_sac
from ray_tpu.rllib.utils import replay_buffers as ref_buffers
from ray_tpu_torch.convert import rl_module_params_from_flax
from ray_tpu_torch.rllib.algorithms import dqn as port_dqn
from ray_tpu_torch.rllib.algorithms import sac as port_sac
from ray_tpu_torch.rllib.utils import replay_buffers as port_buffers
from torch_rllib_cases import (
    ATOL,
    CARTPOLE_ACT,
    CARTPOLE_OBS,
    PENDULUM_ACT,
    PENDULUM_OBS,
    assert_metrics_close,
    assert_params_close,
    cluster,  # noqa: F401
    deadline,
    one_torch_thread,  # noqa: F401
    learners,
    ref_step_key,
    sac_noise,
    to_torch,
    transitions,
)

_deadline = deadline(240)
BUFFERS = {"ray_tpu": ref_buffers, "ray_tpu_torch": port_buffers}


# --------------------------------------------------------------- buffers


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_draw_the_references_samples(prioritized):
    """Adds past the capacity, samples, priority updates, more adds and
    samples: every sample, index and weight bitwise the reference's."""
    out = {}
    for name, mod in BUFFERS.items():
        buf = (mod.PrioritizedReplayBuffer(capacity=100, alpha=0.7, beta=0.5, seed=3)
               if prioritized else mod.ReplayBuffer(capacity=100, seed=3))
        rng = np.random.RandomState(0)
        draws = []
        for round_ in range(4):
            buf.add_batch({"obs": rng.randn(45, 4).astype(np.float32),
                           "actions": rng.randint(2, size=45).astype(np.int64)})
            s = buf.sample(32)
            draws.append(s)
            buf.update_priorities(s["batch_indexes"], rng.randn(32))
        out[name] = (len(buf), draws)
    (n_ref, want), (n_port, got) = out["ray_tpu"], out["ray_tpu_torch"]
    assert n_port == n_ref == 100
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_replay_buffer_uniform():
    """tests/test_rllib.py's case, on the port."""
    buf = port_buffers.ReplayBuffer(capacity=100, seed=0)
    buf.add_batch({"obs": np.arange(150, dtype=np.float32).reshape(150, 1),
                   "rewards": np.arange(150, dtype=np.float32)})
    assert len(buf) == 100
    s = buf.sample(32)
    assert s["obs"].shape == (32, 1)
    # Ring buffer: oldest 50 evicted.
    assert s["rewards"].min() >= 50


def test_replay_buffer_prioritized():
    """tests/test_rllib.py's case, on the port."""
    buf = port_buffers.PrioritizedReplayBuffer(capacity=64, seed=0, alpha=1.0)
    buf.add_batch({"x": np.arange(64, dtype=np.float32)})
    # Give item 7 overwhelming priority; it should dominate samples.
    buf.update_priorities(np.arange(64), np.full(64, 1e-3))
    buf.update_priorities([7], [100.0])
    s = buf.sample(256)
    frac = float(np.mean(s["x"] == 7.0))
    assert frac > 0.8, f"priority sampling broken: frac={frac}"
    assert "weights" in s and s["weights"].shape == (256,)


# ------------------------------------------------------------------- DQN


def _dqn_learners(double_q):
    def cfg(mod):
        return mod.DQNConfig().training(double_q=double_q, lr=1e-3, train_batch_size=32,
                                        target_network_update_freq=64,
                                        grad_clip=0.5).debugging(seed=0)

    ref, port = learners(ref_dqn.DQNLearner, port_dqn.DQNLearner, cfg(ref_dqn), cfg(port_dqn),
                         CARTPOLE_OBS, CARTPOLE_ACT)
    port.target_params.load_state_dict(rl_module_params_from_flax(ref.target_params))
    return ref, port


@pytest.mark.parametrize("prioritized", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "max_q"])
def test_dqn_updates_match_the_reference(double_q, prioritized):
    """Three updates on three replay batches (with PER's weights, and the
    TD errors that set the next priorities): the metrics, the parameters
    after each, and the target network synced on the reference's schedule
    (every 64 // 32 = 2 updates) on the learner's device."""
    ref, port = _dqn_learners(double_q)
    assert port.config["target_updates_every"] == 2
    for i in range(3):
        batch = transitions(32, 4, CARTPOLE_ACT, seed=i, weights=prioritized)
        if prioritized:
            np.testing.assert_allclose(port.td_errors(batch), ref.td_errors(batch),
                                       atol=ATOL, rtol=0)
        want = ref.update({k: v.copy() for k, v in batch.items()})
        got = port.update({k: v.copy() for k, v in batch.items()})
        assert_metrics_close(got, want)
        assert_params_close(port.get_weights(), ref.params)
        assert_params_close(port.target_params.state_dict(), ref.target_params)
        synced = (i + 1) % 2 == 0
        assert all(torch.equal(port.target_params.state_dict()[k], v)
                   for k, v in port.params.state_dict().items()) == synced
        assert port.target_params["q"].layers[0].weight.device == port.device
        assert not any(p.requires_grad for p in port.target_params.parameters())


def test_dqn_state_holds_the_target_networks_host_copy():
    ref, port = _dqn_learners(True)
    port.update(transitions(32, 4, CARTPOLE_ACT))
    state = port.get_state()
    assert state["target_params"]["q.layers.0.weight"].device.type == "cpu"
    other = port_dqn.DQNLearner(module_spec=port._module_spec, config=port.config)
    other.build()
    other.set_state(state)
    for k, v in port.target_params.state_dict().items():
        assert torch.equal(other.target_params.state_dict()[k], v)
    assert other._updates == port._updates == 1


def test_epsilon_schedule_is_seeded():
    """The port's ε-greedy draws come from the config's seed (the
    reference's default_rng() is unseeded): two schedules of one seed
    pick the same actions."""
    q = np.random.RandomState(0).randn(64, 2).astype(np.float32)
    picks = [port_dqn._EpsilonSchedule(1.0, 0.05, 100, seed=1)(batch={"q_values": q})["actions"]
             for _ in range(2)]
    np.testing.assert_array_equal(*picks)


# ------------------------------------------------------------------- SAC


def _sac_module(mod, hidden=(256, 256)):
    return mod.SACModule(PENDULUM_OBS, PENDULUM_ACT, {"fcnet_hiddens": hidden})


def test_sac_module_matches_the_reference_at_its_default_widths():
    """(256, 256) pi/q1/q2 carried from flax: the dist inputs, both
    critics and a reparameterized action with its logp, given the same
    normal draw."""
    ref = _sac_module(ref_sac)
    ref_params = jax.device_get(ref.init_params(jax.random.PRNGKey(0)))
    port = _sac_module(port_sac)
    params = port.init_params(torch.Generator().manual_seed(0))
    params.load_state_dict(rl_module_params_from_flax(ref_params))
    rng = np.random.RandomState(0)
    obs = rng.randn(64, 3).astype(np.float32)
    act = rng.uniform(-2, 2, (64, 1)).astype(np.float32)
    with torch.no_grad():
        got = port.forward_train(params, {"obs": obs})["action_dist_inputs"].numpy()
        q1, q2 = port.q_values(params, obs, act)
        eps = jax.random.normal(jax.random.PRNGKey(5), (64, 1))
        a, logp = port.sample_action(params, obs, to_torch(eps))
    np.testing.assert_allclose(got, ref.forward_train(ref_params, {"obs": obs})["action_dist_inputs"],
                               atol=ATOL, rtol=0)
    want_q1, want_q2 = ref.q_values(ref_params, obs, act)
    np.testing.assert_allclose(q1.numpy(), want_q1, atol=ATOL, rtol=0)
    np.testing.assert_allclose(q2.numpy(), want_q2, atol=ATOL, rtol=0)
    want_a, want_logp = ref.sample_action(ref_params, obs, jax.random.PRNGKey(5))
    np.testing.assert_allclose(a.numpy(), want_a, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=ATOL, rtol=0)


def test_sac_module_sample_action_logp():
    """tests/test_rllib_breadth.py's case, on the port: actions within the
    bounds, finite logps."""
    env = gym.make("Pendulum-v1")
    mod = port_sac.SACModule(env.observation_space, env.action_space, {"fcnet_hiddens": (8,)})
    params = mod.init_params(torch.Generator().manual_seed(0))
    obs = np.random.default_rng(0).standard_normal((16, 3)).astype(np.float32)
    with torch.no_grad():
        a, logp = mod.sample_action(params, obs, torch.randn(16, 1))
    a, logp = a.numpy(), logp.numpy()
    assert a.shape == (16, 1) and logp.shape == (16,)
    assert (a >= env.action_space.low - 1e-5).all()
    assert (a <= env.action_space.high + 1e-5).all()
    assert np.isfinite(logp).all()


def _sac_learners(**training):
    def cfg(mod):
        return mod.SACConfig().training(**training).debugging(seed=0)

    ref, port = learners(ref_sac.SACLearner, port_sac.SACLearner, cfg(ref_sac), cfg(port_sac),
                         PENDULUM_OBS, PENDULUM_ACT)
    port.target_q.load_state_dict(rl_module_params_from_flax(ref.target_q))
    return ref, port


@pytest.mark.parametrize("prioritized", [False, True], ids=["uniform", "per"])
def test_sac_updates_match_the_reference(prioritized):
    """Three updates at (256, 256), each with the reference's normal draws
    for its key: the critic, actor and temperature terms, every parameter
    (log-alpha too), the polyak-averaged target pair on the learner's
    device, and the TD errors for PER.

    At SAC's default lr (3e-4). Adam's first step moves a weight by
    lr * g / (|g| + 1e-8), so where a gradient cancels to about Adam's eps
    the two sides' float32 sums in another order move it by visibly
    different fractions of lr: at lr 1e-3 with PER, one q2 weight of
    65536, whose gradient sums to -3.1e-8 on the first step, ends 1.01e-5
    apart (the most of any other is 3.9e-6), and that difference scales
    with lr."""
    ref, port = _sac_learners(initial_alpha=0.5)
    for i in range(3):
        batch = transitions(64, 3, PENDULUM_ACT, seed=i, weights=prioritized)
        if prioritized:
            key = jax.random.split(ref._rng)[1]
            noise = to_torch(jax.random.normal(key, (64, 1)))
            np.testing.assert_allclose(port.td_errors(batch, noise), ref.td_errors(batch),
                                       atol=ATOL, rtol=0)
        noise = to_torch(sac_noise(ref_step_key(ref), 64, 1))
        want = ref.update({k: v.copy() for k, v in batch.items()})
        got = port.update({k: v.copy() for k, v in batch.items()}, noise)
        assert_metrics_close(got, want)
        assert_params_close(port.get_weights(), ref.params)
        assert_params_close(port.target_q.state_dict(), ref.target_q)
    assert port.target_q["q1"].layers[0].weight.device == port.device
    assert not any(p.requires_grad for p in port.target_q.parameters())
    state = port.get_state()
    assert state["target_q"]["q1.layers.0.weight"].device.type == "cpu"


def test_sac_draws_its_noise_on_the_learners_device_from_its_seed():
    """Without given draws, a learner draws from its own generator on its
    device, seeded by the config: two learners of one seed take the same
    update."""
    _, a = _sac_learners()
    _, b = _sac_learners()
    batch = transitions(64, 3, PENDULUM_ACT)
    assert a.update(dict(batch)) == b.update(dict(batch))
    noise = a.draw_noise(a.device_batch(batch))
    assert noise["next"].device == a.device and noise["next"].shape == (64, 1)


def test_given_draws_are_for_one_step():
    """Draws passed to `update` are one step's: an update of several
    minibatches or epochs refuses them."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner

    cfg = PPOConfig().training(minibatch_size=4, num_epochs=2).learners(
        num_gpus_per_learner=0).debugging(seed=0)
    learner = PPOLearner(module_spec=cfg.module_spec(CARTPOLE_OBS, CARTPOLE_ACT),
                         config=cfg.learner_config())
    learner.build()
    with pytest.raises(ValueError, match="several"):
        learner.update({"obs": np.zeros((8, 4), np.float32)}, noise={"x": 1})


# --------------------------------------------- learning, on the port's runtime


def test_dqn_cartpole_learns(cluster):  # noqa: F811
    """tests/test_rllib.py's settings, threshold and budget (best >= 60
    within 60 iterations), on a CPU learner."""
    algo = (
        port_dqn.DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4)
        .training(prioritized_replay=True, epsilon_timesteps=4000,
                  num_steps_sampled_before_learning_starts=500,
                  lr=1e-3, target_network_update_freq=200)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=1)
        .build()
    )
    best = 0.0
    for _ in range(60):
        r = algo.train()
        best = max(best, r["episode_return_mean"])
        if best >= 60.0:
            break
    algo.stop()
    assert best >= 60.0, f"DQN failed to learn CartPole: best={best}"


def test_sac_pendulum_learns(cluster):  # noqa: F811
    """tests/test_rllib_breadth.py's settings, threshold and budget (best >
    -900 within 12 iterations), on a CPU learner."""
    algo = (
        port_sac.SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4)
        .training(
            train_batch_size=256,
            num_steps_sampled_before_learning_starts=1500,
            sample_timesteps_per_iteration=1500,
            updates_per_iteration=350,
            lr=1e-3,
        )
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    # Random policy on Pendulum averages about -1200; a learning SAC
    # clears -900 within a few thousand env steps.
    best = -1e9
    for _ in range(12):
        r = algo.train()
        if np.isfinite(r["episode_return_mean"]):
            best = max(best, r["episode_return_mean"])
        if best > -900.0:
            break
    algo.stop()
    assert best > -900.0, f"SAC failed to learn Pendulum: best={best}"
