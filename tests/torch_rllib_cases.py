"""What the port's RLlib test files share: the deadline and the
module-scoped cluster, spaces, batches and episodes made with numpy
from a seed, and the reference's parameters and draws carried to the
port.

The reference splits a jax key inside its losses; the port's losses take
their draws as an argument (`Learner.draw_noise`), so `ref_step_key`
and the `*_noise` helpers make the very draws the reference's next
update will take, for the port's update to take too.
"""
import signal

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.convert import rl_module_params_from_flax
from ray_tpu_torch.rllib.env.episode import SingleAgentEpisode

ATOL = 1e-5
GET_TIMEOUT_S = 60
CARTPOLE_OBS = gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)
CARTPOLE_ACT = gym.spaces.Discrete(2)
PENDULUM_OBS = gym.spaces.Box(-8.0, 8.0, (3,), np.float32)
PENDULUM_ACT = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
POINT_OBS = gym.spaces.Box(-2.0, 2.0, (2,), np.float32)
POINT_ACT = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)


def deadline(seconds):
    """An autouse fixture: the test fails once it passes `seconds`."""

    @pytest.fixture(autouse=True)
    def _deadline():
        def expire(signum, frame):
            pytest.fail(f"test passed its {seconds} s deadline")

        old = signal.signal(signal.SIGALRM, expire)
        signal.alarm(seconds)
        yield
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)

    return _deadline


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread in this process, as the port's other test
    files take: the whole run's workers share the host's cores, and one
    thread's kernels give the same bits on every host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def learners(ref_cls, port_cls, ref_config, port_config, obs_space, act_space):
    """The reference's learner and the port's (on the CPU), from the same
    config, the port's carrying the reference's parameters."""
    ref = ref_cls(module_spec=ref_config.module_spec(obs_space, act_space),
                  config=ref_config.learner_config())
    ref.build()
    port = port_cls(module_spec=port_config.learners(num_gpus_per_learner=0).module_spec(
        obs_space, act_space), config=port_config.learner_config())
    port.build()
    port.set_weights(rl_module_params_from_flax(jax.device_get(ref.params)))
    return ref, port


def transitions(n, obs_dim, act_space, seed=0, weights=False):
    """A replay batch of random transitions: CartPole's or Pendulum's
    shapes (a discrete or a Box action space)."""
    rng = np.random.RandomState(seed)
    if hasattr(act_space, "n"):
        actions = rng.randint(act_space.n, size=n).astype(np.int64)
    else:
        actions = rng.uniform(act_space.low, act_space.high,
                              (n,) + act_space.shape).astype(np.float32)
    batch = {
        "obs": rng.randn(n, obs_dim).astype(np.float32),
        "next_obs": rng.randn(n, obs_dim).astype(np.float32),
        "actions": actions,
        "rewards": rng.randn(n).astype(np.float32),
        "terminateds": (rng.rand(n) < 0.1).astype(np.float32),
    }
    if weights:
        batch["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return batch


def ref_step_key(ref):
    """The key the reference learner's next one-step update hands its
    loss (Learner.update splits its key once per step)."""
    return jax.random.split(ref._rng)[1]


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def sac_noise(key, n, act_dim):
    rng_next, rng_pi = jax.random.split(key)
    return {"next": jax.random.normal(rng_next, (n, act_dim)),
            "pi": jax.random.normal(rng_pi, (n, act_dim))}


def cql_noise(key, n, act_dim, n_actions):
    noise = sac_noise(key, n, act_dim)
    rng_r, rng_pi, rng_pi2 = jax.random.split(jax.random.fold_in(key, 1), 3)
    shape = (n_actions * n, act_dim)
    noise["rand"] = jax.random.uniform(rng_r, shape, minval=-1.0, maxval=1.0)
    noise["cql_pi"] = jax.random.normal(rng_pi, shape)
    noise["cql_pi2"] = jax.random.normal(rng_pi2, shape)
    return noise


def assert_metrics_close(got, want, atol=ATOL, rtol=1e-6):
    """Metrics within atol 1e-5, plus 1e-6 of their size: a float32
    mean of values in the hundreds rounds in its sixth digit (its ulp at
    288 is 3e-5)."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        assert abs(got[k] - want[k]) <= atol + rtol * abs(want[k]), (k, got[k], want[k])


def assert_params_close(got, want_flax, atol=ATOL):
    """The port's state dict against the reference's flax parameters."""
    want = rl_module_params_from_flax(jax.device_get(want_flax))
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


def cartpole_episodes(episode_module, seed=0, n=6, length=(5, 40)):
    """Episodes of CartPole's shapes from RandomState(seed): random
    lengths, the last one truncated, action logps recorded."""
    rng = np.random.RandomState(seed)
    out = []
    for e in range(n):
        steps = int(rng.randint(*length))
        ep = episode_module.SingleAgentEpisode(initial_observation=rng.randn(4).astype(np.float32))
        for t in range(steps):
            last = t == steps - 1
            ep.add_env_step(rng.randn(4).astype(np.float32), int(rng.randint(2)), 1.0,
                            terminated=last and e < n - 1, truncated=last and e == n - 1,
                            extra_model_outputs={"action_logp": np.float32(-rng.rand())})
        out.append(ep.finalize())
    return out


class PointMassEnv:
    """tests/test_rllib_breadth.py's stable 2-D point mass: x' = clip(x +
    0.2 a), r = -|x|^2 (duck-typed gymnasium env)."""

    metadata = {"render_modes": []}
    render_mode = None
    spec = None

    def __init__(self, *args, **kwargs):
        self.observation_space = POINT_OBS
        self.action_space = POINT_ACT
        self._x = None
        self._t = 0
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._x = self._rng.uniform(-1.5, 1.5, 2).astype(np.float32)
        self._t = 0
        return self._x.copy(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self._x = np.clip(self._x + 0.2 * a, -2.0, 2.0)
        self._t += 1
        r = -float(np.sum(self._x ** 2))
        return self._x.copy(), r, False, self._t >= 50, {}

    def close(self):
        pass


def pointmass_episodes(n_episodes: int, seed: int = 0, noise: float = 0.3):
    """Behavior: proportional pull to the origin + exploration noise."""
    env = PointMassEnv()
    rng = np.random.default_rng(seed)
    eps = []
    for i in range(n_episodes):
        obs, _ = env.reset(seed=int(rng.integers(0, 2**31)))
        ep = SingleAgentEpisode(initial_observation=obs)
        while True:
            a = np.clip(-1.5 * obs + noise * rng.standard_normal(2), -1.0, 1.0).astype(np.float32)
            obs, r, term, trunc, _ = env.step(a)
            ep.add_env_step(obs, a, r, terminated=term, truncated=trunc)
            if term or trunc:
                break
        eps.append(ep.finalize())
    return eps
