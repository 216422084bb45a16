"""The port's IMPALA and APPO (`ray_tpu_torch.rllib`) against the
reference's (`ray_tpu.rllib`), on the CPU.

V-trace and the losses built on it run on the same padded batch (random
logps, rewards, terminations and row lengths, so the bootstrap and the
padding both matter) from the same start parameters, carried by
`convert.rl_module_params_from_flax`: the losses, the V-trace targets
and one update's metrics and parameters agree within float32's atol
1e-5; the reverse loop over T is the reference's reverse `lax.scan`.
Then tests/test_rllib.py's and tests/test_rllib_breadth.py's cases on the
port: V-trace reduces to the on-policy return, APPO's clip engages, and
IMPALA's and APPO's asynchronous pipelines (two remote env runners)
learn CartPole (best >= 50 within 150 iterations) with the reference's
settings and seeds.

Every test has a deadline after which it fails instead of hanging.
"""
import time

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import appo as ref_appo
from ray_tpu.rllib.algorithms import impala as ref_impala
from ray_tpu.rllib.env import episode as ref_episode
from ray_tpu_torch.convert import rl_module_params_from_flax
from ray_tpu_torch.rllib.algorithms import appo as port_appo
from ray_tpu_torch.rllib.algorithms import impala as port_impala
from ray_tpu_torch.rllib.env import episode as port_episode
from torch_rllib_cases import (
    ATOL,
    CARTPOLE_ACT,
    CARTPOLE_OBS,
    assert_metrics_close,
    assert_params_close,
    cartpole_episodes,
    cluster,  # noqa: F401
    deadline,
    one_torch_thread,  # noqa: F401
    learners,
)

_deadline = deadline(240)
T = 20


def _impala_learners(mod_pair=(ref_impala, port_impala), cls="IMPALA", **training):
    def cfg(mod):
        return getattr(mod, f"{cls}Config")().training(
            rollout_fragment_length=T, **training).debugging(seed=0)

    ref_mod, port_mod = mod_pair
    return learners(getattr(ref_mod, f"{cls}Learner"), getattr(port_mod, f"{cls}Learner"),
                    cfg(ref_mod), cfg(port_mod), CARTPOLE_OBS, CARTPOLE_ACT)


def _batch(port, seed=0):
    """Episodes of 5-40 steps (some past T, cut there; some shorter,
    padded), with random behavior logps."""
    return port.build_batch(cartpole_episodes(port_episode, seed=seed, n=7))


def test_build_batch_is_the_references_without_its_row_padding():
    """The reference pads B to a multiple of 8 with mask-0 rows for XLA;
    the port's rows are the same and no more."""
    ref, port = _impala_learners()
    want = ref.build_batch(cartpole_episodes(ref_episode, n=7))
    got = _batch(port)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape[0] == 7 and want[k].shape[0] == 8
        np.testing.assert_array_equal(got[k], want[k][:7], err_msg=k)
        assert not want[k][7:].any(), k


@pytest.mark.parametrize("standardize", [True, False])
def test_vtrace_losses_match_the_reference(standardize):
    """The whole loss over V-trace (targets, clipped weights, bootstrap
    past short rows, standardized or raw advantages) on random logps,
    rewards and terminations, with behavior far from the policy so that
    the clips engage."""
    ref, port = _impala_learners(standardize_advantages=standardize,
                                 vtrace_clip_rho_threshold=0.8, vtrace_clip_c_threshold=0.9)
    batch = _batch(port)
    rng = np.random.RandomState(1)
    batch["action_logp"] = (-2.0 * rng.rand(*batch["mask"].shape)).astype(np.float32) * batch["mask"]
    batch["rewards"] = rng.randn(*batch["mask"].shape).astype(np.float32) * batch["mask"]
    loss, want = ref.compute_loss(ref.params, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(0))
    got_loss, got = port.compute_loss(port.params, port.device_batch(batch), None)
    assert abs(float(got_loss.detach()) - float(loss)) <= ATOL
    assert_metrics_close({k: float(v.detach()) for k, v in got.items()},
                         {k: float(v) for k, v in want.items()})


def test_vtrace_targets_equal_a_numpy_recursion():
    """`vtrace` against the recursion written out in float64 numpy."""
    rng = np.random.RandomState(2)
    B, n = 3, 6
    mask = np.ones((B, n), np.float32)
    mask[1, 4:] = 0
    batch = {"mask": mask, "action_logp": -rng.rand(B, n).astype(np.float32),
             "rewards": rng.randn(B, n).astype(np.float32),
             "terminateds": np.zeros((B, n), np.float32)}
    batch["terminateds"][0, 2] = 1
    values, bootstrap, logp = rng.randn(B, n), rng.randn(B), -rng.rand(B, n)
    cfg = {"vtrace_clip_rho_threshold": 1.0, "vtrace_clip_c_threshold": 0.7, "gamma": 0.9}
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in batch.items()}
    vs, pg_adv, _ = port_impala.vtrace(torch.tensor(values, dtype=torch.float32),
                                       torch.tensor(bootstrap, dtype=torch.float32),
                                       torch.tensor(logp, dtype=torch.float32), t, cfg)
    rho = np.exp(logp - batch["action_logp"])
    want_vs = np.zeros((B, n))
    for b in range(B):
        L = int(mask[b].sum())
        acc = 0.0
        for s in range(L - 1, -1, -1):
            disc = 0.9 * (1 - batch["terminateds"][b, s])
            v_next = values[b, s + 1] if s + 1 < L else bootstrap[b]
            delta = min(rho[b, s], 1.0) * (batch["rewards"][b, s] + disc * v_next - values[b, s])
            acc = delta + disc * min(rho[b, s], 0.7) * acc
            want_vs[b, s] = values[b, s] + acc
        want_vs[b, L:] = values[b, L:]
    np.testing.assert_allclose(vs.numpy(), want_vs, atol=1e-5, rtol=0)
    assert torch.isfinite(pg_adv).all()


@pytest.mark.parametrize("module", ["impala", "appo"])
def test_vtrace_reduces_to_gae_like_on_policy(module):
    """tests/test_rllib.py's case, on the port's IMPALA and APPO."""
    mod = {"impala": port_impala, "appo": port_appo}[module]
    cls = "IMPALA" if module == "impala" else "APPO"
    env = gym.make("CartPole-v1")
    cfg = getattr(mod, f"{cls}Config")().training(rollout_fragment_length=10).learners(
        num_gpus_per_learner=0)
    learner = getattr(mod, f"{cls}Learner")(
        module_spec=cfg.module_spec(env.observation_space, env.action_space),
        config=cfg.learner_config())
    learner.build()
    ep = port_episode.SingleAgentEpisode(initial_observation=env.reset(seed=0)[0])
    for t in range(10):
        a = t % 2
        nobs, r, term, trunc, _ = env.step(a)
        ep.add_env_step(nobs, a, r, terminated=term, truncated=True if t == 9 else trunc,
                        extra_model_outputs={"action_logp": 0.0})
        if term:
            break
    ep.finalize()
    batch = learner.device_batch(learner.build_batch([ep]))
    loss, metrics = learner.compute_loss(learner.params, batch, None)
    assert np.isfinite(float(loss.detach()))
    assert float(metrics["mean_rho"]) > 0.0


def test_impala_update_matches_the_reference():
    """Two updates (grad_clip 40, the default) on two batches: metrics and
    parameters."""
    ref, port = _impala_learners()
    for seed in range(2):
        batch = _batch(port, seed)
        want = ref.update({k: v.copy() for k, v in batch.items()})
        got = port.update({k: v.copy() for k, v in batch.items()})
        assert_metrics_close(got, want)
        assert_params_close(port.get_weights(), ref.params)


@pytest.mark.parametrize("use_kl_loss", [False, True])
def test_appo_updates_match_the_reference(use_kl_loss):
    """Three updates: the clipped surrogate, the KL term against the
    target policy with the adaptive coefficient, and the target refreshed
    every 2 updates on the learner's device."""
    ref, port = _impala_learners((ref_appo, port_appo), "APPO", use_kl_loss=use_kl_loss,
                                 kl_target=1e-4)
    port.target_params.load_state_dict(rl_module_params_from_flax(ref.target_params))
    for i in range(3):
        batch = _batch(port, i)
        want = ref.update({k: v.copy() for k, v in batch.items()})
        got = port.update({k: v.copy() for k, v in batch.items()})
        assert_metrics_close(got, want)
        assert_params_close(port.get_weights(), ref.params)
        assert_params_close(port.target_params.state_dict(), ref.target_params)
        assert port._kl_coeff == ref._kl_coeff
    assert port.target_params["pi"].layers[0].weight.device == port.device
    state = port.get_state()
    assert state["kl_coeff"] == port._kl_coeff and state["updates"] == 3


def test_appo_loss_clips_ratio():
    """tests/test_rllib_breadth.py's case, on the port."""
    cfg = port_appo.APPOConfig().environment("CartPole-v1").learners(num_gpus_per_learner=0)
    spec = cfg.module_spec(gym.spaces.Box(-1, 1, (4,), np.float32), gym.spaces.Discrete(2))
    learner = port_appo.APPOLearner(module_spec=spec, config=cfg.learner_config())
    learner.build()
    T_ = cfg.rollout_fragment_length
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.standard_normal((8, T_, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (8, T_)).astype(np.int64),
        "rewards": np.ones((8, T_), np.float32),
        "terminateds": np.zeros((8, T_), np.float32),
        # Behavior policy wildly off → big ratios → clip engages.
        "action_logp": np.full((8, T_), -8.0, np.float32),
        "bootstrap_obs": rng.standard_normal((8, 4)).astype(np.float32),
        "mask": np.ones((8, T_), np.float32),
    }
    loss, metrics = learner.compute_loss(learner.params, learner.device_batch(batch), None)
    assert np.isfinite(float(loss.detach()))
    assert float(metrics["mean_rho"]) > 1.0  # off-policy regime


# ------------------------------------------------- the async pipeline's order


class _Ref:
    def __init__(self, runner, n):
        self.runner, self.n = runner, n


def _async_impala(monkeypatch, late, arrival_order):
    """An IMPALA whose two env runners, learner and runtime calls are
    stand-ins: runner `i` in `late` never answers, and the stand-in
    `wait` lists what is ready in `arrival_order` ("youngest" first or
    "oldest" first), as arrival on a loaded host may. Returns the
    algorithm and the list of the results it took, in the order taken."""
    from types import SimpleNamespace

    cfg = port_impala.IMPALAConfig()
    calls, taken = [], []

    def call(idx, num_timesteps):
        calls.append(_Ref(idx, len(calls)))
        return calls[-1]

    def wait(refs, num_returns=1, timeout=None):
        ready = [r for r in refs if r.runner not in late]
        if arrival_order == "youngest":
            ready.reverse()
        if not ready:
            time.sleep(timeout)
        return ready[:num_returns], [r for r in refs if r not in ready[:num_returns]]

    def get(ref):
        taken.append(ref)
        return [[0] * (cfg.train_batch_size // 2)]  # one update per two results

    monkeypatch.setattr(port_impala.ray_tpu_torch, "wait", wait)
    monkeypatch.setattr(port_impala.ray_tpu_torch, "get", get)
    monkeypatch.setattr(port_impala.ray_tpu_torch, "put", lambda value: value)
    manager = SimpleNamespace(
        healthy_actor_ids=lambda: [0, 1],
        actor=lambda idx: SimpleNamespace(
            sample=SimpleNamespace(remote=lambda num_timesteps: call(idx, num_timesteps)),
            set_weights=SimpleNamespace(remote=lambda weights: None)))
    algo = port_impala.IMPALA.__new__(port_impala.IMPALA)
    algo.config = cfg
    algo.env_runner_group = SimpleNamespace(_manager=manager)
    algo.learner_group = SimpleNamespace(update_from_episodes=lambda eps: {"loss": 1.0},
                                         get_weights=lambda: {})
    algo._inflight, algo._issued = {}, {}
    algo._learner_steps, algo._episode_buffer, algo._buffered_steps = 0, [], 0
    algo._total_env_steps = 0
    return algo, taken


def test_results_on_time_are_taken_in_request_order(monkeypatch):
    """With every runner on time, the learner takes the oldest request's
    result first, whatever order they arrive in, so each runner sees the
    same sequence of calls in every seeded run."""
    algo, taken = _async_impala(monkeypatch, late=(), arrival_order="youngest")
    for _ in range(12):
        algo.training_step()
    assert [r.n for r in taken] == list(range(12))
    assert algo._learner_steps == 6


def test_a_late_runner_holds_the_learner_once_for_the_grace_at_most(monkeypatch):
    """Runner 0 never answers: the learner waits IN_ORDER_GRACE_S for its
    oldest request once, then learns from runner 1's results as they
    arrive, as the reference does, and runner 0's requests stay in
    flight."""
    monkeypatch.setattr(port_impala, "IN_ORDER_GRACE_S", 0.5)
    algo, taken = _async_impala(monkeypatch, late=(0,), arrival_order="oldest")
    t0 = time.monotonic()
    for _ in range(12):
        algo.training_step()
    elapsed = time.monotonic() - t0
    assert 0.5 <= elapsed < 1.5, elapsed
    assert len(taken) == 12 and all(r.runner == 1 for r in taken)
    assert algo._learner_steps == 6
    assert sorted(algo._inflight.values()) == [0, 0, 1, 1]


# --------------------------------------------- learning, on the port's runtime


def test_impala_async_pipeline(cluster):  # noqa: F811
    """tests/test_rllib.py's settings, threshold and budget (best >= 50
    within 150 iterations): two remote env runners, two requests in
    flight each, a CPU learner."""
    algo = (
        port_impala.IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
        .training(lr=5e-4, entropy_coeff=0.005)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    first = None
    best = 0.0
    for _ in range(150):
        r = algo.train()
        m = r["episode_return_mean"]
        if not np.isnan(m):
            first = m if first is None else first
            best = max(best, m)
        if best >= 50.0:
            break
    algo.stop()
    assert best >= 50.0, f"IMPALA not improving: first={first} best={best}"


def test_appo_cartpole_learns(cluster):  # noqa: F811
    """tests/test_rllib_breadth.py's settings, threshold and budget."""
    algo = (
        port_appo.APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=50)
        .training(train_batch_size=500, lr=5e-4, use_kl_loss=True)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    best = 0.0
    for _ in range(150):
        r = algo.train()
        if "episode_return_mean" in r and np.isfinite(r["episode_return_mean"]):
            best = max(best, r["episode_return_mean"])
        if best >= 50.0:
            break
    algo.stop()
    assert best >= 50.0, f"APPO failed to learn CartPole: best={best}"
