"""The port's offline IO, MARWIL, BC and CQL (`ray_tpu_torch.rllib`)
against the reference's (`ray_tpu.rllib`), on the CPU.

Episodes written by `SampleWriter` come back exactly through the
reference's reader and through the port's `OfflineData`, which reads
them with the port's Data (numpy blocks: an episode's observations come
back as a 2-D array or an array of rows, and are stacked to the rows the
reference gives). One update of MARWIL and BC runs on the same batch
from the same start parameters (carried by
`convert.rl_module_params_from_flax`): metrics and parameters within
float32's atol 1e-5. Then tests/test_rllib_breadth.py's learning cases
on the port with their settings, seeds, thresholds and budgets: BC from
expert CartPole data (>= 80), MARWIL from mixed data (>= 60), and CQL on
the point mass (past half the way from random to the behavior policy).
CQL's updates and its other learning case are in test_torch_rllib_cql.py.

Every test has a deadline after which it fails instead of hanging.
"""
import json

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.rllib import offline as ref_offline
from ray_tpu.rllib.algorithms import marwil as ref_marwil
from ray_tpu.rllib.env import episode as ref_episode
from ray_tpu_torch.rllib import offline as port_offline
from ray_tpu_torch.rllib.algorithms import cql as port_cql
from ray_tpu_torch.rllib.algorithms import marwil as port_marwil
from ray_tpu_torch.rllib.env import episode as port_episode
from torch_rllib_cases import (
    CARTPOLE_ACT,
    CARTPOLE_OBS,
    PointMassEnv,
    assert_metrics_close,
    assert_params_close,
    cartpole_episodes,
    cluster,  # noqa: F401
    deadline,
    learners,
    one_torch_thread,  # noqa: F401
    pointmass_episodes,
)

_deadline = deadline(400)


def _scripted_cartpole_episodes(n_episodes: int, seed: int = 0):
    """Expert-ish scripted policy: push toward the pole's fall
    direction (reaches ~150-200 return)."""
    env = gym.make("CartPole-v1")
    eps = []
    rng = np.random.default_rng(seed)
    for i in range(n_episodes):
        obs, _ = env.reset(seed=int(rng.integers(0, 2**31)))
        ep = port_episode.SingleAgentEpisode(initial_observation=obs)
        while True:
            action = int(obs[2] + 0.5 * obs[3] > 0)
            obs, r, term, trunc, _ = env.step(action)
            ep.add_env_step(obs, action, r, terminated=term, truncated=trunc)
            if term or trunc:
                break
        eps.append(ep.finalize())
    env.close()
    return eps


def _assert_same_episodes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.observations), np.asarray(w.observations))
        np.testing.assert_array_equal(np.asarray(g.actions), np.asarray(w.actions))
        np.testing.assert_array_equal(np.asarray(g.rewards), np.asarray(w.rewards))
        assert (g.is_terminated, g.is_truncated) == (w.is_terminated, w.is_truncated)
        assert sorted(g.extra_model_outputs) == sorted(w.extra_model_outputs)
        for k in w.extra_model_outputs:
            np.testing.assert_array_equal(np.asarray(g.extra_model_outputs[k]),
                                          np.asarray(w.extra_model_outputs[k]))


# --------------------------------------------------------------- offline IO


def test_rows_are_the_references():
    """episodes_to_rows and rows_to_episodes: the same JSON rows from the
    same episodes, and the same episodes back."""
    want = ref_offline.episodes_to_rows(cartpole_episodes(ref_episode))
    got = port_offline.episodes_to_rows(cartpole_episodes(port_episode))
    assert json.dumps(got) == json.dumps(want)
    _assert_same_episodes(port_offline.rows_to_episodes(got), ref_offline.rows_to_episodes(want))


def test_offline_roundtrip(tmp_path):
    """tests/test_rllib_breadth.py's case, on the port."""
    eps = _scripted_cartpole_episodes(3)
    w = port_offline.SampleWriter(str(tmp_path / "samples"))
    w.write(eps)
    w.close()
    back = port_offline.SampleReader(str(tmp_path / "samples"), shuffle=False).read_all()
    assert len(back) == 3
    for a, b in zip(eps, back):
        assert len(a) == len(b)
        np.testing.assert_allclose(np.asarray(a.observations), np.asarray(b.observations),
                                   rtol=1e-6)
        np.testing.assert_array_equal(a.actions, b.actions)
        assert a.is_terminated == b.is_terminated


def test_offline_data_rides_the_ports_data_library(cluster, tmp_path):  # noqa: F811
    """tests/test_rllib_breadth.py's case, and more: the episodes through
    the port's Data equal the reference's reader's, row for row, for a
    discrete and a continuous (nested list) action column."""
    for name, eps in [("cartpole", _scripted_cartpole_episodes(5)),
                      ("pointmass", pointmass_episodes(3))]:
        w = port_offline.SampleWriter(str(tmp_path / name))
        w.write(eps)
        w.close()
        data = port_offline.OfflineData(str(tmp_path / name))
        batches = list(data.iter_episode_batches(batch_size=100))
        total = sum(len(ep) for b in batches for ep in b)
        assert total == sum(len(e) for e in eps)
        got = [ep for b in batches for ep in b]
        want = ref_offline.SampleReader(str(tmp_path / name), shuffle=False).read_all()
        _assert_same_episodes(got, want)


# ----------------------------------------------------------- MARWIL and BC


def _marwil_learners(cls="MARWIL", **training):
    def cfg(mod):
        return getattr(mod, f"{cls}Config")().training(**training).debugging(seed=0)

    return learners(ref_marwil.MARWILLearner, port_marwil.MARWILLearner, cfg(ref_marwil),
                    cfg(port_marwil), CARTPOLE_OBS, CARTPOLE_ACT)


@pytest.mark.parametrize("cls,minibatch_size", [("MARWIL", None), ("BC", 64)])
def test_marwil_and_bc_updates_match_the_reference(cls, minibatch_size):
    """Two updates of two epochs each (BC's in 64-row minibatches, the
    permutations from the same numpy seed): metrics, parameters and, for
    MARWIL, the moving average of the squared advantage, which the
    learner's state carries. (The reference's MARWIL cannot take
    minibatches: it indexes its 0-d advantage normalizer with each
    minibatch's rows.)"""
    ref, port = _marwil_learners(cls, minibatch_size=minibatch_size, num_epochs=2,
                                 moving_average_sqd_adv_norm_update_rate=0.1)
    for seed in range(2):
        want_batch = ref.build_batch(cartpole_episodes(ref_episode, seed=seed))
        batch = port.build_batch(cartpole_episodes(port_episode, seed=seed))
        for k in want_batch:
            np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
        want = ref.update({k: v.copy() for k, v in want_batch.items()})
        got = port.update({k: v.copy() for k, v in batch.items()})
        assert_metrics_close(got, want)
        assert_params_close(port.get_weights(), ref.params)
        assert abs(port._ma_sqd_adv - ref._ma_sqd_adv) <= 1e-5 * abs(ref._ma_sqd_adv)
    other = port_marwil.MARWILLearner(module_spec=port._module_spec, config=port.config)
    other.build()
    other.set_state(port.get_state())
    assert other._ma_sqd_adv == port._ma_sqd_adv
    assert (cls == "BC") == (port._ma_sqd_adv == 100.0)


def test_marwil_takes_minibatches_where_the_reference_cannot():
    """The port's learner lets a 0-d batch entry (the normalizer) ride
    unsliced into every minibatch; the reference's raises IndexError."""
    ref, port = _marwil_learners(minibatch_size=64, num_epochs=2)
    batch = port.build_batch(cartpole_episodes(port_episode))
    with pytest.raises(IndexError):
        ref.update({k: v.copy() for k, v in batch.items()})
    metrics = port.update(batch)
    assert np.isfinite(metrics["total_loss"]) and metrics["sqd_adv_norm"] != 100.0


# --------------------------------------------- learning, on the port's runtime


def test_bc_learns_from_expert_data(cluster, tmp_path):  # noqa: F811
    w = port_offline.SampleWriter(str(tmp_path / "expert"))
    w.write(_scripted_cartpole_episodes(40, seed=1))
    w.close()
    algo = (
        port_marwil.BCConfig()
        .environment("CartPole-v1")
        .offline_data(input_=str(tmp_path / "expert"))
        .training(train_batch_size=2000, lr=1e-3, minibatch_size=128, num_epochs=5)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    for _ in range(30):
        algo.train()
    ev = algo.evaluate(num_episodes=10)
    algo.stop()
    # Random CartPole is ~20; the scripted expert is ~150+. Cloning
    # should comfortably clear 80.
    assert ev["episode_return_mean"] >= 80.0, f"BC failed: {ev}"


def test_marwil_learns_from_mixed_data(cluster, tmp_path):  # noqa: F811
    """MARWIL's advantage weighting upweights the good trajectories in
    a mixed expert+random dataset."""
    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(7)
    bad = []
    for _ in range(40):
        obs, _ = env.reset(seed=int(rng.integers(0, 2**31)))
        ep = port_episode.SingleAgentEpisode(initial_observation=obs)
        while True:
            a = int(rng.integers(0, 2))
            obs, r, term, trunc, _ = env.step(a)
            ep.add_env_step(obs, a, r, terminated=term, truncated=trunc)
            if term or trunc:
                break
        bad.append(ep.finalize())
    env.close()
    w = port_offline.SampleWriter(str(tmp_path / "mixed"))
    w.write(_scripted_cartpole_episodes(20, seed=2))
    w.write(bad)
    w.close()
    algo = (
        port_marwil.MARWILConfig()
        .environment("CartPole-v1")
        .offline_data(input_=str(tmp_path / "mixed"))
        .training(train_batch_size=2000, lr=1e-3, beta=1.0)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    for _ in range(30):
        algo.train()
    ev = algo.evaluate(num_episodes=10)
    algo.stop()
    assert ev["episode_return_mean"] >= 60.0, f"MARWIL failed: {ev}"


# ------------------------------------------------------------------- CQL


def test_cql_learns_pointmass_offline(cluster, tmp_path):  # noqa: F811
    """CQL trains purely from a recorded dataset; its evaluated policy
    must clear half the way from random to the behavior policy."""
    eps = pointmass_episodes(60, seed=2)
    behavior = float(np.mean([np.sum(e.rewards) for e in eps]))
    rand_eps = pointmass_episodes(20, seed=3, noise=10.0)
    random_ret = float(np.mean([np.sum(e.rewards) for e in rand_eps]))
    w = port_offline.SampleWriter(str(tmp_path / "pm"))
    w.write(eps)
    w.close()
    algo = (
        port_cql.CQLConfig()
        .environment(PointMassEnv)
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
        .offline_data(input_=str(tmp_path / "pm"))
        .training(train_batch_size=256, updates_per_iteration=400, lr=1e-3, bc_iters=400,
                  cql_n_actions=4, min_q_weight=2.0)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    metrics = {}
    for _ in range(4):
        metrics = algo.train()["learners"]
    ev = algo.evaluate(num_episodes=10)
    algo.stop()
    got = ev["episode_return_mean"]
    assert metrics["qf_mean"] < 50.0, metrics
    bar = random_ret + 0.5 * (behavior - random_ret)
    assert got > bar, f"CQL offline policy too weak: {got} (behavior {behavior}, random {random_ret})"
