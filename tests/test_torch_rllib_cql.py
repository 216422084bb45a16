"""The port's CQL (`ray_tpu_torch.rllib.algorithms.cql`) against the
reference's, on the CPU.

Two updates of SAC's losses plus the conservative regularizer, in and
after the BC warm-start, run on the same point-mass batches from the same
start parameters (carried by `convert.rl_module_params_from_flax`), with
the reference's draws for each update's key: SAC's normals, the
conservative term's uniform random actions and the policy's normals at s
and s'. Metrics, every parameter and the polyak-averaged target pair
agree within float32's atol 1e-5. Then tests/test_rllib_breadth.py's
case on the port: after training, Q on random actions sits below Q on
the data's actions, by a wider margin than an unregularized critic's
(the other CQL learning case is in test_torch_rllib_offline.py).

Every test has a deadline after which it fails instead of hanging.
"""
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import cql as ref_cql
from ray_tpu_torch.convert import rl_module_params_from_flax
from ray_tpu_torch.rllib import offline as port_offline
from ray_tpu_torch.rllib.algorithms import cql as port_cql
from torch_rllib_cases import (
    POINT_ACT,
    POINT_OBS,
    PointMassEnv,
    assert_metrics_close,
    assert_params_close,
    cluster,  # noqa: F401
    cql_noise,
    deadline,
    learners,
    one_torch_thread,  # noqa: F401
    pointmass_episodes,
    ref_step_key,
    to_torch,
    transitions,
)

_deadline = deadline(400)


@pytest.mark.parametrize("bc_phase", [1.0, 0.0])
def test_cql_updates_match_the_reference(bc_phase):
    """Two updates on point-mass transitions at SAC's (256, 256), with the
    reference's draws for each key (the SAC terms' normals, the
    conservative term's uniform random actions and policy normals at s
    and s'): the conservative and BC terms, every parameter and the
    polyak-averaged target pair."""
    def cfg(mod):
        return mod.CQLConfig().training(cql_n_actions=3, min_q_weight=2.0).debugging(seed=0)

    ref, port = learners(ref_cql.CQLLearner, port_cql.CQLLearner, cfg(ref_cql), cfg(port_cql),
                         POINT_OBS, POINT_ACT)
    port.target_q.load_state_dict(rl_module_params_from_flax(ref.target_q))
    for i in range(2):
        batch = transitions(32, 2, POINT_ACT, seed=i)
        batch["bc_phase"] = np.float32(bc_phase)
        noise = to_torch(cql_noise(ref_step_key(ref), 32, 2, 3))
        want = ref.update({k: v.copy() for k, v in batch.items()})
        got = port.update({k: v.copy() for k, v in batch.items()}, noise)
        assert_metrics_close(got, want)
        assert_params_close(port.get_weights(), ref.params)
        assert_params_close(port.target_q.state_dict(), ref.target_q)


def test_cql_draws_its_own_noise_of_the_references_shapes():
    cfg = port_cql.CQLConfig().training(cql_n_actions=3).learners(
        num_gpus_per_learner=0).debugging(seed=0)
    learner = port_cql.CQLLearner(module_spec=cfg.module_spec(POINT_OBS, POINT_ACT),
                                  config=cfg.learner_config())
    learner.build()
    noise = learner.draw_noise(learner.device_batch(transitions(32, 2, POINT_ACT)))
    assert {k: tuple(v.shape) for k, v in noise.items()} == {
        "next": (32, 2), "pi": (32, 2), "rand": (96, 2), "cql_pi": (96, 2), "cql_pi2": (96, 2)}
    assert float(noise["rand"].min()) >= -1.0 and float(noise["rand"].max()) < 1.0


# --------------------------------------------- learning, on the port's runtime


def test_cql_conservative_regularizer_lowers_ood_q(cluster, tmp_path):  # noqa: F811
    """After training, Q on random actions sits clearly below Q on the
    data's, by a wider margin than an unregularized critic's."""
    eps = pointmass_episodes(40, seed=5)
    w = port_offline.SampleWriter(str(tmp_path / "pm2"))
    w.write(eps)
    w.close()

    def gap(min_q_weight):
        algo = (
            port_cql.CQLConfig()
            .environment(PointMassEnv)
            .env_runners(num_env_runners=0)
            .offline_data(input_=str(tmp_path / "pm2"))
            .training(train_batch_size=256, updates_per_iteration=300, lr=1e-3, bc_iters=0,
                      cql_n_actions=4, min_q_weight=min_q_weight)
            .learners(num_gpus_per_learner=0)
            .debugging(seed=0)
            .build()
        )
        for _ in range(3):
            algo.train()
        learner = algo.learner_group._local
        batch = algo.replay.sample(512)
        rng = np.random.default_rng(0)
        rand = rng.uniform(-1, 1, batch["actions"].shape).astype(np.float32)
        with torch.no_grad():
            q_data, _ = learner.module.q_values(learner.params, batch["obs"], batch["actions"])
            q_rand, _ = learner.module.q_values(learner.params, batch["obs"], rand)
        algo.stop()
        return float(torch.mean(q_rand) - torch.mean(q_data))

    cql_gap = gap(5.0)
    plain_gap = gap(0.0)
    assert cql_gap < 0.0, cql_gap
    assert cql_gap < plain_gap - 0.5, (cql_gap, plain_gap)
