"""The port's DreamerV3 (`ray_tpu_torch.rllib.algorithms.dreamerv3`)
against the reference's, on the CPU.

Weights are carried by `convert.dreamer_params_from_flax` (flax's
GRUCell by `gru_cell_params_from_flax`, with zeros for the hidden biases
flax does not have), and every categorical draw is Gumbel-max, so the
port's train step and acting take the very Gumbel noise the reference's
`jax.random.categorical` adds for its key. Held to the reference: the
twohot/symlog round trip, one GRU cell step, every net's forward, one
acting step, and one whole train step (the RSSM posterior over T, the
imagined rollout over the horizon, the lambda returns, three clipped
Adam groups, the slow critic and the return normalizer): the losses
within atol 1e-5 plus 1e-6 of their size, every updated weight within
atol 1e-6 (an Adam step's size is the learning rate, 1e-4 at most, and
the two sides' weights differ by less than 1e-7 after it). Then
tests/test_rllib_breadth.py's learning run on the port: the tuned
example clears 55 on CartPole within 50 iterations, and the tuned
examples' registry with its PPO regression.

Every test has a deadline after which it fails instead of hanging.
"""
import os
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from ray_tpu.rllib.algorithms import dreamerv3 as ref_dv3
from ray_tpu_torch.convert import dreamer_params_from_flax, gru_cell_params_from_flax
from ray_tpu_torch.rllib import tuned_examples as tx
from ray_tpu_torch.rllib.algorithms import dreamerv3 as port_dv3
from torch_rllib_cases import (
    assert_metrics_close,
    cluster,  # noqa: F401
    deadline,
    one_torch_thread,  # noqa: F401
)

_deadline = deadline(400)
MC = {"deter": 32, "stoch_groups": 4, "stoch_classes": 4, "units": 32, "bins": 41}
B, T, H = 4, 8, 5
CPU = {"learners": {"num_gpus_per_learner": 0}}


def _algos():
    """The reference's algorithm and the port's on CartPole at small
    widths, the port's nets, slow critic included, carrying the
    reference's weights; a replayed batch from the reference's own
    collection."""
    def cfg(mod):
        c = mod.DreamerV3Config().environment("CartPole-v1").training(
            model_config=MC, batch_size_B=B, batch_length_T=T, horizon=H,
            num_envs=2).debugging(seed=0)
        return c.learners(num_gpus_per_learner=0) if mod is port_dv3 else c

    ref, port = cfg(ref_dv3).build(), cfg(port_dv3).build()
    weights = dreamer_params_from_flax(jax.device_get(ref.params))
    port.learner.nets.load_state_dict(weights)
    port.learner.slow_critic.load_state_dict(
        {k[len("critic."):]: v for k, v in weights.items() if k.startswith("critic.")})
    ref._collect(300)
    return ref, port


def _train_noise(key):
    """The Gumbel draws the reference's train step takes for `key`, in
    its order of key splits: the posterior's per step of the scan, then
    the imagined actions' and latents' per step of the horizon."""
    key, kscan = jax.random.split(key)
    post, k = [], kscan
    for _ in range(T):
        k, k1 = jax.random.split(k)
        post.append(jax.random.gumbel(k1, (B, MC["stoch_groups"], MC["stoch_classes"])))
    _, kimg = jax.random.split(key)
    acts, stochs, k = [], [], kimg
    for _ in range(H):
        k, k1, k2 = jax.random.split(k, 3)
        acts.append(jax.random.gumbel(k1, (T * B, 2)))
        stochs.append(jax.random.gumbel(k2, (T * B, MC["stoch_groups"], MC["stoch_classes"])))
    return {"post": torch.tensor(np.stack(post)), "img_act": torch.tensor(np.stack(acts)),
            "img_stoch": torch.tensor(np.stack(stochs))}


def test_gumbel_max_is_jax_categorical():
    """The draws the tests hand the port are jax.random.categorical's."""
    logits = jax.random.normal(jax.random.PRNGKey(0), (64, 4, 8))
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        want = jax.random.categorical(key, logits)
        got = torch.argmax(torch.tensor(np.asarray(logits))
                           + torch.tensor(np.asarray(jax.random.gumbel(key, logits.shape))), -1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twohot_symlog_roundtrip():
    """tests/test_rllib_breadth.py's case on the port, and the encoding and
    decoding against the reference's."""
    xs = np.asarray([-50.0, -3.2, -1.0, 0.0, 0.7, 2.5, 99.0], np.float32)
    th = port_dv3._TwoHot(41)
    enc = th.encode(torch.tensor(xs))
    np.testing.assert_allclose(enc.sum(-1).numpy(), 1.0, atol=1e-5)
    dec = th.decode(torch.log(enc + 1e-8)).numpy()
    for x, d in zip(xs, dec):
        lo, hi = -np.expm1(20.0), np.expm1(20.0)
        assert abs(d - np.clip(x, lo, hi)) < 0.05 * max(1.0, abs(x)), (x, d)
    ref = ref_dv3._TwoHot(41)
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref.encode(jnp.asarray(xs))), atol=1e-6)
    logits = np.random.RandomState(0).randn(16, 41).astype(np.float32)
    np.testing.assert_allclose(th.decode(torch.tensor(logits)).numpy(),
                               np.asarray(ref.decode(jnp.asarray(logits))), rtol=1e-5, atol=1e-6)


def test_gru_cell_matches_flax():
    """torch's GRUCell carrying flax's GRUCell: the same (r, z, n) gates
    and `(1 - z) * n + z * h` update, flax's missing r and z hidden
    biases as zeros."""
    cell = fnn.GRUCell(24)
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 16))
    h = jax.random.normal(jax.random.PRNGKey(2), (5, 24))
    params = cell.init(jax.random.PRNGKey(0), h, x)
    # Nonzero biases, so that each lands where it belongs.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(path))), v.shape)
        if "bias" in str(path) else v, params)
    want, _ = cell.apply(params, h, x)
    port = torch.nn.GRUCell(16, 24)
    sd = gru_cell_params_from_flax(jax.device_get(params["params"]))
    port.load_state_dict(sd)
    assert not sd["bias_hh"][:48].any() and sd["bias_hh"][48:].any()
    with torch.no_grad():
        got = port(torch.tensor(np.asarray(x)), torch.tensor(np.asarray(h)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_every_net_matches_the_reference():
    """Each net's forward on random inputs, carried weights."""
    ref, port = _algos()
    nets = port.learner.nets
    rng = np.random.RandomState(0)
    G, C, D, U = MC["stoch_groups"], MC["stoch_classes"], MC["deter"], MC["units"]
    obs = rng.randn(6, 4).astype(np.float32)
    deter = rng.randn(6, D).astype(np.float32)
    stoch = np.eye(C, dtype=np.float32)[rng.randint(C, size=(6, G))]
    embed = rng.randn(6, U).astype(np.float32)
    action = rng.randint(2, size=6)
    t = {k: torch.tensor(v) for k, v in dict(obs=obs, deter=deter, stoch=stoch, embed=embed,
                                              action=action).items()}
    feat = nets.feat(t["deter"], t["stoch"])
    with torch.no_grad():
        got = {
            "encode": nets.encode(t["obs"]),
            "seq": nets.seq(t["deter"], t["stoch"], t["action"]),
            "prior": nets.prior_logits(t["deter"]),
            "posterior": nets.posterior_logits(t["deter"], t["embed"]),
            "decode": nets.dec(feat), "reward": nets.rew(feat), "cont": nets.cont(feat)[..., 0],
            "actor": nets.actor(feat), "critic": nets.critic(feat),
        }
    args = {"encode": (obs,), "seq": (deter, stoch, action), "prior": (deter,),
            "posterior": (deter, embed)}
    for mode, g in got.items():
        want = ref.nets.apply(ref.params, mode, *args.get(mode, (deter, stoch)))
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5, rtol=0, err_msg=mode)
    port.stop()
    ref.stop()


def test_one_train_step_matches_the_reference():
    """One whole update on the reference's replayed batch with its draws:
    every loss, the returns' percentiles through the normalizer, every
    updated weight (the GRU's flax-absent biases unmoved) and the slow
    critic."""
    ref, port = _algos()
    batch = ref.replay.sample(B, T)
    key = jax.random.PRNGKey(7)
    params, slow, _, want = ref._update(ref.params, ref.slow_critic, ref.opt_state, batch, key,
                                        0.0, 1.0)
    got = port.learner.train_step(batch, _train_noise(key))
    want = {k: float(v) for k, v in want.items()}
    assert abs(float(port.learner.ret_lo) - 0.01 * want.pop("ret_p5")) <= 1e-7
    assert abs(float(port.learner.ret_hi) - (0.99 + 0.01 * want.pop("ret_p95"))) <= 1e-7
    assert_metrics_close({k: float(v) for k, v in got.items()}, want)
    want_params = dreamer_params_from_flax(jax.device_get(params))
    now = port.learner.nets.state_dict()
    assert sorted(now) == sorted(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(now[k].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=k)
    assert not now["gru.bias_hh"][: 2 * MC["deter"]].any()
    want_slow = dreamer_params_from_flax(jax.device_get(slow))
    for k, v in port.learner.slow_critic.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_slow["critic." + k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    port.stop()
    ref.stop()


def test_acting_matches_the_reference():
    """Two recurrent acting steps for two envs (a reset, then a step on
    the previous action) with the reference's draws for each key."""
    ref, port = _algos()
    rng = np.random.RandomState(3)
    G, C, D = MC["stoch_groups"], MC["stoch_classes"], MC["deter"]
    deter, stoch = np.zeros((2, D), np.float32), np.zeros((2, G, C), np.float32)
    t_deter, t_stoch = torch.tensor(deter), torch.tensor(stoch)
    prev, first = np.zeros(2, np.int64), np.ones(2, np.float32)
    for step in range(2):
        obs = rng.randn(2, 4).astype(np.float32)
        key = jax.random.PRNGKey(11 + step)
        k1, k2 = jax.random.split(key)
        noise = {"post": torch.tensor(np.asarray(jax.random.gumbel(k1, (2, G, C)))),
                 "act": torch.tensor(np.asarray(jax.random.gumbel(k2, (2, 2))))}
        deter, stoch, want = ref._act(ref.params, deter, stoch, obs, prev, first, key)
        t_deter, t_stoch, got = port.learner.act(t_deter, t_stoch, obs, prev, first, noise)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(t_deter.numpy(), np.asarray(deter), atol=1e-5, rtol=0)
        # one-hot + p - p: exact up to the rounding of p's round trip
        np.testing.assert_allclose(t_stoch.numpy(), np.asarray(stoch), atol=1e-6, rtol=0)
        prev, first = np.asarray(want), np.zeros(2, np.float32)
    port.stop()
    ref.stop()


def test_checkpoint_restores_the_learner(tmp_path):
    _, port = _algos()
    port.train()
    port.learner.train_step(port.replay.sample(B, T)) if len(port.replay) else None
    port.save_checkpoint(str(tmp_path))
    before = {k: v.clone() for k, v in port.learner.nets.state_dict().items()}
    lo = float(port.learner.ret_lo)
    other = port_dv3.DreamerV3Config().environment("CartPole-v1").training(
        model_config=MC, num_envs=2).learners(num_gpus_per_learner=0).debugging(seed=1).build()
    other.load_checkpoint(str(tmp_path))
    for k, v in other.learner.nets.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert float(other.learner.ret_lo) == lo
    port.stop()
    other.stop()


# --------------------------------------------- learning, on the port's runtime


def test_tuned_examples_registry_and_ppo_regression(cluster):  # noqa: F811
    """tests/test_rllib_breadth.py's case on the port's copies of the four
    YAML files: PPO's regression passes, and an impossible bar fails."""
    names = {os.path.basename(p) for p in tx.list_examples()}
    assert {"cartpole_ppo.yaml", "cartpole_dqn.yaml", "pendulum_sac.yaml",
            "cartpole_dreamerv3.yaml"} <= names
    res = tx.run_regression(os.path.join(tx.EXAMPLES_DIR, "cartpole_ppo.yaml"), config=CPU)
    assert res.passed, (res.best, res.iterations)
    assert res.best["episode_return_mean"] >= 80.0
    assert len(res.history) == res.iterations
    with open(os.path.join(tx.EXAMPLES_DIR, "cartpole_ppo.yaml")) as f:
        spec = yaml.safe_load(f)
    spec["stop"] = {"episode_return_mean": 1e9}
    spec["max_iterations"] = 1
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        yaml.safe_dump(spec, f)
        impossible = f.name
    res2 = tx.run_regression(impossible, config=CPU)
    assert not res2.passed and res2.iterations == 1
    os.unlink(impossible)


def test_dreamerv3_cartpole_learns_in_imagination(cluster):  # noqa: F811
    """The tuned example (the reference's hyperparameters, bar and budget:
    55 within 50 iterations), learning in the model on a CPU learner."""
    res = tx.run_regression(os.path.join(tx.EXAMPLES_DIR, "cartpole_dreamerv3.yaml"), config=CPU)
    assert res.passed, (res.best, res.iterations)
    assert res.best["episode_return_mean"] >= 55.0
