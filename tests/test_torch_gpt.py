"""The port's GPT (ray_tpu_torch.models.gpt) against the flax model.

The flax model's parameters go through `gpt_params_from_flax`, so both
sides hold the same weights; token ids come from numpy seeds. On the CPU
the port's attention takes its plain path and the JAX model its XLA
reference (the path `tests/test_moe_models.py::test_gpt_forward_and_grads`
runs), so with float32 compute only the order of summation differs. The
four places where the port parts from the reference are pinned here: the
reference's NaN past `max_seq_len` against the port's ValueError, the
reference's parameter count without biases and LayerNorms, the tanh
GELU, and the bf16 logits of the tied head.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import gpt as jgpt
from ray_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from ray_tpu_torch import bench
from ray_tpu_torch.convert import gpt_params_from_flax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.llama import causal_lm_loss

# float32 compute: summation order only (logits differ by about 3e-6).
F32_TOL = 1e-4
GRAD_TOL = 1e-4
# bf16 compute: both sides round activations to bf16 after every
# projection, at different points inside fused ops, so logits of size ~4
# differ by one or two bf16 ulps (0.031 at |x| >= 4), about 0.8% normwise.
BF16_ATOL = 6e-2
BF16_REL = 2e-2
# Two AdamW steps, as tests/test_torch_train_step.py states for Llama:
# optax keeps the first moment in bf16, torch in float32.
LOSS_RTOL = 2e-4
PARAM_ATOL = 3e-5
VOCAB = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers beside timing-sensitive runtime
    # tests; at these sizes one thread loses nothing.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    jkw = {k: {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}.get(v, v)
           for k, v in kw.items()}
    return (replace(jgpt.CONFIGS["gpt2-tiny"], **jkw),
            replace(tgpt.CONFIGS["gpt2-tiny"], **kw))


def _ids(b, t, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(np.int32)


def _pair(**kw):
    jcfg, tcfg = _cfgs(**kw)
    jmodel = jgpt.GPTForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = tgpt.GPTForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(dtype=torch.float32, remat=False)


def test_f32_logits_match_jax(f32_pair):
    jmodel, params, tmodel = f32_pair
    ids = _ids(2, 48, 0)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, 48, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_grads_match_jax(f32_pair):
    """Every gradient, mapped through the same converter as the weights: a
    wrong reshape or transpose of the fused c_attn or of c_proj shows
    here."""
    jmodel, params, tmodel = f32_pair
    ids = _ids(2, 40, 1)
    targets = np.roll(ids, -1, axis=1)

    def loss_fn(p):
        return jax_causal_lm_loss(jmodel.apply(p, jnp.asarray(ids)), jnp.asarray(targets))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    want = gpt_params_from_flax(grads_j)
    tmodel.zero_grad()
    loss_t = causal_lm_loss(tmodel(torch.from_numpy(ids).long()),
                            torch.from_numpy(targets).long())
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=F32_TOL)
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_bf16_logits_match_jax():
    """The tied head casts both operands to `dtype` (flax's `attend`), so
    the reference's logits are bf16, and so are the port's."""
    jmodel, params, tmodel = _pair()
    ids = _ids(2, 48, 2)
    want = jmodel.apply(params, jnp.asarray(ids))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL


def test_remat_equals_no_remat(f32_pair):
    _, _, base = f32_pair
    ids = torch.from_numpy(_ids(2, 24, 3)).long()
    targets = torch.roll(ids, -1, dims=1)
    grads = []
    for remat in (False, True):
        model = tgpt.GPTForCausalLM(replace(base.cfg, remat=remat), device="cpu")
        model.load_state_dict(base.state_dict())
        causal_lm_loss(model(ids), targets).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-5)


def test_gelu_is_the_tanh_form(f32_pair, monkeypatch):
    """flax's `nn.gelu` defaults to the tanh approximation: the port
    matches the reference within F32_TOL, and the exact (erf) form, about
    1e-3 away in the logits, does not."""
    jmodel, params, tmodel = f32_pair
    ids = _ids(2, 48, 4)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        tanh = tmodel(tids).numpy()
        gelu = torch.nn.functional.gelu
        monkeypatch.setattr(torch.nn.functional, "gelu",
                            lambda x, approximate="none": gelu(x))
        erf = tmodel(tids).numpy()
    np.testing.assert_allclose(tanh, want, atol=F32_TOL, rtol=F32_TOL)
    assert not np.allclose(erf, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", ["length 257", "position 256"])
def test_past_max_seq_len_the_reference_gives_nan_and_the_port_raises(f32_pair, case):
    """gpt2-tiny has 256 positions. flax's lookup fills a row past the
    table with NaN, and causal attention spreads it to every row; the port
    raises instead."""
    jmodel, params, tmodel = f32_pair
    if case == "length 257":
        ids, positions = _ids(1, 257, 5), None
    else:
        ids = _ids(1, 8, 5)
        positions = np.array([[0, 1, 2, 3, 4, 5, 6, 256]], np.int32)
    jpos = None if positions is None else jnp.asarray(positions)
    logits = np.asarray(jmodel.apply(params, jnp.asarray(ids), jpos))
    assert np.isnan(logits).all(axis=-1).all()
    tpos = None if positions is None else torch.from_numpy(positions).long()
    with pytest.raises(ValueError, match="max_seq_len"):
        tmodel(torch.from_numpy(ids).long(), tpos)


def test_positions_inside_the_table_match_jax(f32_pair):
    """The control for the case above: positions up to 255 are finite on
    both sides and agree."""
    jmodel, params, tmodel = f32_pair
    ids = _ids(1, 8, 5)
    positions = np.array([[0, 1, 2, 3, 4, 5, 6, 255]], np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(positions)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(positions).long())
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("name", sorted(jgpt.CONFIGS))
def test_num_params_matches_jax(name):
    assert tgpt.CONFIGS[name].num_params() == jgpt.CONFIGS[name].num_params()


def test_num_params_keeps_the_reference_undercount_at_gpt2_tiny(f32_pair):
    """The reference counts no bias and no LayerNorm parameter: 147,456
    against the 149,248 that both models hold."""
    _, params, tmodel = f32_pair
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    n_torch = sum(p.numel() for p in tmodel.parameters())
    assert tmodel.cfg.num_params() == 147_456
    assert n_torch == n_jax == 149_248


def test_num_params_keeps_the_reference_undercount_at_gpt2():
    cfg = tgpt.CONFIGS["gpt2"]
    model = tgpt.GPTForCausalLM(cfg, device="meta")
    assert cfg.num_params() == 124_318_464
    assert sum(p.numel() for p in model.parameters()) == 124_439_808


def test_train_steps_match_jax():
    """Two AdamW steps of the port's train step against optax on the JAX
    model, from the same weights and batch (f32 compute)."""
    jmodel, params, tmodel = _pair(dtype=torch.float32)
    ids = _ids(2, 32, 6)
    targets = np.roll(ids, -1, axis=1)
    optimizer = bench.make_optimizer(tmodel)
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state):
        def loss_fn(p):
            return jax_causal_lm_loss(jmodel.apply(p, jnp.asarray(ids)), jnp.asarray(targets))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    tids, ttg = torch.from_numpy(ids).long(), torch.from_numpy(targets).long()
    for step in range(2):
        params, opt_state, loss_j = jax_step(params, opt_state)
        loss_t = bench.train_step(tmodel, optimizer, tids, ttg)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = gpt_params_from_flax(params)
    for name, p in tmodel.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("c_attn.bias"):
            # The keys' bias adds q . b_k to every score of a query row,
            # which the softmax cancels: its gradient is zero but for
            # rounding, and Adam scales that noise to steps of up to lr
            # with either sign on either side. Both stay within those
            # steps; the q and v parts are held as every other parameter.
            width = got.size // 3
            for side in (got, ref):
                assert np.abs(side[width:2 * width]).max() <= 2 * 3e-4 * 1.01, name
            got, ref = np.delete(got, np.s_[width:2 * width]), np.delete(ref, np.s_[width:2 * width])
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_bench_model_trains_gpt_on_cpu():
    model = tgpt.GPTForCausalLM(tgpt.CONFIGS["gpt2-tiny"], device="cpu")
    r = bench.bench_model(model, batch=2, seq=32, steps=2, peak_flops=1e12)
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert r["losses"][-1] < r["losses"][0]


def test_kernel_calls_per_train_step(monkeypatch):
    """What the smoke expects of the card at gpt2-large, counted here
    through the plain versions: with remat a train step runs, per block,
    K1 twice (the forward and its recompute) and K2 and K3 once."""
    from ray_tpu_torch.ops import attention as tattn

    calls = {"flash_fwd": 0, "flash_bwd": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tattn, "flash_fwd", counted("flash_fwd", tattn.flash_fwd))
    monkeypatch.setattr(tattn, "flash_bwd", counted("flash_bwd", tattn.flash_bwd))
    cfg = replace(tgpt.CONFIGS["gpt2-tiny"], num_layers=3)
    model = tgpt.GPTForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(_ids(2, 16, 7)).long()
    bench.train_step(model, bench.make_optimizer(model), ids, torch.roll(ids, -1, 1))
    assert calls == {"flash_fwd": 2 * cfg.num_layers, "flash_bwd": cfg.num_layers}


def test_causality(f32_pair):
    """Changing a future token must not affect earlier logits."""
    _, _, tmodel = f32_pair
    ids = torch.from_numpy(_ids(1, 16, 8)).long()
    changed = ids.clone()
    changed[0, 10] = (changed[0, 10] + 1) % VOCAB
    with torch.no_grad():
        a, b = tmodel(ids), tmodel(changed)
    torch.testing.assert_close(a[:, :10], b[:, :10], atol=0, rtol=0)
    assert not torch.allclose(a[:, 10:], b[:, 10:])


def test_params_made_from_the_generator_seed():
    cfg = tgpt.CONFIGS["gpt2-tiny"]
    make = lambda seed: tgpt.GPTForCausalLM(  # noqa: E731
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    a, b, c = make(1).state_dict(), make(1).state_dict(), make(2).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wte.weight"], c["wte.weight"])
    assert all(p.dtype == torch.float32 for p in a.values())
    # lecun_normal: truncated at two of its standard deviations, 1/sqrt(fan_in).
    w = a["h.0.c_fc.weight"]
    assert float(w.abs().max()) <= 2 * cfg.hidden_size ** -0.5 / tgpt._TRUNCATED_STD
    assert abs(float(w.std()) * cfg.hidden_size ** 0.5 - 1.0) < 0.05
    assert torch.equal(a["h.0.c_fc.bias"], torch.zeros_like(a["h.0.c_fc.bias"]))


def test_model_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTForCausalLM(tgpt.CONFIGS["gpt2-tiny"])
