"""The port's Llama (ray_tpu_torch.models.llama) against the flax model.

The flax model's parameters go through `llama_params_from_flax`, so both
sides hold the same weights; token ids come from numpy seeds. On the CPU
the port's attention takes its plain path and the JAX model its XLA
reference, so with float32 compute only the order of summation differs.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu_torch.convert import llama_params_from_flax
from ray_tpu_torch.models import llama as tllama

# float32 compute: summation order only.
F32_TOL = 1e-4
# bf16 compute: both sides round activations to bf16 after every
# projection (8 bits of mantissa), at different points inside fused ops,
# so logits of size ~1 differ by a few bf16 ulps.
BF16_ATOL = 6e-2
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers beside timing-sensitive runtime
    # tests; at these sizes one thread loses nothing.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    jkw = {k: (jnp.float32 if v is torch.float32 else v) for k, v in kw.items()}
    return (replace(jllama.CONFIGS["llama-tiny"], **jkw),
            replace(tllama.CONFIGS["llama-tiny"], **kw))


def _ids(b, t, seed, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _pair(**kw):
    jcfg, tcfg = _cfgs(**kw)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(llama_params_from_flax(params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(dtype=torch.float32)


@pytest.mark.parametrize(
    "kw,atol",
    [
        (dict(dtype=torch.float32), F32_TOL),
        (dict(), BF16_ATOL),  # the default: bf16 compute, f32 params
        (dict(dtype=torch.float32, tie_embeddings=True), F32_TOL),
    ],
)
def test_logits_match_jax(kw, atol):
    jmodel, params, tmodel = _pair(**kw)
    ids = _ids(2, 48, 0)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, 48, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=F32_TOL)


def test_grads_match_jax(f32_pair):
    jmodel, params, tmodel = f32_pair
    ids = _ids(2, 40, 1)
    targets = np.roll(ids, -1, axis=1)

    def loss_fn(p):
        return jllama.causal_lm_loss(jmodel.apply(p, jnp.asarray(ids)), jnp.asarray(targets))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    want = llama_params_from_flax(grads_j)
    tmodel.zero_grad()
    loss_t = tllama.causal_lm_loss(tmodel(torch.from_numpy(ids).long()),
                                   torch.from_numpy(targets).long())
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=F32_TOL)
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("with_mask", [False, True])
def test_chunked_loss_matches_jax_at_odd_length(f32_pair, with_mask):
    jmodel, params, tmodel = f32_pair
    t, chunk = 37, 16  # 37 = 2 chunks + 5 rows, 11 padded rows
    ids = _ids(2, t, 2)
    targets = np.roll(ids, -1, axis=1)
    mask = (np.random.RandomState(3).rand(1, t) > 0.3).astype(np.float32) if with_mask else None
    want = jllama.chunked_causal_lm_loss(
        jmodel, params, jnp.asarray(ids), jnp.asarray(targets),
        mask=None if mask is None else jnp.asarray(mask), chunk_size=chunk)
    tids, ttg = torch.from_numpy(ids).long(), torch.from_numpy(targets).long()
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = tllama.chunked_causal_lm_loss(tmodel, tids, ttg, mask=tmask, chunk_size=chunk)
        full = tllama.causal_lm_loss(tmodel(tids), ttg, mask=tmask)
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL)
    np.testing.assert_allclose(got.item(), full.item(), rtol=F32_TOL)


def test_chunked_loss_grads_match_full_loss(f32_pair):
    _, _, tmodel = f32_pair
    ids = torch.from_numpy(_ids(2, 37, 4)).long()
    targets = torch.roll(ids, -1, dims=1)
    grads = []
    for loss_fn in (
        lambda: tllama.chunked_causal_lm_loss(tmodel, ids, targets, chunk_size=16),
        lambda: tllama.causal_lm_loss(tmodel(ids), targets),
    ):
        tmodel.zero_grad()
        loss_fn().backward()
        grads.append({n: p.grad.clone() for n, p in tmodel.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[0][name], grads[1][name], atol=1e-6, rtol=1e-5)


def test_remat_policies_give_the_same_grads(f32_pair):
    _, _, base = f32_pair
    ids = torch.from_numpy(_ids(1, 24, 5)).long()
    targets = torch.roll(ids, -1, dims=1)
    grads = []
    for cfg in (replace(base.cfg, remat=False), replace(base.cfg, remat_policy="dots"),
                base.cfg):
        model = tllama.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(base.state_dict())
        tllama.causal_lm_loss(model(ids), targets).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for other in grads[1:]:
        for name, g in grads[0].items():
            torch.testing.assert_close(other[name], g, atol=1e-6, rtol=1e-5)


def test_unknown_remat_policy_raises():
    _, tcfg = _cfgs(remat_policy="everything")
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model(torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("name", sorted(jllama.CONFIGS))
def test_num_params_matches_jax(name):
    assert tllama.CONFIGS[name].num_params() == jllama.CONFIGS[name].num_params()


@pytest.mark.parametrize("tie", [False, True])
def test_num_params_counts_the_model(tie):
    jmodel, params, tmodel = _pair(tie_embeddings=tie)
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    n_torch = sum(p.numel() for p in tmodel.parameters())
    assert n_torch == n_jax == tmodel.cfg.num_params()


def test_causality(f32_pair):
    """Changing a future token must not affect earlier logits."""
    _, _, tmodel = f32_pair
    ids = torch.from_numpy(_ids(1, 16, 6)).long()
    changed = ids.clone()
    changed[0, 10] = (changed[0, 10] + 1) % 512
    with torch.no_grad():
        a, b = tmodel(ids), tmodel(changed)
    torch.testing.assert_close(a[:, :10], b[:, :10], atol=0, rtol=0)
    assert not torch.allclose(a[:, 10:], b[:, 10:])


def test_params_made_from_the_generator_seed():
    _, tcfg = _cfgs()
    make = lambda seed: tllama.LlamaForCausalLM(  # noqa: E731
        tcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    a, b, c = make(1).state_dict(), make(1).state_dict(), make(2).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed_tokens.weight"], c["embed_tokens.weight"])
    assert all(p.dtype == torch.float32 for p in a.values())


def test_model_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaForCausalLM(tcfg)
