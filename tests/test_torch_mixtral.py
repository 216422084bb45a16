"""The port's Mixtral (ray_tpu_torch.models.mixtral) against the flax model,
on the CPU at mixtral-tiny.

The flax parameters go through `mixtral_params_from_flax`, so both sides
hold the same weights; token ids and activations come from numpy seeds.
Routing is discrete: a router logit that differs in its last bit can flip a
near-tie in the top-k and move a token to another expert, which changes the
output by O(1). So every comparison of outputs first asserts that both sides
chose the same experts (`gate_idx`), and fails with that message on a flip.
With float32 compute only the order of summation differs: 1e-4 for logits,
losses and gradients. On the CPU the port's kernels take their plain
versions and the JAX model's Pallas kernels run in interpret mode.
"""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import mixtral as jmix
from ray_tpu_torch import bench
from ray_tpu_torch.convert import mixtral_params_from_flax
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import gmm as tgmm

F32_TOL = 1e-4
# bf16 compute: both sides round activations to bf16 after every
# projection, at different points inside fused ops: a few bf16 ulps of
# logits of size ~1.
BF16_ATOL = 6e-2
# The port against itself, gmm against the ragged oracle: the same float32
# products, grouped differently.
SELF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers beside timing-sensitive runtime
    # tests; at these sizes one thread loses nothing.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def _cfgs(**kw):
    jkw = {k: (jnp.float32 if v is torch.float32 else v) for k, v in kw.items()}
    return (replace(jmix.CONFIGS["mixtral-tiny"], **jkw),
            replace(tmix.CONFIGS["mixtral-tiny"], **kw))


def _ids(b, t, seed, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    jcfg, _ = _cfgs(dtype=torch.float32, remat=False)
    return jmix.MixtralForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8), jnp.int32))


def _port(tcfg, params):
    model = tmix.MixtralForCausalLM(tcfg, device="cpu")
    model.load_state_dict(mixtral_params_from_flax(params))
    return model


def _top_k(logits, k=2):
    return np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits, jnp.float32)), k)[1])


def _jax_routing(jmodel, params, ids):
    """Logits and each layer's chosen experts [B, T, K] of the flax model."""
    logits, state = jmodel.apply(params, jnp.asarray(ids), capture_intermediates=True)
    inter = state["intermediates"]
    gates = [_top_k(inter[f"layers_{i}"]["moe"]["router"]["__call__"][0])
             for i in range(jmodel.cfg.num_layers)]
    return np.asarray(logits.astype(jnp.float32)), gates


def _port_routing(model, ids, **kw):
    """Output of `model(ids, **kw)` and each layer's chosen experts."""
    seen = []
    hooks = [layer.moe.router.register_forward_hook(
        lambda mod, args, out: seen.append(_top_k(out.detach().numpy())))
        for layer in model.layers]
    try:
        out = model(torch.from_numpy(ids).long(), **kw)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def _assert_same_routing(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (
            f"layer {i}: the port routed {int((g != w).sum())} (token, k) pairs to "
            "other experts than the flax model (a near-tie in the router flipped)")


@pytest.mark.parametrize(
    "dispatch,capacity_factor",
    [
        ("gmm", 1.25),
        ("ragged", 1.25),
        ("capacity", 8.0),   # ample: nothing dropped
        ("capacity", 0.5),   # pairs past capacity dropped
    ],
)
def test_logits_match_jax(interpret, flax_params, dispatch, capacity_factor):
    kw = dict(dtype=torch.float32, remat=False, moe_dispatch=dispatch,
              capacity_factor=capacity_factor)
    jcfg, tcfg = _cfgs(**kw)
    ids = _ids(2, 32, 0)
    want, want_routes = _jax_routing(jmix.MixtralForCausalLM(jcfg), flax_params, ids)
    with torch.no_grad():
        got, routes = _port_routing(_port(tcfg, flax_params), ids)
    _assert_same_routing(routes, want_routes)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_logits_match_jax(interpret):
    """The default compute type, bf16 over float32 parameters, gmm. One
    layer: the two frameworks round to bf16 at other points, and through a
    second layer's router that flips near-ties (2 of 128 pairs at two
    layers with these seeds)."""
    jcfg, tcfg = _cfgs(remat=False, moe_dispatch="gmm", num_layers=1)
    jmodel = jmix.MixtralForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    ids = _ids(2, 32, 1)
    want, want_routes = _jax_routing(jmodel, params, ids)
    with torch.no_grad():
        got, routes = _port_routing(_port(tcfg, params), ids)
    _assert_same_routing(routes, want_routes)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=F32_TOL)


def test_router_aux_loss_matches_jax(flax_params):
    jcfg, tcfg = _cfgs(dtype=torch.float32, remat=False, moe_dispatch="capacity")
    ids = _ids(4, 32, 2)
    _, state = jmix.MixtralForCausalLM(jcfg).apply(flax_params, jnp.asarray(ids),
                                                   mutable=["intermediates"])
    want = [float(x) for x in jax.tree_util.tree_leaves(state["intermediates"])]
    with torch.no_grad():
        (_, aux), routes = _port_routing(_port(tcfg, flax_params), ids, return_aux=True)
    assert len(aux) == len(want) == tcfg.num_layers
    np.testing.assert_allclose([float(a) for a in aux], want, rtol=F32_TOL)
    # E * sum(frac_tokens * frac_probs): near K for a near-uniform router.
    k = tcfg.num_experts_per_tok
    assert all(0.5 * k < float(a) < 2.0 * k for a in aux)


def test_moe_lm_loss_and_grads_match_jax(interpret, flax_params):
    # The port checkpoints its layers (remat "dots"); flax's remat would
    # change no value and only slow the interpreted kernels.
    jcfg, tcfg = _cfgs(dtype=torch.float32, moe_dispatch="gmm")
    jmodel = jmix.MixtralForCausalLM(replace(jcfg, remat=False))
    ids = _ids(2, 40, 3)
    targets = np.roll(ids, -1, axis=1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jmix.moe_lm_loss(jmodel, p, jnp.asarray(ids), jnp.asarray(targets))
    ))(flax_params)
    model = _port(tcfg, flax_params)
    _, routes = _port_routing(model, ids)
    _assert_same_routing(routes, _jax_routing(jmodel, flax_params, ids)[1])
    loss_t = tmix.moe_lm_loss(model, torch.from_numpy(ids).long(),
                              torch.from_numpy(targets).long())
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=F32_TOL)
    want = mixtral_params_from_flax(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)


def _layer_outputs(cfg, params, x):
    layer = tmix.MoELayer(cfg, device="cpu")
    layer.load_state_dict(params)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = layer(xt)
    (out.pow(2).sum() + aux).backward()
    return out.detach(), xt.grad, {n: p.grad for n, p in layer.named_parameters()}


@pytest.mark.parametrize("dispatch,capacity_factor", [("gmm", 1.25), ("capacity", 8.0)])
def test_dispatch_agrees_with_ragged(dispatch, capacity_factor):
    """Outputs and gradients of one layer against the exact-group oracle,
    in the port alone (with ample capacity nothing is dropped)."""
    _, cfg = _cfgs(dtype=torch.float32, capacity_factor=capacity_factor)
    base = tmix.MoELayer(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    x = np.random.RandomState(5).randn(2, 16, cfg.hidden_size).astype(np.float32)
    want = _layer_outputs(replace(cfg, moe_dispatch="ragged"), base.state_dict(), x)
    got = _layer_outputs(replace(cfg, moe_dispatch=dispatch), base.state_dict(), x)
    torch.testing.assert_close(got[0], want[0], atol=SELF_TOL, rtol=SELF_TOL)
    torch.testing.assert_close(got[1], want[1], atol=SELF_TOL, rtol=SELF_TOL)
    for name, g in want[2].items():
        torch.testing.assert_close(got[2][name], g, atol=SELF_TOL, rtol=SELF_TOL, msg=name)


def test_capacity_drops_tokens():
    """Capacity 1 per expert and batch row: only each expert's first
    arrival is kept, so a late token whose experts are both taken gets 0."""
    _, cfg = _cfgs(dtype=torch.float32, capacity_factor=1e-9, moe_dispatch="capacity")
    layer = tmix.MoELayer(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 16, cfg.hidden_size)
                         .astype(np.float32))
    with torch.no_grad():
        out, _ = layer(x)
    per_token = out.abs().sum(-1)
    assert (per_token[:, -1] == 0).all()
    # At most E * C = 4 pairs per row survive: at most 4 tokens are non-zero.
    assert int((per_token > 0).sum(1).max()) <= cfg.num_experts


def test_gradients_equal_across_remat_policies(flax_params):
    """A checkpointed layer recomputes its forward, layout and data-dependent
    indices included, without a metadata mismatch, and gives the gradients
    of the uncheckpointed one."""
    ids = torch.from_numpy(_ids(1, 24, 6)).long()
    targets = torch.roll(ids, -1, dims=1)
    grads = []
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "nothing")):
        _, cfg = _cfgs(dtype=torch.float32, moe_dispatch="gmm", remat=remat,
                       remat_policy=policy)
        model = _port(cfg, flax_params)
        tmix.moe_lm_loss(model, ids, targets).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for other in grads[1:]:
        for name, g in grads[0].items():
            torch.testing.assert_close(other[name], g, atol=1e-6, rtol=1e-5, msg=name)


def test_kernel_calls_per_train_step(monkeypatch):
    """What the smoke expects of the card, counted here through the plain
    versions: under remat "dots" a train step runs, per layer, K1 twice
    (forward and recompute), K2 and K3 once, K4 nine times (gate, up and
    down in the forward, again in the recompute, and each one's dlhs) and
    K5 three times (each one's drhs)."""
    calls = {"flash_fwd": 0, "flash_bwd": 0, "gmm": 0, "tgmm": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tattn, "flash_fwd", counted("flash_fwd", tattn.flash_fwd))
    monkeypatch.setattr(tattn, "flash_bwd", counted("flash_bwd", tattn.flash_bwd))
    monkeypatch.setattr(tgmm, "grouped_matmul", counted("gmm", tgmm.grouped_matmul))
    monkeypatch.setattr(tgmm, "transposed_grouped_matmul",
                        counted("tgmm", tgmm.transposed_grouped_matmul))
    _, cfg = _cfgs(moe_dispatch="gmm", num_layers=3)
    model = tmix.MixtralForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(_ids(2, 32, 7)).long()
    bench.train_step(model, bench.make_optimizer(model), ids, torch.roll(ids, -1, 1),
                     tmix.moe_lm_loss)
    n = cfg.num_layers
    assert calls == {"flash_fwd": 2 * n, "flash_bwd": n, "gmm": 9 * n, "tgmm": 3 * n}


def test_train_steps_match_jax(interpret, flax_params):
    """Two AdamW steps of `moe_lm_loss` against optax with the reference's
    hyperparameters, float32 parameters and compute, gmm dispatch. optax
    keeps the first moment in bf16 (`mu_dtype`), torch in float32, and Adam
    divides each gradient by its own running RMS, so a parameter whose
    gradient is near zero takes a step that depends on the gradient's last
    bits: after two steps one element in 32768 of an expert matrix differs
    by 3.2e-5, against steps of 3e-4 each. Losses agree to 2e-4 relative,
    parameters to 1e-4 absolute."""
    jcfg, tcfg = _cfgs(dtype=torch.float32, moe_dispatch="gmm")
    jmodel = jmix.MixtralForCausalLM(replace(jcfg, remat=False))
    ids = _ids(2, 32, 8)
    targets = np.roll(ids, -1, axis=1)
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)
    params, opt_state = flax_params, tx.init(flax_params)

    @jax.jit
    def jax_step(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: jmix.moe_lm_loss(jmodel, p, jnp.asarray(ids), jnp.asarray(targets))
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    model = _port(tcfg, flax_params)
    optimizer = bench.make_optimizer(model)
    tids, ttg = torch.from_numpy(ids).long(), torch.from_numpy(targets).long()
    for step in range(2):
        _, routes = _port_routing(model, ids)
        _assert_same_routing(routes, _jax_routing(jmodel, params, ids)[1])
        params, opt_state, loss_j = jax_step(params, opt_state)
        loss_t = bench.train_step(model, optimizer, tids, ttg, tmix.moe_lm_loss)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-4,
                                   err_msg=f"step {step}")
    want = mixtral_params_from_flax(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("name", sorted(jmix.CONFIGS))
def test_param_counts_match_jax(name):
    assert tmix.CONFIGS[name].num_params() == jmix.CONFIGS[name].num_params()
    assert (tmix.CONFIGS[name].active_params_per_token()
            == jmix.CONFIGS[name].active_params_per_token())


def test_param_counts_keep_the_reference_head_overcount(flax_params):
    """Both models tie the head to the embedding whatever `tie_embeddings`
    says, but the counts (from Llama's, untied by default) include a V * H
    head. Pinned at mixtral-small; the tiny model holds V * H fewer."""
    small = tmix.CONFIGS["mixtral-small"]
    assert (small.num_params(), small.active_params_per_token()) == (795_427_840, 266_945_536)
    _, cfg = _cfgs()
    n_torch = sum(p.numel() for p in tmix.MixtralForCausalLM(cfg, device="cpu").parameters())
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(flax_params))
    assert n_torch == n_jax == cfg.num_params() - cfg.vocab_size * cfg.hidden_size


@pytest.fixture
def fresh_resolution(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RAY_TPU_MOE_DISPATCH", raising=False)
    monkeypatch.setattr(tmix, "_RESOLVED", {})
    monkeypatch.setattr(tmix, "PROBE_SECONDS", {})
    return tmp_path


def test_resolve_moe_dispatch_probes_and_caches_on_cpu(fresh_resolution, monkeypatch):
    _, cfg = _cfgs()
    assert tmix.resolve_moe_dispatch(replace(cfg, moe_dispatch="ragged")) == "ragged"
    monkeypatch.setenv("RAY_TPU_MOE_DISPATCH", "ragged")
    assert tmix.resolve_moe_dispatch(cfg, device="cpu") == "ragged"
    monkeypatch.setenv("RAY_TPU_MOE_DISPATCH", "dense")
    with pytest.raises(ValueError, match="RAY_TPU_MOE_DISPATCH"):
        tmix.resolve_moe_dispatch(cfg, device="cpu")
    monkeypatch.delenv("RAY_TPU_MOE_DISPATCH")
    tmix._RESOLVED.clear()

    winner = tmix.resolve_moe_dispatch(cfg, tokens=64, steps=1, device="cpu")
    (key, seconds), = tmix.PROBE_SECONDS.items()
    assert key.startswith("cpu-") and set(seconds) == {"capacity", "gmm"}
    faster = seconds["capacity"] < (1 - tmix.PROBE_MARGIN) * seconds["gmm"]
    assert winner == ("capacity" if faster else "gmm")
    cache = fresh_resolution / ".cache" / "ray_tpu_torch" / "moe_dispatch.json"
    assert json.loads(cache.read_text()) == {key: winner}
    # "auto" layers now take the winner.
    assert tmix.MoELayer(cfg, device="cpu").dispatch() == winner
    # A fresh process reads the disk cache and does not probe again.
    tmix._RESOLVED.clear()
    monkeypatch.setattr(tmix, "_probe_seconds", None)
    assert tmix.resolve_moe_dispatch(cfg, tokens=64, device="cpu") == winner


@pytest.mark.parametrize("capacity_s, winner", [(0.95, "gmm"), (0.91, "gmm"), (0.89, "capacity"),
                                                (1.2, "gmm")])
def test_resolve_moe_dispatch_keeps_gmm_within_the_margin(fresh_resolution, monkeypatch,
                                                          capacity_s, winner):
    """"capacity" must beat "gmm" by more than PROBE_MARGIN of gmm's median
    step; a pick inside the probe's noise is always "gmm", so the bench
    runs the same backend from run to run."""
    calls = []

    def medians(cfg, tokens, steps, device):
        calls.append((tokens, steps))
        return {"capacity": capacity_s, "gmm": 1.0}

    monkeypatch.setattr(tmix, "_probe_seconds", medians)
    _, cfg = _cfgs()
    assert tmix.resolve_moe_dispatch(cfg, tokens=64, device="cpu") == winner
    assert calls == [(64, 10)]


def test_resolve_moe_dispatch_raises_when_a_backend_fails(fresh_resolution, monkeypatch):
    """No quiet fallback to "capacity": on the card it would hide a kernel
    that fails to build or launch."""
    def broken(*args, **kw):
        raise RuntimeError("gmm kernel launch failed")

    monkeypatch.setattr(tmix, "gmm", broken)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="gmm kernel launch failed"):
        tmix.resolve_moe_dispatch(cfg, tokens=64, steps=1, device="cpu")
    assert not (fresh_resolution / ".cache").exists()


def test_unresolved_auto_takes_capacity_and_unknown_dispatch_raises(fresh_resolution):
    _, cfg = _cfgs()
    assert tmix.MoELayer(cfg, device="cpu").dispatch() == "capacity"
    with pytest.raises(ValueError, match="moe_dispatch"):
        tmix.MoELayer(replace(cfg, moe_dispatch="dense"), device="cpu").dispatch()


def test_model_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmix.MixtralForCausalLM(cfg)


@pytest.mark.parametrize("moe", [True, False])
def test_bench_main_runs_the_moe_phase_on_cpu(capsys, fresh_resolution, moe):
    # The long-context sweep between the two phases has its own tests
    # (test_torch_longctx.py); at its default 8-32k tokens the plain
    # attention's float32 scores would not fit in the CPU's memory.
    args = ["--model", "llama-tiny", "--moe-model", "mixtral-tiny", "--device", "cpu",
            "--batch", "1", "--seq", "32", "--steps", "1", "--moe-dispatch", "gmm",
            "--no-longctx"]
    assert bench.main(args + ([] if moe else ["--no-moe"])) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and np.isfinite(line["value"])
    if not moe:
        assert not any(k.startswith("moe_") for k in line)
        return
    assert line["moe_model"] == "mixtral-tiny (4 experts, top-2)"
    assert line["moe_dispatch"] == "gmm"
    assert np.isfinite(line["moe_loss"]) and line["moe_tokens_per_s"] > 0
    assert 0 < line["moe_mfu_active"] < 1
