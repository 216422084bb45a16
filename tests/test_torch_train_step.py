"""The port's train step (ray_tpu_torch.bench) against the JAX step that the
repo-root bench.py builds, on the CPU at llama-tiny with float32 params.

Both start from the same weights (`llama_params_from_flax`) and batch.
The two optimizers differ on purpose in one place: optax keeps the first
moment in bf16 (`mu_dtype=bfloat16`) while torch's AdamW keeps it in the
parameter dtype, float32 here. Weight decay is placed the same way (both
add lr * 1e-4 * p to the step). The bf16 moment moves the third step's
loss by about 6e-5 relative (it is 1e-7 with a float32 moment), so losses
agree to 2e-4 relative. Adam divides each gradient by its own running
RMS, so a parameter whose gradient is near zero takes a step that
depends on the gradient's last bits, which the two frameworks sum in
different orders: parameters after three steps differ by up to 1.1e-5
with either moment dtype, so they agree to 3e-5 absolute.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import llama as jllama
from ray_tpu_torch import bench
from ray_tpu_torch.convert import llama_params_from_flax
from ray_tpu_torch.models import llama as tllama

STEPS = 3
LOSS_RTOL = 2e-4
PARAM_ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers beside timing-sensitive runtime
    # tests; at these sizes one thread loses nothing.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_steps_match_jax():
    jcfg = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)
    tcfg = replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    targets = np.roll(ids, -1, axis=1)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1, :8]))

    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(llama_params_from_flax(params))
    optimizer = bench.make_optimizer(tmodel)

    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state):
        def loss_fn(p):
            return jllama.causal_lm_loss(jmodel.apply(p, jnp.asarray(ids)), jnp.asarray(targets))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    tids, ttg = torch.from_numpy(ids).long(), torch.from_numpy(targets).long()
    for step in range(STEPS):
        params, opt_state, loss_j = jax_step(params, opt_state)
        loss_t = bench.train_step(tmodel, optimizer, tids, ttg)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    want = llama_params_from_flax(params)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_optimizer_matches_the_reference_hyperparameters():
    model = tllama.LlamaForCausalLM(tllama.CONFIGS["llama-tiny"], device="cpu")
    group = bench.make_optimizer(model).param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.95), 1e-8, 1e-4)


@pytest.mark.parametrize("chunked", [False, True])
def test_bench_model_on_cpu_loss_falls(chunked):
    model = tllama.LlamaForCausalLM(tllama.CONFIGS["llama-tiny"], device="cpu")
    loss_fn = tllama.chunked_causal_lm_loss if chunked else None
    r = bench.bench_model(model, batch=2, seq=32, steps=2, peak_flops=1e12, loss_fn=loss_fn)
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert r["losses"][-1] < r["losses"][0]
    assert r["tokens_per_s"] > 0 and r["step_ms"] > 0


def test_flops_per_token_matches_the_reference_formula():
    cfg = tllama.CONFIGS["llama-1b"]
    want = 6.0 * cfg.num_params() + 12.0 * cfg.num_layers * 2048 * cfg.hidden_size
    assert bench.flops_per_token(cfg.num_params(), cfg, 2048) == want


def test_bench_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--model", "llama-tiny", "--steps", "1"])


def test_profile_busy_time_is_the_union_of_kernel_intervals():
    from ray_tpu_torch.profile import busy_us

    assert busy_us([]) == 0
    assert busy_us([(30, 40), (0, 10), (5, 20), (35, 36)]) == 30


def test_profile_without_a_card_raises(monkeypatch):
    from ray_tpu_torch import profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.main(["--model", "mixtral-tiny"])
