"""The port's dryrun (`ray_tpu_torch.dryrun`) and the dense step on a mesh
with fsdp, seq and tensor together, on the CPU.

The dense step: llama-tiny in float32 on MeshSpec(fsdp=2, seq=2,
tensor=2), 8 gloo ranks (`parallel.launch.spawn`): tensor parallelism and
FSDP2 from `shard_params`, ring attention over the TP-local heads, the
seq group's gradient sum after FSDP2's reduction. Its loss and gathered
gradients against the port's single-device step (1e-5) and the reference's
single-device `jax.value_and_grad` (1e-4); the reference's own sharded
step on three axes gives another loss (ROADMAP Queue 3), so it is not
the oracle. Then `entry()` and the whole `dryrun_multichip(16)` over gloo
ranks on the CPU.
"""
import math
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu_torch import dryrun
from ray_tpu_torch.convert import llama_params_from_flax
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel.launch import run_sharded_grads, spawn
from ray_tpu_torch.parallel.mesh import MeshSpec

SELF_TOL = 1e-5
GRAD_TOL = 1e-4
DEADLINE_S = 180
CFG = replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32)
JCFG = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)


@pytest.fixture(scope="module")
def flax_params():
    return jllama.LlamaForCausalLM(JCFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


@pytest.fixture(scope="module")
def dense_step(flax_params):
    ids = np.random.RandomState(0).randint(0, CFG.vocab_size, (4, 64))
    spec = MeshSpec(fsdp=2, seq=2, tensor=2)
    results = spawn(run_sharded_grads, spec.num_devices, spec, CFG,
                    llama_params_from_flax(flax_params), ids, "cpu", deadline_s=DEADLINE_S)
    return ids, results


def test_dense_fsdp_seq_tensor_step_matches_single_device(dense_step, flax_params):
    ids, results = dense_step
    model = tllama.LlamaForCausalLM(CFG, device="cpu")
    model.load_state_dict(llama_params_from_flax(flax_params))
    tids = torch.from_numpy(ids).long()
    loss = tllama.causal_lm_loss(model(tids), torch.roll(tids, -1, dims=1))
    loss.backward()
    for r in results:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=SELF_TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][name].numpy(), p.grad.numpy(),
                                       atol=SELF_TOL, rtol=SELF_TOL, err_msg=name)

    jmodel = jllama.LlamaForCausalLM(JCFG)
    jids = jnp.asarray(ids, jnp.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.causal_lm_loss(jmodel.apply(p, jids), jnp.roll(jids, -1, axis=1))
    )(flax_params)
    np.testing.assert_allclose(results[0]["loss"], float(jloss), rtol=GRAD_TOL)
    for name, g in llama_params_from_flax(jgrads).items():
        np.testing.assert_allclose(results[0]["grads"][name].numpy(), g.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_entry_on_the_cpu():
    fn, args = dryrun.entry("cpu")
    with torch.no_grad():
        out = fn(*args)
    assert out.shape == (1, 256, tllama.CONFIGS["llama-125m"].vocab_size)
    assert bool(torch.isfinite(out.float()).all())


def test_dryrun_multichip_on_the_cpu(capsys):
    """All three parts over gloo ranks, 16 for the dense mesh (data 2 x
    fsdp 2 x seq 2 x tensor 2) and the MoE mesh (data 4 x expert 4), 4
    for the pipeline: each prints the reference's line with a finite
    loss."""
    dryrun.dryrun_multichip(16, device="cpu")
    out = capsys.readouterr().out
    patterns = [
        r"dryrun_multichip OK: 16 devices, mesh \{'data': 2, 'fsdp': 2, 'seq': 2, "
        r"'tensor': 2\}, loss (\S+)",
        r"dryrun_multichip MoE OK: mesh data=4 expert=4, loss (\S+)",
        r"dryrun_multichip PP OK: pipe=4 stages, 8 microbatches, loss (\S+)",
    ]
    for pattern in patterns:
        found = re.search(pattern, out)
        assert found, (pattern, out)
        assert math.isfinite(float(found.group(1)))


def test_dryrun_multichip_on_the_card_needs_a_card_per_rank(monkeypatch):
    """By default each rank takes a card; with fewer cards than ranks the
    dryrun raises, naming how many it needs, and runs nothing on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(dryrun, "spawn", lambda *a, **k: pytest.fail("a world was spawned"))
    with pytest.raises(ValueError, match="needs 16 cards; this host has 8"):
        dryrun.dryrun_multichip(10)
