"""The long-context sweep of the port's bench (`bench.longctx_sweep`), the
port of the repo-root bench.py's sweep, on the CPU at llama-tiny.

The sweep runs llama-1b at 8-32k tokens against its `max_seq_len` of
4096, so the port's Llama is also held to the flax model past its
`max_seq_len`, with the chunked loss the sweep takes.
"""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu_torch import bench
from ray_tpu_torch.convert import llama_params_from_flax
from ray_tpu_torch.models import llama as tllama

F32_TOL = 1e-4
GRAD_TOL = 1e-4
CPU = torch.device("cpu")
TINY = tllama.CONFIGS["llama-tiny"]  # max_seq_len 256
POINT_KEYS = {"seq", "tokens_per_s", "step_ms", "mfu", "loss"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers beside timing-sensitive runtime
    # tests; at these sizes one thread loses nothing.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sweep_at_llama_tiny_past_max_seq_len():
    out = bench.longctx_sweep(TINY, steps=2, peak_flops=1e12, device=CPU, seqs=[64, 320])
    points = out["longctx"]
    assert [p["seq"] for p in points] == [64, 320]
    for p in points:
        assert set(p) == POINT_KEYS  # no device memory on the CPU
        assert np.isfinite(p["loss"]) and p["tokens_per_s"] > 0 and p["mfu"] > 0
    first = points[0]
    assert (out["longctx_seq"], out["longctx_tokens_per_s"], out["longctx_mfu"],
            out["longctx_loss"]) == (64, first["tokens_per_s"], first["mfu"], first["loss"])


def test_sweep_runs_max_5_or_half_the_steps(monkeypatch):
    calls = []

    def fake(model, batch, seq, steps, peak_flops, loss_fn=None, n_params=None):
        calls.append((batch, seq, steps, loss_fn))
        return {"tokens_per_s": 1.0, "step_ms": 1.0, "mfu": 0.5, "losses": [2.0, 1.0]}

    monkeypatch.setattr(bench, "bench_model", fake)
    for steps, timed in ((2, 5), (10, 5), (14, 7)):
        calls.clear()
        bench.longctx_sweep(TINY, steps=steps, peak_flops=1e12, device=CPU, seqs=[16, 32])
        assert calls == [(1, 16, timed, tllama.chunked_causal_lm_loss),
                         (1, 32, timed, tllama.chunked_causal_lm_loss)]


def _failing_at(index, exc):
    """A `bench_model` that raises `exc` at the `index`-th point."""
    seen = []

    def fake(model, batch, seq, steps, peak_flops, loss_fn=None, n_params=None):
        seen.append(seq)
        if len(seen) - 1 == index:
            raise exc
        return {"tokens_per_s": 1.0, "step_ms": 1.0, "mfu": 0.5, "losses": [2.0, 1.0]}

    return fake, seen


def test_out_of_memory_at_a_later_point_is_recorded_and_ends_the_sweep(monkeypatch):
    fake, seen = _failing_at(1, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    monkeypatch.setattr(bench, "bench_model", fake)
    out = bench.longctx_sweep(TINY, steps=2, peak_flops=1e12, device=CPU, seqs=[16, 32, 48])
    assert seen == [16, 32]
    assert out["longctx"][1] == {"seq": 32, "oom": "OutOfMemoryError"}
    assert out["longctx_seq"] == 16 and out["longctx_loss"] == 1.0


def test_out_of_memory_at_the_first_point_raises(monkeypatch):
    fake, _ = _failing_at(0, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    monkeypatch.setattr(bench, "bench_model", fake)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench.longctx_sweep(TINY, steps=2, peak_flops=1e12, device=CPU, seqs=[16, 32])


def test_another_error_at_a_later_point_propagates(monkeypatch):
    fake, seen = _failing_at(1, RuntimeError("CUDA error: an illegal memory access"))
    monkeypatch.setattr(bench, "bench_model", fake)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        bench.longctx_sweep(TINY, steps=2, peak_flops=1e12, device=CPU, seqs=[16, 32, 48])
    assert seen == [16, 32]


@pytest.mark.parametrize("env,flag,runs", [(None, False, True), ("0", False, False),
                                           (None, True, False)])
def test_bench_main_runs_the_sweep_unless_turned_off(monkeypatch, capsys, env, flag, runs):
    seen = []

    def fake(cfg, steps, peak_flops, device, seqs):
        seen.append((cfg.num_layers, steps, device.type, list(seqs)))
        return {"longctx": [], "longctx_seq": None}

    monkeypatch.setattr(bench, "longctx_sweep", fake)
    monkeypatch.setenv("BENCH_LONGCTX_SEQS", "64,96")
    if env is None:
        monkeypatch.delenv("BENCH_LONGCTX", raising=False)
    else:
        monkeypatch.setenv("BENCH_LONGCTX", env)
    argv = ["--model", "llama-tiny", "--batch", "1", "--seq", "16", "--steps", "1",
            "--device", "cpu", "--no-moe"] + (["--no-longctx"] if flag else [])
    assert bench.main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == ([(TINY.num_layers, 1, "cpu", [64, 96])] if runs else [])
    assert ("longctx" in result) == runs


def test_bench_main_sweep_fields_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_LONGCTX_SEQS", "32,48")
    monkeypatch.delenv("BENCH_LONGCTX", raising=False)
    assert bench.main(["--model", "llama-tiny", "--batch", "1", "--seq", "16", "--steps",
                       "1", "--device", "cpu", "--no-moe"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [p["seq"] for p in result["longctx"]] == [32, 48]
    assert result["longctx_seq"] == 32 and np.isfinite(result["longctx_loss"])


def test_llama_past_max_seq_len_matches_jax_with_the_chunked_loss():
    """llama-tiny (max_seq_len 256) at T 512, float32: the chunked loss
    (chunk 128) and every gradient against the flax model's."""
    jcfg = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)
    tcfg = replace(TINY, dtype=torch.float32)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(llama_params_from_flax(params))
    t = 512
    assert t > tcfg.max_seq_len
    ids = np.random.RandomState(9).randint(0, tcfg.vocab_size, (1, t)).astype(np.int32)
    targets = np.roll(ids, -1, axis=1)

    loss_j, grads_j = jax.value_and_grad(
        lambda p: jllama.chunked_causal_lm_loss(jmodel, p, jnp.asarray(ids),
                                                jnp.asarray(targets), chunk_size=128)
    )(params)
    loss_t = tllama.chunked_causal_lm_loss(tmodel, torch.from_numpy(ids).long(),
                                           torch.from_numpy(targets).long(), chunk_size=128)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=F32_TOL)
    want = llama_params_from_flax(grads_j)
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
