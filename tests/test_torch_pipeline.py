"""The port's GPipe pipeline (ray_tpu_torch.parallel.pipeline) against the
reference's `pipelined` and against `sequential_reference`, on the CPU.

Case for case `tests/test_pipeline_parallel.py`: the reference's tanh
stages with weights made by numpy from a seed, the same on both sides.
The port's stages are gloo processes (`parallel.launch.spawn`, one world
of 8 ranks for every case; a pipeline of 4 runs on ranks 0-3), each
holding only its own stage; the reference runs on the root conftest's 8
virtual CPU devices. float32 throughout: outputs and gradients to 1e-5,
the reference's own tolerance.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ray_tpu.parallel import pipeline as jpipe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import pipeline as P
from ray_tpu_torch.parallel.launch import (
    pipe_mesh,
    run_pipeline,
    run_pipeline_llama,
    sequential_llama,
    spawn,
    tanh_stage,
)
from torch_staged_ranks import run_counted

TOL = 1e-5
DEADLINE_S = 180
WORLD = 8

# (stages, microbatches, width, microbatch rows, seed, remat), as the
# reference's tests size them.
FORWARD_CASES = [(4, 8, 16, 4, 0, False), (8, 8, 16, 4, 1, False), (4, 4, 16, 4, 2, False)]
GRAD_CASE = (4, 8, 8, 2, 3, False)
REMAT_CASES = [(4, 4, 8, 2, 4, False), (4, 4, 8, 2, 4, True)]
CASES = FORWARD_CASES + [GRAD_CASE] + REMAT_CASES


def _inputs(n_stages, m, d, mb, seed):
    rng = np.random.RandomState(seed)
    weights = [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
                "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
               for _ in range(n_stages)]
    return weights, rng.standard_normal((m, mb, d)).astype(np.float32)


@pytest.fixture(scope="module")
def pipeline_world():
    cases = []
    for n_stages, m, d, mb, seed, remat in CASES:
        weights, x = _inputs(n_stages, m, d, mb, seed)
        cases.append({"weights": weights, "x": x, "remat": remat})
    return spawn(run_pipeline, WORLD, cases, "cpu", deadline_s=DEADLINE_S)


def _stages(results, index):
    """The ranks' results of case `index`, by stage."""
    got = [r[index] for r in results if r[index] is not None]
    return sorted(got, key=lambda r: r["stage"])


def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _jax_pipelined(weights, x, remat=False):
    """The reference's pipelined output and the gradients of mean(y^2)
    with respect to the stacked stages and x, on its CPU mesh."""
    n_stages = len(weights)
    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("pipe",))
    per_stage = [{k: jnp.asarray(v) for k, v in w.items()} for w in weights]
    apply = jpipe.pipelined(_jax_stage, mesh=mesh, n_microbatches=x.shape[0], remat=remat)
    p_spec, r_spec = jpipe.pipeline_spec(mesh)
    stacked = jax.device_put(jpipe.stack_stage_params(per_stage), p_spec)
    jx = jax.device_put(jnp.asarray(x), r_spec)
    y = jax.jit(apply)(stacked, jx)
    grads, dx = jax.jit(jax.grad(lambda p, x: jnp.mean(apply(p, x) ** 2), argnums=(0, 1)))(
        stacked, jx)
    return np.asarray(y), {k: np.asarray(v) for k, v in grads.items()}, np.asarray(dx)


def _sequential(weights, x):
    """The port's `sequential_reference`: output and gradients."""
    params = [{k: torch.from_numpy(v).requires_grad_() for k, v in w.items()} for w in weights]
    tx = torch.from_numpy(x).requires_grad_()
    y = P.sequential_reference(tanh_stage, params, tx)
    y.pow(2).mean().backward()
    return y.detach(), [{k: v.grad for k, v in p.items()} for p in params], tx.grad


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (8, 8), (4, 4)])
def test_pipelined_matches_sequential(pipeline_world, n_stages, n_micro):
    index = [c[:2] for c in FORWARD_CASES].index((n_stages, n_micro))
    n_stages, m, d, mb, seed, _ = FORWARD_CASES[index]
    weights, x = _inputs(n_stages, m, d, mb, seed)
    stages = _stages(pipeline_world, index)
    assert [r["stage"] for r in stages] == list(range(n_stages))
    want, _, _ = _sequential(weights, x)
    jax_y, _, _ = _jax_pipelined(weights, x)
    np.testing.assert_allclose(jax_y, want.numpy(), atol=TOL)
    for r in stages:  # every rank returns the whole output
        np.testing.assert_allclose(r["y"].numpy(), want.numpy(), atol=TOL)
        np.testing.assert_allclose(r["y"].numpy(), jax_y, atol=TOL)


def test_pipelined_gradients_match_sequential(pipeline_world):
    """The hand-written backward schedule (reverse ticks, reverse shifts)
    gives each rank its stage's gradient of mean(y^2), equal to the
    sequential one and to `jax.grad` through the reference's pipeline;
    not S times it, though every rank takes the loss of the replicated
    output. The input's gradient reaches every rank."""
    index = CASES.index(GRAD_CASE)
    n_stages, m, d, mb, seed, _ = GRAD_CASE
    weights, x = _inputs(n_stages, m, d, mb, seed)
    _, want, want_dx = _sequential(weights, x)
    _, jax_grads, jax_dx = _jax_pipelined(weights, x)
    for r in _stages(pipeline_world, index):
        s = r["stage"]
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k].numpy(), want[s][k].numpy(), atol=TOL)
            np.testing.assert_allclose(r["grads"][k].numpy(), jax_grads[k][s], atol=TOL)
        np.testing.assert_allclose(r["dx"].numpy(), want_dx.numpy(), atol=TOL)
        np.testing.assert_allclose(r["dx"].numpy(), jax_dx, atol=TOL)


def test_pipelined_remat_matches(pipeline_world):
    plain, remat = (_stages(pipeline_world, CASES.index(c)) for c in REMAT_CASES)
    weights, x = _inputs(*REMAT_CASES[1][:5])
    _, jax_remat, _ = _jax_pipelined(weights, x, remat=True)
    for a, b in zip(plain, remat):
        for k in ("w", "b"):
            np.testing.assert_allclose(b["grads"][k].numpy(), a["grads"][k].numpy(), atol=TOL)
            np.testing.assert_allclose(b["grads"][k].numpy(), jax_remat[k][b["stage"]],
                                       atol=TOL)


def test_bubble_ticks_run_no_stage(pipeline_world):
    """Pinned divergence: the reference runs every stage on all M + S - 1
    ticks and masks the bubbles; the port runs a stage only on the M ticks
    that carry one of its microbatches (M more under remat, in backward),
    and still takes part in every tick's shift."""
    for index, (n_stages, m, *_, remat) in enumerate(CASES):
        calls = [r["stage_calls"] for r in _stages(pipeline_world, index)]
        assert calls == [m * (2 if remat else 1)] * n_stages, (CASES[index], calls)


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank=0, n=4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_pipelined_wrong_microbatch_count_raises(fake_world):
    fake_world()
    mesh = pipe_mesh(4, "cpu")
    weights, _ = _inputs(4, 8, 8, 2, 6)
    stacked = P.stack_stage_params([{k: torch.from_numpy(v) for k, v in w.items()}
                                    for w in weights])
    apply = P.pipelined(tanh_stage, mesh=mesh, n_microbatches=8)
    with pytest.raises(ValueError, match="microbatch"):
        apply(P.local_stage(stacked, mesh), torch.zeros(4, 2, 8))


def test_pipelined_rejects_missing_axis(fake_world):
    fake_world()
    mesh = pipe_mesh(4, "cpu")
    with pytest.raises(ValueError, match="no axis"):
        P.pipelined(tanh_stage, mesh=mesh, axis="nope", n_microbatches=4)


@pytest.mark.parametrize("rank", [0, 3])
def test_stage_helpers(fake_world, rank):
    """`stack_stage_params` stacks as the reference's does; `local_stage`
    hands rank s stage s, which is also its shard of the stack placed by
    `pipeline_spec`."""
    fake_world(rank)
    mesh = pipe_mesh(4, "cpu")
    weights, _ = _inputs(4, 4, 8, 2, 7)
    stacked = P.stack_stage_params([{k: torch.from_numpy(v) for k, v in w.items()}
                                    for w in weights])
    jstacked = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in w.items()}
                                         for w in weights])
    params_spec, replicated = P.pipeline_spec(mesh)
    assert (params_spec, replicated) == ([Shard(0)], [Replicate()])
    for k in ("w", "b"):
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(jstacked[k]))
        mine = P.local_stage(stacked, mesh)[k]
        assert torch.equal(mine, torch.from_numpy(weights[rank][k]))
        # Each rank keeps its own chunk of the stack (no scatter on the fake group).
        placed = distribute_tensor(stacked[k], mesh, params_spec, src_data_rank=None)
        assert torch.equal(placed.to_local()[0], mine)


# ------------------------------------------------------------ llama-tiny stages

LLAMA = replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32)
LLAMA_STEPS = 2


@pytest.fixture(scope="module")
def llama_pipeline():
    ids = np.random.RandomState(8).randint(0, LLAMA.vocab_size, (4, 1, 32))
    results = spawn(run_counted, 2, run_pipeline_llama, LLAMA, 1, ids, LLAMA_STEPS, 0.1, "cpu",
                    deadline_s=DEADLINE_S)
    return ids, sorted(results, key=lambda r: r["stage"])


def test_llama_stages_match_the_layers_in_sequence(llama_pipeline):
    """llama-tiny's two decoder layers as 2 stages of 1 (seed-0 weights,
    4 microbatches of 1 x 32, remat "nothing" inside each stage) against
    the same layers run in sequence in one process: the output, each
    stage's gradients of mean(y^2) and the losses of SGD steps."""
    ids, stages = llama_pipeline
    want = sequential_llama(LLAMA, 2, 1, ids, LLAMA_STEPS, 0.1, "cpu")
    for r in stages:
        np.testing.assert_allclose(r["y"].numpy(), want["y"].numpy(), atol=TOL, rtol=TOL)
        grads = want["grads"][r["stage"]]
        assert set(r["grads"]) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(r["grads"][name].numpy(), g.numpy(), atol=TOL, rtol=TOL,
                                       err_msg=name)
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=TOL)
    assert want["losses"][-1] < want["losses"][0]


def test_llama_stage_launches(llama_pipeline):
    """What `chip_smoke.py` phase 15 expects of each rank, counted here
    through the kernels' plain versions: per step, its layers' attention
    on its M microbatches only, K1 in the forward and again in remat
    "nothing"'s recompute inside the backward's VJP, K2 and K3 once."""
    ids, stages = llama_pipeline
    m_count, layers, steps = ids.shape[0], 1, LLAMA_STEPS + 1
    for r in stages:
        assert r["launches"] == {"flash_fwd": 2 * m_count * layers * steps,
                                 "flash_bwd_dkv": m_count * layers * steps,
                                 "flash_bwd_dq": m_count * layers * steps}
