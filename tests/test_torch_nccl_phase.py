"""Phase 30 of chip_smoke.py rehearsed on the CPU: each rank driver that
30a-30e run over NCCL with a card per rank, here on gloo ranks at tiny
size, through the smoke's own checks, and held against the reference's
own sharded or sequential step. Weights come from the reference's
seed-0 init through `convert.py`, inputs from a seeded numpy draw; the
reference runs on the root conftest's 8 virtual CPU devices (its Pallas
kernels in interpret mode), float32 on both sides. The launches the
smoke counts on the card are counted here through the kernels' plain
versions (`run_counted`).

The train steps take AdamW with the reference's hyperparameters on both
sides. optax keeps the first moment in bf16 (`mu_dtype`), torch in
float32: over three steps the losses agree to 2e-4 relative, as
`tests/test_torch_train_step.py` finds for the one-device step.

Beside them: `spawn(..., backend="nccl")` raises before it starts a
process where the host has fewer cards than ranks, phase 30 on fewer
than four cards prints one line and starts nothing, and the smoke pins
its own process to one card and lets phase 30's processes see them all.
"""
import functools
import os
import signal
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from ray_tpu.models import llama as jllama
from ray_tpu.models import mixtral as jmix
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel import shard_params as jax_shard_params
from ray_tpu_torch.convert import llama_params_from_flax, mixtral_params_from_flax
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.parallel.launch import (
    accumulated_llama,
    run_llama_train,
    run_mixtral_trains,
    run_pipeline_llama,
    run_sharded_train,
    spawn,
)
from ray_tpu_torch.parallel.mesh import MeshSpec
from torch_staged_ranks import run_counted

DEADLINE_S = 240
WORLD_DEADLINE_S = 180
STEPS = 2  # timed, after one more
# AdamW on both sides, optax's first moment in bf16 (the module docstring).
LOSS_RTOL = 2e-4
# The port's data-parallel step against its own accumulation in one
# process: float32, the same sums in another order.
SELF_TOL = 1e-5
# The pipeline's output and gradients against the reference's pipeline:
# float32, one SGD step, summation order only.
PIPE_TOL = 1e-4
PIPE_LR = 0.1

CFG = replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32)
JCFG = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _flax_llama(jcfg):
    return jllama.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def _adamw():
    return optax.adamw(3e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)


def _reference_losses(loss_of, params, steps, mesh=None):
    """The reference's AdamW steps of `loss_of(params)`, jitted, under
    `jax.set_mesh(mesh)` with its own `shard_params` where a mesh is
    given: every loss, the first step's included."""
    tx = _adamw()

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(loss_of)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        if mesh is None:
            p, o = params, tx.init(params)
            for _ in range(steps):
                p, o, loss = step(p, o)
                losses.append(float(loss))
            return losses
        with jax.set_mesh(mesh):
            p = jax_shard_params(params, mesh)
            o = tx.init(p)
            for _ in range(steps):
                p, o, loss = step(p, o)
                losses.append(float(loss))
    return losses


# ------------------------------------------------------------ no card, no world


class _NoProcesses:
    def get_context(self, method):
        raise AssertionError("spawn started processes")


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_spawn_over_nccl_raises_before_starting_a_process(monkeypatch, cards):
    """A world of 4 NCCL ranks on a host of `cards` cards: `spawn` raises
    at once, with the counts, and starts nothing; rank r would otherwise
    run on card r % cards, a card shared, which NCCL refuses later with a
    worse message."""
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", str(cards))  # the count spawn reads
    monkeypatch.setattr(launch, "multiprocessing", _NoProcesses())
    assert launch.visible_cards() == cards
    with pytest.raises(ValueError, match=f"4 ranks need 4 cards, and a process started here "
                                         f"sees {cards}"):
        spawn(run_llama_train, 4, MeshSpec(seq=4), CFG, np.zeros((1, 8)), 1,
              backend="nccl")


def test_spawn_over_gloo_takes_no_card(monkeypatch):
    """gloo ranks need no card: the check is NCCL's alone."""
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "0")
    assert spawn(_rank_and_backend, 2, deadline_s=WORLD_DEADLINE_S) == [(0, "gloo"), (1, "gloo")]


def _rank_and_backend(rank, world_size):
    import torch.distributed as dist

    return rank, dist.get_backend()


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_phase_30_on_fewer_than_four_cards_prints_its_line_and_launches_nothing(
        capsys, monkeypatch, cards):
    import chip_smoke as S

    def refuse(*args, **kwargs):
        raise AssertionError("phase 30 started something")

    monkeypatch.setattr(launch, "spawn", refuse)
    for name in ("phase_nccl_ring", "phase_nccl_pipeline", "phase_meshes", "phase_nccl_trainer",
                 "phase_nccl_sharded", "all_cards"):
        monkeypatch.setattr(S, name, refuse)
    assert S.phase_nccl(None, "the CPU (rehearsal)", cards, None, {}, {}, {}) is None
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 1, printed
    assert printed[0].startswith("phase 30: ") and f"this host has {cards}," in printed[0]


def test_the_kernels_line_takes_phase_30s_launches_per_rank():
    """The smoke's last-but-one line gives each kernel's launches per rank
    by sub-phase, 30c's by mesh, in the shape `phase_nccl` returns
    (`_per_rank` of each world's results), and None on fewer cards."""
    import chip_smoke as S

    def ranks(*counts):
        return S._per_rank([{"launches": {"flash_fwd": n, "gmm": 2 * n}} for n in counts])

    nccl = {"30a": ranks(1, 2, 3, 4), "30b": ranks(5, 5, 5, 5),
            "30c": {"expert gmm": ranks(6, 6, 6, 6), "tensor capacity": ranks(7, 7, 7, 7)},
            "30d": ranks(8, 8, 8, 8), "30e": ranks(9, 9, 9, 9)}
    assert S.nccl_launches(nccl, "flash_fwd") == {
        "30a": [1, 2, 3, 4], "30b": [5] * 4,
        "30c": {"expert gmm": [6] * 4, "tensor capacity": [7] * 4},
        "30d": [8] * 4, "30e": [9] * 4}
    assert S.nccl_launches(nccl, "gmm")["30c"]["expert gmm"] == [12] * 4
    assert S.nccl_launches(nccl, "tgmm")["30e"] == [0] * 4
    assert S.nccl_launches(None, "flash_fwd") is None


@pytest.mark.parametrize("cards,before,pinned", [
    (0, None, None), (1, None, None), (1, "3", "3"), (4, None, "0"), (4, "2,3,5,7", "2")])
def test_the_smoke_pins_itself_to_one_card_and_phase_30_sees_them_all(
        monkeypatch, cards, before, pinned):
    """Phases 1-29 see one card on a host of several (this process and
    what it starts before phase 30); inside phase 30's block, a process
    started here sees every card the host gave the run, and afterwards
    the pin holds again."""
    import chip_smoke as S

    monkeypatch.setattr(launch, "visible_cards", lambda: cards)
    if before is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", before)
    assert S.pin_to_one_card() == (cards, before)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == pinned
    with S.all_cards(before):
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == pinned


# ------------------------------------------------------------ 30a: the ring


def test_30a_ring_train_steps_match_the_reference_ring():
    """30a's driver (`run_llama_train` over seq 4, chunked loss) at
    llama-tiny on 4 gloo ranks, through the smoke's own check
    (`check_seq_parallel`: losses, equal parameters, the ring's launches)
    against the reference's ring on its seq 4 mesh taking the same AdamW
    steps; each rank times its waits for the shifts."""
    import chip_smoke as S

    params = _flax_llama(JCFG)
    ids = np.random.RandomState(30).randint(0, CFG.vocab_size, (1, 64))
    chunk = 16
    res = spawn(run_counted, 4, run_llama_train, MeshSpec(seq=4), CFG, ids, STEPS,
                functools.partial(tllama.chunked_causal_lm_loss, chunk_size=chunk), "cpu",
                llama_params_from_flax(params), deadline_s=WORLD_DEADLINE_S)
    mesh = JaxMeshSpec(seq=4).build()
    model = jllama.LlamaForCausalLM(JCFG, mesh=mesh)
    jids = jnp.asarray(ids, jnp.int32)
    want = _reference_losses(
        lambda p: jllama.chunked_causal_lm_loss(model, p, jids, jnp.roll(jids, -1, axis=1),
                                                chunk_size=chunk),
        params, STEPS + 1, mesh)
    res = sorted(res, key=lambda r: r["seq_rank"])
    S.check_seq_parallel("30a rehearsal", res, want, CFG.num_layers, 4, STEPS + 1)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
        # Every rank waits on each forward shift (3 a layer pass, twice
        # under remat "nothing") and each backward one.
        assert r["spans"]["shift_wait"]["count"] > 0 and r["spans"]["shift_wait"]["ms"] >= 0


# ------------------------------------------------------------ 30b: the pipeline


def _layer_from_flax(layer_params):
    """One flax decoder layer's tree under the port's names within a
    layer ("attn.q_proj.weight", ...)."""
    tree = {"embed_tokens": {"embedding": np.zeros((1, 1), np.float32)},
            "final_norm": {"scale": np.zeros(1, np.float32)}, "layers_0": layer_params}
    pre = "layers.0."
    return {k[len(pre):]: v for k, v in llama_params_from_flax(tree).items()
            if k.startswith(pre)}


def test_30b_pipeline_matches_the_reference_pipeline():
    """30b's driver (`run_pipeline_llama`) at llama-tiny widths as 4
    stages of one layer on 4 gloo ranks, 8 microbatches of 1 x 32, SGD on
    mean(y^2), against the reference's `pipelined` over its 4-device pipe
    mesh with the same decoder layers as stages: y and each stage's
    gradients of the first step, every loss; then the smoke's own check
    (`check_pipeline`) against the same, and the spans from which the
    smoke reads each stage's idle share."""
    import chip_smoke as S

    stages, m_count = 4, 8
    jcfg = replace(JCFG, num_layers=stages)
    params = _flax_llama(jcfg)
    ids = np.random.RandomState(31).randint(0, CFG.vocab_size, (m_count, 1, 32))
    res = sorted(spawn(run_counted, stages, run_pipeline_llama, CFG, 1, ids, STEPS, PIPE_LR,
                       "cpu", llama_params_from_flax(params), deadline_s=WORLD_DEADLINE_S),
                 key=lambda r: r["stage"])

    p = params["params"]
    x = jnp.take(p["embed_tokens"]["embedding"], jnp.asarray(ids, jnp.int32), axis=0)
    positions = jnp.broadcast_to(jnp.arange(ids.shape[-1])[None], ids.shape[1:])

    def stage(layer, h):
        return jllama.DecoderLayer(jcfg).apply({"params": layer}, h, positions)

    mesh = Mesh(np.array(jax.devices()[:stages]), ("pipe",))
    apply = jpipe.pipelined(stage, mesh=mesh, n_microbatches=m_count)
    p_spec, r_spec = jpipe.pipeline_spec(mesh)
    stacked = jax.device_put(jpipe.stack_stage_params([p[f"layers_{s}"] for s in range(stages)]),
                             p_spec)
    jx = jax.device_put(x, r_spec)
    loss_and_grads = jax.jit(jax.value_and_grad(lambda q: jnp.mean(apply(q, jx) ** 2)))
    y = np.array(jax.jit(apply)(stacked, jx))
    losses = []
    for step in range(STEPS + 1):
        loss, grads = loss_and_grads(stacked)
        if step == 0:
            first = jax.tree_util.tree_map(np.asarray, grads)
        losses.append(float(loss))
        stacked = jax.tree_util.tree_map(lambda a, g: a - PIPE_LR * g, stacked, grads)
    want = {"y": torch.from_numpy(y), "losses": losses,
            "grads": [_layer_from_flax(jax.tree_util.tree_map(lambda g: g[s], first))
                      for s in range(stages)]}
    for r in res:
        np.testing.assert_allclose(r["y"].numpy(), y, atol=PIPE_TOL, rtol=PIPE_TOL)
        # The stage is a ModuleList of one layer: "0.attn.q_proj.weight".
        grads = {k.split(".", 1)[1]: v for k, v in r["grads"].items()}
        assert set(grads) == set(want["grads"][r["stage"]])
        for name, g in want["grads"][r["stage"]].items():
            np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=PIPE_TOL,
                                       rtol=PIPE_TOL, err_msg=f"stage {r['stage']} {name}")
        np.testing.assert_allclose(r["losses"], losses, rtol=PIPE_TOL)
        r["grads"] = grads
    S.check_pipeline("30b rehearsal", res, want, 1, m_count, STEPS + 1)
    for r in res:
        spans = r["spans"]
        # Forward and backward: M ticks of the stage's own each, inside
        # the two schedules.
        assert spans["stage"]["count"] == 2 * m_count and spans["pipeline"]["count"] == 2
        assert 0.0 < spans["stage"]["ms"] < spans["pipeline"]["ms"]


# ------------------------------------------------------------ 30c: Mixtral's meshes


def test_30c_mixtral_meshes_match_the_reference_sharded_steps():
    """30c's driver (`run_mixtral_trains`) over the smoke's MESH_CASES at
    mixtral-tiny in float32 on 4 gloo ranks, against the reference's own
    sharded step on each mesh (its `shard_params`, the model built on the
    mesh, "gmm" in interpret mode) taking the same AdamW steps; the
    launches the smoke expects (`mesh_launches`), K4 and K5 on every rank
    of the "gmm" case, and the expert all-reduces timed."""
    import chip_smoke as S

    jcfg = replace(jmix.CONFIGS["mixtral-tiny"], dtype=jnp.float32)
    tcfg = replace(tmix.CONFIGS["mixtral-tiny"], dtype=torch.float32)
    params = jmix.MixtralForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 8), jnp.int32))
    ids = np.random.RandomState(32).randint(0, tcfg.vocab_size, (2, 32))
    cases = [(MeshSpec(**axes), replace(tcfg, moe_dispatch=d)) for _, axes, d, _ in S.MESH_CASES]
    res = spawn(run_counted, 4, run_mixtral_trains, cases, ids, STEPS, "cpu",
                mixtral_params_from_flax(params), deadline_s=WORLD_DEADLINE_S)
    jids = jnp.asarray(ids, jnp.int32)
    targets = jnp.roll(jids, -1, axis=1)
    for i, (label, axes, dispatch, _) in enumerate(S.MESH_CASES):
        rs = [r[i] for r in res]
        mesh = JaxMeshSpec(**axes).build()
        model = jmix.MixtralForCausalLM(replace(jcfg, moe_dispatch=dispatch), mesh=mesh)
        want = _reference_losses(lambda p: jmix.moe_lm_loss(model, p, jids, targets), params,
                                 STEPS + 1, mesh)
        for r in rs:
            np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL, err_msg=label)
        launches = {name: sum(r["launches"].get(name, 0) + r["gmm_launches"].get(name, 0)
                              for r in rs) for name in S.SOURCES}
        assert launches == S.mesh_launches(axes, tcfg.num_layers, dispatch, STEPS + 1), label
        if dispatch == "gmm":
            assert all(r["gmm_launches"]["gmm"] > 0 and r["gmm_launches"]["tgmm"] > 0
                       for r in rs)
        if "expert" in axes or "tensor" in axes:
            assert all(r["spans"]["moe_all_reduce"]["count"] > 0 for r in rs), label


# ------------------------------------------------------------ 30d: TorchTrainer


@pytest.fixture(scope="module")
def runtime():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rt.shutdown()


def test_30d_trainer_workers_match_the_reference_data_parallel_step(runtime, tmp_path):
    """30d's loop (`data_parallel_loop`) in a TorchTrainer of 2 CPU
    workers joined into one gloo group by the trainer's rendezvous, each
    taking 2 rows of a global batch of 4, against the reference's
    data-parallel sharded step on its data 2 mesh over the whole batch,
    and against the port's one-process accumulation over the same batch
    (`accumulated_llama`, which 30d holds the card's workers to)."""
    from ray_tpu_torch import train

    params = _flax_llama(JCFG)
    weights = llama_params_from_flax(params)
    ids = np.random.RandomState(33).randint(0, CFG.vocab_size, (4, 64))
    result = train.TorchTrainer(
        launch.data_parallel_loop,
        train_loop_config={"cfg": CFG, "ids": ids, "steps": STEPS, "device": "cpu",
                           "weights": weights},
        scaling_config=train.ScalingConfig(num_workers=2, use_torch_distributed=True),
        run_config=train.RunConfig(storage_path=str(tmp_path / "results")),
    ).fit()
    assert result.error is None, result.error
    ranks = sorted(result.metrics["ranks"], key=lambda r: r["rank"])
    assert [(r["rank"], r["backend"]) for r in ranks] == [(0, "gloo"), (1, "gloo")]
    assert ranks[0]["param_digest"] == ranks[1]["param_digest"]
    assert ranks[0]["losses"] == ranks[1]["losses"]

    mesh = JaxMeshSpec(data=2).build()
    model = jllama.LlamaForCausalLM(JCFG, mesh=mesh)
    jids = jnp.asarray(ids, jnp.int32)
    want = _reference_losses(
        lambda p: jllama.causal_lm_loss(model.apply(p, jids), jnp.roll(jids, -1, axis=1)),
        params, STEPS + 1, mesh)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=LOSS_RTOL)
    one = accumulated_llama(CFG, ids, 2, STEPS, weights, "cpu")
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=SELF_TOL)
    np.testing.assert_allclose(one["losses"], want, rtol=LOSS_RTOL)


# ------------------------------------------------------------ 30e: shard_params


def test_30e_sharded_train_steps_match_the_reference_sharded_step():
    """30e's driver (`run_sharded_train`: the tensor plan, then FSDP2) on
    fsdp 2 x tensor 2, 4 gloo ranks, against the reference's own sharded
    step on the same mesh (its `shard_params`, jitted under
    `jax.set_mesh`) taking the same AdamW steps; every rank reports the
    global loss, and K1-K3 run as the smoke counts them per rank."""
    params = _flax_llama(JCFG)
    ids = np.random.RandomState(34).randint(0, CFG.vocab_size, (2, 32))
    spec = MeshSpec(fsdp=2, tensor=2)
    res = spawn(run_counted, 4, run_sharded_train, spec, CFG, ids, STEPS,
                llama_params_from_flax(params), "cpu", deadline_s=WORLD_DEADLINE_S)
    mesh = JaxMeshSpec(fsdp=2, tensor=2).build()
    model = jllama.LlamaForCausalLM(JCFG, mesh=mesh)
    jids = jnp.asarray(ids, jnp.int32)
    want = _reference_losses(
        lambda p: jllama.causal_lm_loss(model.apply(p, jids), jnp.roll(jids, -1, axis=1)),
        params, STEPS + 1, mesh)
    layers, steps = CFG.num_layers, STEPS + 1
    assert sorted((r["fsdp_rank"], r["tensor_rank"]) for r in res) == [(0, 0), (0, 1), (1, 0),
                                                                       (1, 1)]
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
        assert r["losses"] == res[0]["losses"]
        assert r["launches"] == {"flash_fwd": 2 * layers * steps,
                                 "flash_bwd_dkv": layers * steps, "flash_bwd_dq": layers * steps}
