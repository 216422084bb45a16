"""The port's Mixtral on a mesh (`MixtralForCausalLM(cfg, mesh)`) against
its single-device model and the flax model, on the CPU.

mixtral-tiny (4 experts, top-2) in float32 on 4 gloo ranks
(`parallel.launch.spawn`): first MeshSpec(data=2, expert=2), rows split
over data, experts over expert, "auto" resolved to "capacity" by the
mesh; then `MESH_CASES`, every other mesh the reference lays out under
GSPMD: a tensor axis, "capacity" and "auto" over a split sequence, an
explicit "gmm" or "ragged" on an expert mesh, and their mixes. The flax
parameters go through `mixtral_params_from_flax`, and each rank keeps its
part of them (`shard_state`). Routing is discrete, so the port's
single-device routing is first held equal to the flax model's. The
model on a mesh against the port's own single-device one: the same
float32 arithmetic split over ranks, 1e-5; against flax, summation order
too, 1e-4 (as `test_torch_mixtral.py`).
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from ray_tpu.models import mixtral as jmix
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import shard_params as jax_shard_params
from ray_tpu_torch import train
from ray_tpu_torch.convert import mixtral_params_from_flax
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.models.mixtral import take_parts
from ray_tpu_torch.parallel.launch import (
    param_digest,
    run_mixtral_grads,
    run_mixtral_meshes,
    run_mixtral_train,
    spawn,
)
from ray_tpu_torch.parallel.mesh import MeshSpec
from torch_staged_ranks import run_counted

F32_TOL = 1e-4
SELF_TOL = 1e-5
DEADLINE_S = 180
SPEC = MeshSpec(data=2, expert=2)
TCFG = replace(tmix.CONFIGS["mixtral-tiny"], dtype=torch.float32, remat=False,
               moe_dispatch="capacity")
JCFG = replace(jmix.CONFIGS["mixtral-tiny"], dtype=jnp.float32, remat=False,
               moe_dispatch="capacity")
IDS = np.random.RandomState(0).randint(0, TCFG.vocab_size, (4, 32))
TARGETS = np.roll(IDS, -1, axis=1)


@pytest.fixture(scope="module")
def flax_params():
    return jmix.MixtralForCausalLM(JCFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


@pytest.fixture(scope="module")
def expert_parallel(flax_params):
    return spawn(run_mixtral_grads, SPEC.num_devices, SPEC, TCFG,
                 mixtral_params_from_flax(flax_params), IDS, "cpu", deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def single(flax_params):
    """The port's single-device capacity path: logits, loss and gradients,
    with each layer's chosen experts."""
    model = tmix.MixtralForCausalLM(TCFG, device="cpu")
    model.load_state_dict(mixtral_params_from_flax(flax_params))
    routes = []
    hooks = [layer.moe.router.register_forward_hook(
        lambda mod, args, out: routes.append(torch.topk(out.detach(), 2).indices.numpy()))
        for layer in model.layers]
    with torch.no_grad():
        logits = model(torch.from_numpy(IDS).long())
    for h in hooks:
        h.remove()
    loss = tmix.moe_lm_loss(model, torch.from_numpy(IDS).long(), torch.from_numpy(TARGETS).long())
    loss.backward()
    return {"logits": logits, "loss": loss.item(), "routes": routes,
            "grads": {n: p.grad for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def flax_reference(flax_params):
    model = jmix.MixtralForCausalLM(JCFG)
    logits, state = model.apply(flax_params, jnp.asarray(IDS), capture_intermediates=True)
    inter = state["intermediates"]
    routes = [np.asarray(jax.lax.top_k(inter[f"layers_{i}"]["moe"]["router"]["__call__"][0], 2)[1])
              for i in range(JCFG.num_layers)]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmix.moe_lm_loss(model, p, jnp.asarray(IDS), jnp.asarray(TARGETS))
    ))(flax_params)
    return {"logits": np.asarray(logits), "loss": float(loss), "routes": routes,
            "grads": mixtral_params_from_flax(grads)}


def _rows(r):
    return slice(r["data_rank"] * 2, r["data_rank"] * 2 + 2)


def _gathered(results, name):
    """A gradient of the whole model: expert tensors concatenated in expert
    order from one data replica's ranks."""
    parts = sorted((r for r in results if r["data_rank"] == 0), key=lambda r: r["expert_rank"])
    if tmix.is_expert_param(name):
        return torch.cat([r["grads"][name] for r in parts])
    return parts[0]["grads"][name]


def test_single_device_routing_matches_flax(single, flax_reference):
    for i, (got, want) in enumerate(zip(single["routes"], flax_reference["routes"])):
        assert np.array_equal(got, want), f"layer {i}: a near-tie in the router flipped"


def test_logits_loss_and_grads_match_single_device(expert_parallel, single):
    """Each rank's logits are its data replica's rows of the single-device
    model's; the loss and every gradient are the single-device ones, the
    replicated ones whole on every rank, each rank's experts its slice."""
    for r in expert_parallel:
        np.testing.assert_allclose(r["logits"].numpy(), single["logits"][_rows(r)].numpy(),
                                   atol=SELF_TOL, rtol=SELF_TOL)
        np.testing.assert_allclose(r["loss"], single["loss"], rtol=SELF_TOL)
        assert set(r["grads"]) == set(single["grads"])
        experts = slice(r["expert_rank"] * 2, r["expert_rank"] * 2 + 2)
        for name, g in single["grads"].items():
            want = g[experts] if tmix.is_expert_param(name) else g
            np.testing.assert_allclose(r["grads"][name].numpy(), want.numpy(),
                                       atol=SELF_TOL, rtol=SELF_TOL, err_msg=name)


def test_logits_loss_and_grads_match_flax(expert_parallel, flax_reference):
    for r in expert_parallel:
        np.testing.assert_allclose(r["logits"].numpy(), flax_reference["logits"][_rows(r)],
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(r["loss"], flax_reference["loss"], rtol=F32_TOL)
    for name, g in flax_reference["grads"].items():
        np.testing.assert_allclose(_gathered(expert_parallel, name).numpy(), g.numpy(),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)


@pytest.fixture
def expert_mesh(monkeypatch):
    """`mesh(rank)`: MeshSpec(data=2, expert=2) on a fake group of 4, this
    process as `rank`; dispatch resolutions of both packages reset."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    monkeypatch.setattr(tmix, "_RESOLVED", {})
    monkeypatch.setattr(jmix, "_RESOLVED", {})
    monkeypatch.delenv("RAY_TPU_MOE_DISPATCH", raising=False)

    def mesh(rank=0, spec=SPEC):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        return spec.build("cpu")

    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def test_expert_mesh_forces_capacity(expert_mesh):
    """Both packages resolve "auto" to "capacity" on an expert mesh
    without a probe and cache it for the shape."""
    mesh = expert_mesh()
    cfg = replace(TCFG, moe_dispatch="auto")
    jcfg = replace(JCFG, moe_dispatch="auto")
    assert tmix.resolve_moe_dispatch(cfg, device="cpu", mesh=mesh) == "capacity"
    assert jmix.resolve_moe_dispatch(jcfg, mesh=JaxMeshSpec(data=2, expert=2).build()) == \
        "capacity"
    assert tmix._RESOLVED == {tmix._shape_key(cfg): "capacity"}
    assert jmix._RESOLVED == {jmix._shape_key(jcfg): "capacity"}
    assert tmix.MoELayer(cfg, mesh=mesh, device="cpu").dispatch() == "capacity"


@pytest.mark.parametrize("dispatch", ["gmm", "ragged"])
def test_explicit_dispatch_on_an_expert_mesh_is_kept(expert_mesh, dispatch):
    """Both packages keep an explicit "gmm" or "ragged" on an expert mesh;
    the port's layer then runs it over its own experts
    (`test_mixtral_mesh_matches_single_device` holds the numbers)."""
    mesh = expert_mesh()
    jmesh = JaxMeshSpec(data=2, expert=2).build()
    assert jmix.resolve_moe_dispatch(replace(JCFG, moe_dispatch=dispatch), mesh=jmesh) == dispatch
    cfg = replace(TCFG, moe_dispatch=dispatch)
    assert tmix.resolve_moe_dispatch(cfg, device="cpu", mesh=mesh) == dispatch
    model = tmix.MixtralForCausalLM(cfg, mesh, device="cpu")
    assert all(layer.moe.dispatch() == dispatch for layer in model.layers)
    assert model.layers[0].moe.w_up.shape[0] == 2


def test_mixtral_on_a_seq_mesh_runs_the_ring(expert_mesh):
    """Over seq, attention runs the ring, with every dispatch."""
    mesh = expert_mesh(spec=MeshSpec(seq=4))
    model = tmix.MixtralForCausalLM(replace(TCFG, moe_dispatch="gmm"), mesh, device="cpu")
    assert model.layers[0].attn.ring_mesh is mesh


@pytest.mark.parametrize("rank", range(4))
def test_tensor_ranks_keep_their_heads_and_their_part_of_each_expert(expert_mesh, rank):
    """On MeshSpec(data=2, tensor=2) each rank draws every weight whole
    from seed 0 and keeps its part: its half of F in every expert, as the
    reference shards them (P("expert", "fsdp", "tensor"), P("expert",
    "tensor", "fsdp")), and, through Llama's tensor plan, the attention's
    DTensors with the q, k and v rows of its heads and the o columns; the
    rest whole."""
    from torch.distributed.tensor import DTensor

    mesh = expert_mesh(rank, MeshSpec(data=2, tensor=2))
    model = tmix.MixtralForCausalLM(TCFG, mesh, device="cpu")
    want = tmix.MixtralForCausalLM(TCFG, device="cpu").state_dict()
    r = mesh["tensor"].get_local_rank()
    assert r == rank % 2
    cuts = {"w_gate": (2, 64), "w_up": (2, 64), "w_down": (1, 64),
            "q_proj.weight": (0, 32), "k_proj.weight": (0, 16), "v_proj.weight": (0, 16),
            "o_proj.weight": (1, 32)}
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in got.items():
        cut = next((c for key, c in cuts.items() if name.endswith(key)), None)
        full = want[name]
        assert isinstance(w, DTensor) == ("attn." in name), name
        if isinstance(w, DTensor):
            assert w.device_mesh.mesh_dim_names == ("tensor",), name
            w = w.to_local()
        assert torch.equal(w, full if cut is None else full.narrow(cut[0], r * cut[1], cut[1])), name
    assert torch.equal(tmix.shard_state(want, model)["layers.1.attn.o_proj.weight"].to_local(),
                       model.layers[1].attn.o_proj.weight.detach().to_local())


@pytest.mark.parametrize("rank", range(4))
def test_each_rank_keeps_its_experts_of_the_single_device_weights(expert_mesh, rank):
    """Every rank draws all experts from seed 0 and keeps experts [2e,
    2e + 2): its weights are the single-device model's."""
    mesh = expert_mesh(rank)
    model = tmix.MixtralForCausalLM(TCFG, mesh, device="cpu")
    want = tmix.MixtralForCausalLM(TCFG, device="cpu").state_dict()
    e = mesh["expert"].get_local_rank()
    assert e == rank % 2
    for name, w in model.state_dict().items():
        full = want[name]
        assert torch.equal(w, full[2 * e:2 * e + 2] if tmix.is_expert_param(name) else full), name
    assert torch.equal(tmix.shard_state(want, model)["layers.0.moe.w_up"],
                       model.layers[0].moe.w_up.detach())


def test_capacity_drops_unchanged_by_the_data_split():
    """Capacity positions are a cumsum over each row's tokens, so the rows
    of a data replica keep every slot, and every drop, that they had in
    the whole batch (at capacity factor 0.5, where pairs drop)."""
    cfg = replace(TCFG, capacity_factor=0.5)
    rng = np.random.RandomState(5)
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((4, 32, 4))).float(), -1)
    gate_idx = torch.topk(probs, 2, dim=-1).indices
    mask = torch.zeros_like(probs).scatter_(-1, gate_idx, 1.0)
    slot, c = tmix.capacity_slots(gate_idx, mask, cfg)
    assert int((slot >= cfg.num_experts * c).sum()) > 0  # pairs dropped
    halves = [tmix.capacity_slots(gate_idx[rows], mask[rows], cfg)[0]
              for rows in (slice(0, 2), slice(2, 4))]
    assert torch.equal(torch.cat(halves), slot)


def test_capacity_drops_unchanged_by_the_seq_split(monkeypatch):
    """Over a sequence split in 4, each shard's positions start after the
    arrivals of the shards before it (the all-reduce here hands each shard
    every shard's counts, as the seq group's does) and C is the whole
    sequence's: every kept pair keeps its slot, and every dropped pair
    drops, as on one device (at capacity factor 0.5, where pairs drop)."""
    cfg = replace(TCFG, capacity_factor=0.5)
    rng = np.random.RandomState(6)
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((2, 32, 4))).float(), -1)
    gate_idx = torch.topk(probs, 2, dim=-1).indices
    mask = torch.zeros_like(probs).scatter_(-1, gate_idx, 1.0)
    whole, c = tmix.capacity_slots(gate_idx, mask, cfg)
    dump = cfg.num_experts * c
    assert int((whole >= dump).sum()) > 0
    shards = [slice(8 * r, 8 * r + 8) for r in range(4)]

    def all_reduce(counts, group):
        counts.copy_(torch.stack([mask[:, cols].sum(1) for cols in shards]))
        return counts

    monkeypatch.setattr(tmix, "all_reduce_sum_", all_reduce)
    for r, cols in enumerate(shards):
        slot, c_shard = tmix.capacity_slots(gate_idx[:, cols], mask[:, cols], cfg, (None, r, 4))
        assert c_shard == c
        want = whole[:, 16 * r:16 * r + 16]
        assert torch.equal(torch.where(slot < dump, slot, -1), torch.where(want < dump, want, -1))


# ------------------------------------------------ the other meshes

# (spec, moe_dispatch) of each mesh the reference lays out under GSPMD:
# the first five each lifted a `ValueError` of the port.
MESH_CASES = {
    "data2-tensor2-capacity": (MeshSpec(data=2, tensor=2), "capacity"),
    "seq2-expert2-auto": (MeshSpec(seq=2, expert=2), "auto"),
    "seq4-capacity": (MeshSpec(seq=4), "capacity"),
    "data2-expert2-gmm": (MeshSpec(data=2, expert=2), "gmm"),
    "data2-expert2-ragged": (MeshSpec(data=2, expert=2), "ragged"),
    "tensor2-expert2-gmm": (MeshSpec(tensor=2, expert=2), "gmm"),
    "seq2-tensor2-capacity": (MeshSpec(seq=2, tensor=2), "capacity"),
}


def _resolved(spec, dispatch):
    """What "auto" is on the mesh: "capacity" on an expert mesh, and the
    probe's choice elsewhere (no case asks for that)."""
    assert dispatch != "auto" or spec.expert > 1
    return "capacity" if dispatch == "auto" else dispatch


@pytest.fixture(scope="module")
def meshes(flax_params):
    """Every case of `MESH_CASES` in one world of 4 ranks, by case."""
    cases = [(spec, replace(TCFG, moe_dispatch=d)) for spec, d in MESH_CASES.values()]
    results = spawn(run_mixtral_meshes, 4, cases, mixtral_params_from_flax(flax_params), IDS,
                    "cpu", deadline_s=DEADLINE_S)
    return {name: [r[i] for r in results] for i, name in enumerate(MESH_CASES)}


@pytest.fixture(scope="module")
def single_dispatch(flax_params):
    """The port's single-device logits, loss and gradients per dispatch."""
    out = {}

    def get(dispatch):
        if dispatch not in out:
            model = tmix.MixtralForCausalLM(replace(TCFG, moe_dispatch=dispatch), device="cpu")
            model.load_state_dict(mixtral_params_from_flax(flax_params))
            tids = torch.from_numpy(IDS).long()
            with torch.no_grad():
                logits = model(tids)
            loss = tmix.moe_lm_loss(model, tids, torch.from_numpy(TARGETS).long())
            loss.backward()
            out[dispatch] = {"logits": logits, "loss": loss.item(),
                             "grads": {n: p.grad for n, p in model.named_parameters()}}
        return out[dispatch]

    return get


@pytest.fixture(scope="module")
def reference_sharded(flax_params):
    """The reference's own sharded step on the 8-device CPU mesh: its
    `shard_params` and the model built on the mesh, jitted under
    `jax.set_mesh` (the Pallas gmm in interpret mode); loss and gradients
    by case."""
    out = {}

    def get(name):
        if name not in out:
            spec, dispatch = MESH_CASES[name]
            jcfg = replace(JCFG, moe_dispatch=_resolved(spec, dispatch))
            jmesh = JaxMeshSpec(**spec.axis_sizes()).build()
            model = jmix.MixtralForCausalLM(jcfg, mesh=jmesh)
            ids, targets = jnp.asarray(IDS), jnp.asarray(TARGETS)
            with pytest.MonkeyPatch.context() as mp, jax.set_mesh(jmesh):
                mp.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p: jmix.moe_lm_loss(model, p, ids, targets)
                ))(jax_shard_params(flax_params, jmesh))
            out[name] = {"loss": float(loss), "grads": mixtral_params_from_flax(grads)}
        return out[name]

    return get


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mixtral_mesh_matches_single_device(meshes, single_dispatch, case):
    """Each rank's logits are its block of the single-device model's with
    the same dispatch ("capacity" for "auto" on an expert mesh); the loss
    and every gradient are the single-device ones, the replicated ones
    whole on every rank, each split one this rank's part (`parts`)."""
    spec, dispatch = MESH_CASES[case]
    single = single_dispatch(_resolved(spec, dispatch))
    for r in meshes[case]:
        rows, cols = (slice(*b) for b in r["block"])
        np.testing.assert_allclose(r["logits"].numpy(), single["logits"][rows, cols].numpy(),
                                   atol=SELF_TOL, rtol=SELF_TOL)
        np.testing.assert_allclose(r["loss"], single["loss"], rtol=SELF_TOL)
        assert set(r["grads"]) == set(single["grads"])
        for name, g in single["grads"].items():
            want = take_parts(g, r["parts"].get(name, []))
            np.testing.assert_allclose(r["grads"][name].numpy(), want.numpy(),
                                       atol=SELF_TOL, rtol=SELF_TOL, err_msg=name)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mixtral_mesh_matches_the_reference_sharded_step(meshes, reference_sharded, case):
    """The loss and every gradient on each rank against the reference's
    sharded step on the same mesh (`reference_sharded`), each split
    gradient against its part of the reference's."""
    want = reference_sharded(case)
    for r in meshes[case]:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=F32_TOL)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(r["grads"][name].numpy(),
                                       take_parts(g, r["parts"].get(name, [])).numpy(),
                                       atol=F32_TOL, rtol=F32_TOL, err_msg=name)


def test_capacity_drops_pairs_in_these_cases(single_dispatch):
    """On one device "capacity" and "gmm" differ here: "capacity" drops
    pairs past C, "gmm" none. So the split-sequence "capacity" cases above
    hold drops across the split, and the expert meshes' "gmm" cases, equal
    to the single-device "gmm", drop nothing."""
    assert abs(single_dispatch("gmm")["loss"] - single_dispatch("capacity")["loss"]) > 1e-3


TRAIN_STEPS = 2


@pytest.fixture(scope="module")
def expert_train():
    cfg = replace(TCFG, remat=True)  # remat "dots": the recompute replays the collectives
    return cfg, spawn(run_counted, SPEC.num_devices, run_mixtral_train, SPEC, cfg, IDS,
                      TRAIN_STEPS, "cpu", deadline_s=DEADLINE_S)


def test_train_steps_match_one_process(expert_train):
    """AdamW steps of the expert-parallel model under remat "dots":
    every loss equals the one-process steps', the ranks of a data pair
    hold equal parameters, and the parameters that are not experts are
    equal on all four ranks and equal the one-process model's."""
    cfg, results = expert_train
    model = tmix.MixtralForCausalLM(cfg, device="cpu")
    optimizer = train.make_optimizer(model)
    tids = torch.from_numpy(IDS).long()
    want, _ = train.timed_steps(lambda: train.train_step(model, optimizer, tids,
                                                         torch.from_numpy(TARGETS).long(),
                                                         tmix.moe_lm_loss), TRAIN_STEPS)
    assert want[-1] < want[0]
    for r in results:
        np.testing.assert_allclose(r["losses"], want, rtol=SELF_TOL)
        pair = [p for p in results if p["expert_rank"] == r["expert_rank"]]
        assert all(p["param_digest"] == r["param_digest"] for p in pair)
        assert r["replicated_digest"] == results[0]["replicated_digest"]
    np.testing.assert_allclose(
        results[0]["replicated_digest"],
        param_digest(model, lambda n: not tmix.is_expert_param(n)), rtol=SELF_TOL)


def test_train_step_launches(expert_train):
    """What `chip_smoke.py` phase 16 expects, counted here through the
    kernels' plain versions: each rank runs every layer's attention on
    its replica's rows, under remat "dots" K1 twice (forward and
    recompute), K2 and K3 once per layer and step."""
    cfg, results = expert_train
    n, steps = cfg.num_layers, TRAIN_STEPS + 1
    for r in results:
        assert r["launches"] == {"flash_fwd": 2 * n * steps, "flash_bwd_dkv": n * steps,
                                 "flash_bwd_dq": n * steps}
