"""Expert parallelism of the port's Mixtral (`MixtralForCausalLM(cfg,
mesh)`) against its single-device model and the flax model, on the CPU.

mixtral-tiny (4 experts, top-2) in float32 on MeshSpec(data=2, expert=2):
4 gloo ranks (`parallel.launch.spawn`), rows split over data, experts
over expert, "capacity" forced by the mesh. The flax parameters go
through `mixtral_params_from_flax`, and each rank keeps its experts
(`shard_experts`). Routing is discrete, so the port's single-device
routing is first held equal to the flax model's. The expert-parallel
model against the port's own single-device one: the same float32
arithmetic split over ranks, 1e-5; against flax, summation order too,
1e-4 (as `test_torch_mixtral.py`).
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
from ray_tpu_torch import train
from ray_tpu_torch.convert import mixtral_params_from_flax
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.parallel.launch import (
    param_digest,
    run_mixtral_grads,
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
def test_explicit_dispatch_on_an_expert_mesh_raises(expert_mesh, dispatch):
    """Pinned divergence: the reference returns an explicit "gmm" or
    "ragged" on an expert mesh and leaves its layout to GSPMD; the port's
    expert branch is capacity only, and raises."""
    mesh = expert_mesh()
    jmesh = JaxMeshSpec(data=2, expert=2).build()
    assert jmix.resolve_moe_dispatch(replace(JCFG, moe_dispatch=dispatch), mesh=jmesh) == dispatch
    cfg = replace(TCFG, moe_dispatch=dispatch)
    with pytest.raises(ValueError, match="capacity"):
        tmix.resolve_moe_dispatch(cfg, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="capacity"):
        tmix.MixtralForCausalLM(cfg, mesh, device="cpu")


@pytest.mark.parametrize("spec,dispatch,error", [
    (MeshSpec(data=2, tensor=2), "capacity", "tensor parallelism"),
    (MeshSpec(seq=2, expert=2), "auto", "whole sequence"),
    (MeshSpec(seq=4), "capacity", "whole sequence"),
    (MeshSpec(seq=4), "gmm", None),
])
def test_mixtral_mesh_limits(expert_mesh, spec, dispatch, error):
    """Pinned divergence: the port raises for a Mixtral mesh with tensor
    parallelism, which it does not port, and for "capacity" over a split
    sequence (capacity positions run over the whole sequence); the
    reference leaves both to GSPMD. Over seq the other dispatches run the
    ring."""
    mesh = expert_mesh(spec=spec)
    cfg = replace(TCFG, moe_dispatch=dispatch)
    if error is None:
        model = tmix.MixtralForCausalLM(cfg, mesh, device="cpu")
        assert model.layers[0].attn.ring_mesh is mesh
        return
    with pytest.raises(ValueError, match=error):
        tmix.MixtralForCausalLM(cfg, mesh, device="cpu")


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
    assert torch.equal(tmix.shard_experts(want, model)["layers.0.moe.w_up"],
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
