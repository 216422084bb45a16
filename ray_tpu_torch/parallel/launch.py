"""Runs a function on every rank of a torch.distributed world.

`spawn(fn, world_size, *args)` starts `world_size` processes with the
`spawn` method (never `fork`: the caller may hold a CUDA context), joins
them into one process group (gloo unless asked for NCCL) through a
`FileStore` in a fresh
temporary directory (no TCP port, so concurrent worlds cannot collide),
runs `fn(rank, world_size, *args)` in each on one CPU thread and returns
the results by rank. The group's timeout (`PG_TIMEOUT_S`) bounds every
collective; the whole world runs under a deadline, after which, or as
soon as one rank fails, every process is killed and `spawn` raises.
Results come back through `torch.save` files, so they may hold tensors.
gloo lets several ranks share one card (`parallel.ring` stages CUDA
tensors through host memory); NCCL would refuse that.

The drivers below are what the ranks run, for the tests and for
`chip_smoke.py`: the ring on random inputs (`run_ring`), the
sequence-parallel Llama's logits, loss and gradients (`run_llama_grads`)
and its train steps (`run_llama_train`), the step of `shard_params` on
data x fsdp x seq x tensor (`run_sharded_grads`), the pipeline of the
reference's tanh stages (`run_pipeline`) and of a Llama's decoder layers
(`run_pipeline_llama`, with `sequential_llama` its one-process oracle),
and the expert-parallel Mixtral's gradients (`run_mixtral_grads`) and
train steps (`run_mixtral_train`). They import the port only.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..train import LossFn, lm_loss, make_optimizer, timed_steps
from .mesh import MeshSpec
from .step import forward_backward, shard_batch, train_step

POLL_S = 0.05
# Bounds every collective of a world: a rank that waits longer raises.
PG_TIMEOUT_S = 60


def _worker(rank, world_size, root, backend, fn, args):
    torch.set_num_threads(1)
    out = Path(root) / f"rank{rank}"
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(str(Path(root) / "store"), world_size),
            rank=rank, world_size=world_size, timeout=timedelta(seconds=PG_TIMEOUT_S))
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, str(out) + ".tmp")
        os.replace(str(out) + ".tmp", out)
    except BaseException:
        Path(str(out) + ".err").write_text(traceback.format_exc())
        raise


def spawn(fn: Callable, world_size: int, *args, deadline_s: float = 120.0,
          backend: str = "gloo") -> List[Any]:
    """`fn(rank, world_size, *args)` on `world_size` new processes of one
    process group (`backend`: gloo, or NCCL with one card per rank);
    returns the results in rank order. `fn` and `args` must pickle (`fn` a
    module-level function). Raises if a rank fails or the world outlives
    `deadline_s`, after killing every process."""
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="ray_tpu_torch_world_")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world_size, root, backend, fn, args))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > end:
                break
            time.sleep(POLL_S)
        killed = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        failed = [r for r, p in enumerate(procs) if r not in killed and p.exitcode != 0]
        if failed or killed:
            errors = []
            for r in failed:
                err = Path(root) / f"rank{r}.err"
                text = err.read_text() if err.exists() else f"exit code {procs[r].exitcode}\n"
                errors.append(f"rank {r}: {text}")
            why = (f"ranks {failed} failed" if failed
                   else f"the world outlived its deadline of {deadline_s} s")
            raise RuntimeError(f"spawn of {getattr(fn, '__name__', fn)} over {world_size} ranks: "
                               f"{why}; ranks {killed} were killed\n" + "".join(errors))
        return [torch.load(Path(root) / f"rank{r}", weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ drivers
#
# Each runs on the card unless the caller passes device="cpu" (as the
# tests do); with no card and no device asked for it raises
# (`_device.resolve_device`). On the card, rank r takes card r % cards.

def _rank_device(device: DeviceLike) -> torch.device:
    d = resolve_device(device)
    if d.type == "cuda":
        d = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(d)
    return d


def _where(device: torch.device) -> Dict[str, str]:
    return {"backend": dist.get_backend(), "device": str(device),
            "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def _shard(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    n, r = mesh["seq"].size(), mesh["seq"].get_local_rank()
    return x.chunk(n, dim=dim)[r]


def _local_batch(ids: np.ndarray, mesh, device: torch.device):
    gids = torch.as_tensor(ids, dtype=torch.long)
    return tuple(x.to(device) for x in shard_batch(gids, torch.roll(gids, -1, 1), mesh))


def ring_inputs(seed: int, b: int, h: int, hkv: int, t: int, d: int) -> List[np.ndarray]:
    """Global q [B, H, T, D], k, v [B, Hkv, T, D] and do [B, H, T, D],
    float32 normal from `np.random.RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, t, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, t, d))]


def run_ring(rank, world_size, spec: MeshSpec, cases: Sequence[Dict[str, Any]],
             device: DeviceLike = None) -> List[Dict[str, Any]]:
    """For each case (`ring_inputs` arguments, `causal`, `dtype`): this
    rank's shard of the inputs through `ring_self_attention` over the
    mesh's `seq` group and back with the global `do`; returns the seq
    rank, o, dq, dk, dv (on the CPU, in `dtype`), the kernels' launches
    (on the card) and where the rank ran, per case."""
    from ..ops import attention as A
    from ..ops.ring_attention import ring_self_attention

    device = _rank_device(device)
    mesh = spec.build(device.type)
    out = []
    for case in cases:
        dtype = getattr(torch, case.get("dtype", "float32"))
        q, k, v, do = (_shard(torch.from_numpy(x), mesh, 2).to(device, dtype)
                       for x in ring_inputs(*case["inputs"]))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        A.reset_launch_counts()
        o = ring_self_attention(*leaves, mesh, causal=case["causal"])
        o.backward(do)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append({"seq_rank": mesh["seq"].get_local_rank(), "launches": dict(A.LAUNCHES),
                    **_where(device),
                    **{name: x.detach().cpu() for name, x in
                       zip(("o", "dq", "dk", "dv"), (o, *(x.grad for x in leaves)))}})
    return out


def _llama(cfg, mesh, weights, device):
    from ..models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, mesh, device=device)  # seed 0 on every rank
    if weights is not None:
        model.load_state_dict(weights)
    return model


def run_llama_grads(rank, world_size, spec: MeshSpec, cfgs, weights, ids: np.ndarray,
                    device: DeviceLike = None) -> List[Dict[str, Any]]:
    """For each config (remat policies, say): the sequence-parallel Llama
    on this rank's block of `ids` [B, T] (targets rolled globally):
    logits of the block, then the global loss and every gradient, reduced
    over the mesh (`step.forward_backward`)."""
    device = _rank_device(device)
    mesh = spec.build(device.type)
    ids_l, targets_l = _local_batch(ids, mesh, device)
    out = []
    for cfg in cfgs:
        model = _llama(cfg, mesh, weights, device)
        with torch.no_grad():
            logits = model(ids_l).cpu()
        loss = forward_backward(model, ids_l, targets_l, mesh=mesh)
        out.append({"seq_rank": mesh["seq"].get_local_rank(), "logits": logits,
                    "loss": float(loss),
                    "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}})
    return out


def param_digest(model: torch.nn.Module,
                 keep: Callable[[str], bool] = lambda name: True) -> Tuple[float, float]:
    """Sum and sum of squares of every parameter whose name `keep` takes,
    in float64: equal on ranks whose parameters are equal, on one kind of
    device."""
    total = squares = 0.0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if keep(name):
                x = p.detach().double()
                total += float(x.sum())
                squares += float((x * x).sum())
    return total, squares


def _train(model, mesh, ids: np.ndarray, steps: int, loss_fn: LossFn,
           device: torch.device) -> Dict[str, Any]:
    """`step.train_step` of `model` on this rank's block of `ids`, AdamW
    of `train.make_optimizer`: one step, then `steps` timed ones."""
    from ..ops import attention as A

    ids_l, targets_l = _local_batch(ids, mesh, device)
    optimizer = make_optimizer(model)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    A.reset_launch_counts()
    losses, seconds = timed_steps(
        lambda: train_step(model, optimizer, ids_l, targets_l, mesh, loss_fn), steps)
    return {"losses": losses, "step_ms": seconds / steps * 1e3, "launches": dict(A.LAUNCHES),
            "param_digest": param_digest(model),
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
            **_where(device)}


def run_llama_train(rank, world_size, spec: MeshSpec, cfg, ids: np.ndarray, steps: int,
                    loss_fn: Optional[LossFn] = None,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The sequence-parallel Llama train step as a user runs it: the
    weights of seed 0, this rank's block of `ids` [B, T] (targets rolled
    globally), AdamW of `train.make_optimizer`, `loss_fn` (default
    `train.lm_loss`); one step, then `steps` timed ones
    (`train.timed_steps`). Returns the global losses, the timed steps'
    mean ms, this rank's kernel launches over all steps, its parameters'
    digest after the last step (`param_digest`), its peak memory and
    where it ran."""
    device = _rank_device(device)
    mesh = spec.build(device.type)
    out = _train(_llama(cfg, mesh, None, device), mesh, ids, steps, loss_fn or lm_loss, device)
    return {**out, "seq_rank": mesh["seq"].get_local_rank()}


def run_sharded_grads(rank, world_size, spec: MeshSpec, cfg, weights, ids: np.ndarray,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The Llama built on the mesh and placed by `shard_params` (tensor
    parallelism, then FSDP2 over data and fsdp; the ring over seq) on
    this rank's block of `ids` (targets rolled): the global loss and
    every gradient, gathered whole."""
    from .mesh import shard_params

    device = _rank_device(device)
    mesh = spec.build(device.type)
    ids_l, targets_l = _local_batch(ids, mesh, device)
    model = shard_params(_llama(cfg, mesh, weights, device), mesh)
    loss = forward_backward(model, ids_l, targets_l, mesh=mesh)
    return {"loss": float(loss),
            "grads": {n: p.grad.full_tensor().cpu() for n, p in model.named_parameters()}}


# ------------------------------------------------------------ pipeline


def tanh_stage(params, x):
    """The reference's test and dryrun stage: tanh(x W + b)."""
    return torch.tanh(x @ params["w"] + params["b"])


def pipe_mesh(n_stages: int, device_type: str):
    """The 1-D `pipe` mesh over ranks 0..n_stages-1 of the world (the
    reference's `Mesh(devices[:n], ("pipe",))`); the other ranks hold no
    coordinate."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_stages,), mesh_dim_names=("pipe",))


def run_pipeline(rank, world_size, cases: Sequence[Dict[str, Any]],
                 device: DeviceLike = None) -> List[Optional[Dict[str, Any]]]:
    """For each case (per-stage `weights` {"w", "b"} as numpy, `x` [M, mb,
    d], `remat`): the `tanh_stage` pipeline over the first S ranks, S the
    number of stages, its output, the gradients of mean(y^2) with respect
    to this rank's stage and the input, and how often the stage ran. A
    rank outside the pipeline gives None."""
    from .pipeline import local_stage, pipelined, stack_stage_params

    device = _rank_device(device)
    out: List[Optional[Dict[str, Any]]] = []
    for case in cases:
        weights = case["weights"]
        mesh = pipe_mesh(len(weights), device.type)
        if mesh.get_coordinate() is None:
            out.append(None)
            continue
        stacked = stack_stage_params([{k: torch.from_numpy(v).to(device) for k, v in w.items()}
                                      for w in weights])
        params = {k: v.clone().requires_grad_() for k, v in local_stage(stacked, mesh).items()}
        x = torch.from_numpy(case["x"]).to(device).requires_grad_()
        calls = [0]

        def stage(p, h):
            calls[0] += 1
            return tanh_stage(p, h)

        apply = pipelined(stage, mesh=mesh, n_microbatches=x.shape[0], remat=case["remat"])
        y = apply(params, x)
        y.pow(2).mean().backward()
        out.append({"stage": mesh.get_local_rank("pipe"), "y": y.detach().cpu(),
                    "grads": {k: v.grad.cpu() for k, v in params.items()},
                    "dx": x.grad.cpu(), "stage_calls": calls[0]})
    return out


def llama_stages(cfg, n_stages: int, layers_per_stage: int, ids: np.ndarray,
                 device: torch.device):
    """The seed-0 Llama of `n_stages * layers_per_stage` decoder layers cut
    into stages: (the stages, ModuleLists of `layers_per_stage` layers in
    order; x, the embedding of `ids` [M, mb, T]; the stage function, which
    runs a stage's layers through `models.llama.run_layer` at positions
    0..T-1)."""
    from dataclasses import replace

    from ..models.llama import LlamaForCausalLM, run_layer

    cfg = replace(cfg, num_layers=n_stages * layers_per_stage)
    model = LlamaForCausalLM(cfg, device=device)
    tids = torch.as_tensor(ids, dtype=torch.long, device=device)
    with torch.no_grad():
        x = model.embed_tokens(tids)
    positions = torch.arange(tids.shape[-1], device=device).expand(tids.shape[1:])
    stages = [torch.nn.ModuleList(model.layers[i * layers_per_stage:(i + 1) * layers_per_stage])
              for i in range(n_stages)]

    def stage_fn(layers, h):
        for layer in layers:
            h = run_layer(cfg, layer, h, positions)
        return h

    return stages, x, stage_fn


def _sgd_steps(forward: Callable[[], torch.Tensor], modules, steps: int, lr: float):
    """One SGD step of mean(y^2), y = forward(), then `steps` timed ones;
    returns (the first step's y and each module's gradients, on the CPU;
    every loss; the timed seconds)."""
    optimizer = torch.optim.SGD([p for m in modules for p in m.parameters()], lr=lr)
    first: Dict[str, Any] = {}

    def step():
        optimizer.zero_grad(set_to_none=True)
        y = forward()
        loss = y.float().pow(2).mean()
        loss.backward()
        if not first:
            first["y"] = y.detach().cpu()
            first["grads"] = [{n: p.grad.cpu() for n, p in m.named_parameters()}
                              for m in modules]
        optimizer.step()
        return loss.detach()

    losses, seconds = timed_steps(step, steps)
    return first, losses, seconds


def sequential_llama(cfg, n_stages: int, layers_per_stage: int, ids: np.ndarray, steps: int,
                     lr: float, device: DeviceLike = None) -> Dict[str, Any]:
    """`run_pipeline_llama`'s oracle in one process: the same stages run
    in sequence over each microbatch (`pipeline.sequential_reference`),
    the same SGD steps."""
    from .pipeline import sequential_reference

    device = resolve_device(device)
    stages, x, stage_fn = llama_stages(cfg, n_stages, layers_per_stage, ids, device)
    first, losses, seconds = _sgd_steps(lambda: sequential_reference(stage_fn, stages, x),
                                        stages, steps, lr)
    return {"y": first["y"], "grads": first["grads"], "losses": losses,
            "step_ms": seconds / steps * 1e3}


def run_pipeline_llama(rank, world_size, cfg, layers_per_stage: int, ids: np.ndarray,
                       steps: int, lr: float, device: DeviceLike = None) -> Dict[str, Any]:
    """A Llama's decoder layers as a pipeline of `world_size` stages:
    stage s holds layers [s L/S, (s+1) L/S) of the seed-0 model
    (`llama_stages`), ids [M, mb, T] are embedded by that model and go in
    as M microbatches. One SGD step (rate `lr`) of mean(y^2), then
    `steps` timed ones.
    Returns the first step's y and this stage's gradients, every loss, the
    timed steps' mean ms, the kernels' launches over all steps, the peak
    memory and where it ran."""
    from ..ops import attention as A
    from .pipeline import pipelined

    device = _rank_device(device)
    mesh = pipe_mesh(world_size, device.type)
    s = mesh.get_local_rank("pipe")
    stages, x, stage_fn = llama_stages(cfg, world_size, layers_per_stage, ids, device)
    stage = stages[s]
    del stages
    apply = pipelined(stage_fn, mesh=mesh, n_microbatches=x.shape[0])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    A.reset_launch_counts()
    first, losses, seconds = _sgd_steps(lambda: apply(stage, x), [stage], steps, lr)
    return {"stage": s, "y": first["y"], "grads": first["grads"][0], "losses": losses,
            "step_ms": seconds / steps * 1e3, "launches": dict(A.LAUNCHES),
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
            **_where(device)}


# ------------------------------------------------------------ expert parallelism


def _mixtral(cfg, mesh, weights, device):
    from ..models.mixtral import MixtralForCausalLM, shard_experts

    model = MixtralForCausalLM(cfg, mesh, device=device)  # seed 0 on every rank
    if weights is not None:
        model.load_state_dict(shard_experts(weights, model))
    return model


def _expert_coordinates(mesh) -> Dict[str, int]:
    return {"expert_rank": mesh["expert"].get_local_rank(),
            "data_rank": mesh["data"].get_local_rank() * mesh["fsdp"].size()
            + mesh["fsdp"].get_local_rank()}


def run_mixtral_grads(rank, world_size, spec: MeshSpec, cfg, weights, ids: np.ndarray,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The Mixtral built on the mesh (experts split over "expert", rows
    over "data" and "fsdp") on this rank's rows of `ids`: their logits,
    the global `moe_lm_loss` and every gradient, reduced over the mesh
    (expert weights: this rank's experts only)."""
    from ..models.mixtral import moe_lm_loss

    device = _rank_device(device)
    mesh = spec.build(device.type)
    ids_l, targets_l = _local_batch(ids, mesh, device)
    model = _mixtral(cfg, mesh, weights, device)
    with torch.no_grad():
        logits = model(ids_l).cpu()
    loss = forward_backward(model, ids_l, targets_l, moe_lm_loss, mesh=mesh)
    return {"logits": logits, "loss": float(loss), **_expert_coordinates(mesh),
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}}


def run_mixtral_train(rank, world_size, spec: MeshSpec, cfg, ids: np.ndarray, steps: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The expert-parallel Mixtral train step: the weights of seed 0,
    `moe_lm_loss`, AdamW of `train.make_optimizer`; one step, then `steps`
    timed ones. Returns what `run_llama_train` does, the digest of the
    parameters that are not split over experts, and the rank's expert and
    data coordinates."""
    from ..models.mixtral import is_expert_param, moe_lm_loss

    device = _rank_device(device)
    mesh = spec.build(device.type)
    model = _mixtral(cfg, mesh, None, device)
    out = _train(model, mesh, ids, steps, moe_lm_loss, device)
    return {**out, **_expert_coordinates(mesh),
            "replicated_digest": param_digest(model, lambda n: not is_expert_param(n))}
