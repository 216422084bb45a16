"""Entry points of the port: a one-device forward and the multi-device dryrun.

The port of `__graft_entry__.py`.

`entry()` -> (fn, example_args): the forward of the flagship Llama
(llama-125m, so that one card runs it quickly), as `fn(*example_args)`.

`dryrun_multichip(n)` runs every parallel strategy of `parallel/` for one
training step on tiny shapes, each part in its own world of processes
(`parallel.launch.spawn`):

1. dense: llama-tiny on a mesh with every one of data, fsdp, seq and
   tensor at least 2 (`shard_params`: tensor parallelism, FSDP2 over data
   and fsdp, the ring over seq), one AdamW step;
2. MoE: mixtral-tiny on data x expert (experts split over 4 ranks,
   "capacity"), one Adam step;
3. pipeline: 4 `pipe` stages of the reference's tanh layer, 8
   microbatches, one SGD step of mean(y^2).

Each part checks that its loss is finite and prints the reference's line.
With `device="cpu"` the ranks are gloo processes on the CPU; by default
each rank takes one card over NCCL, and a host with fewer cards than
ranks raises: the dryrun never moves to the CPU by itself.

    python -m ray_tpu_torch.dryrun --cpu [n]     # as `python __graft_entry__.py`
"""
from __future__ import annotations

import argparse
import math
from dataclasses import replace
from typing import Callable, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.llama import CONFIGS, LlamaForCausalLM
from .models.mixtral import CONFIGS as MOE_CONFIGS
from .models.mixtral import MixtralForCausalLM, moe_lm_loss
from .parallel.launch import _local_batch, _rank_device, pipe_mesh, spawn, tanh_stage
from .parallel.mesh import MeshSpec, shard_params
from .parallel.pipeline import local_stage, pipelined, stack_stage_params
from .parallel.step import train_step

# Every world of the dryrun is killed and fails after this long.
DEADLINE_S = 300.0


def entry(device: DeviceLike = None) -> Tuple[Callable, tuple]:
    """The llama-125m forward and its example arguments: the seed-0 model
    and ids [1, 256] from `np.random.RandomState(0)`."""
    device = resolve_device(device)
    cfg = CONFIGS["llama-125m"]
    model = LlamaForCausalLM(cfg, device=device)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 256)),
                          dtype=torch.long, device=device)

    def forward(model, ids):
        return model(ids)

    return forward, (model, ids)


def _dense_rank(rank, world_size, spec: MeshSpec, cfg, ids: np.ndarray, device) -> float:
    device = _rank_device(device)
    mesh = spec.build(device.type)
    model = shard_params(LlamaForCausalLM(cfg, mesh, device=device), mesh)
    # optax.adamw(1e-3): its weight decay of 1e-4 on every leaf.
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    ids_l, targets_l = _local_batch(ids, mesh, device)
    return float(train_step(model, optimizer, ids_l, targets_l, mesh))


def _moe_rank(rank, world_size, spec: MeshSpec, cfg, ids: np.ndarray, device) -> float:
    device = _rank_device(device)
    mesh = spec.build(device.type)
    model = MixtralForCausalLM(cfg, mesh, device=device,
                               generator=torch.Generator(device=device).manual_seed(1))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    ids_l, targets_l = _local_batch(ids, mesh, device)
    return float(train_step(model, optimizer, ids_l, targets_l, mesh, moe_lm_loss))


def _pipeline_rank(rank, world_size, per_stage, x: np.ndarray, device) -> float:
    device = _rank_device(device)
    mesh = pipe_mesh(world_size, device.type)
    stacked = stack_stage_params([{k: torch.from_numpy(v).to(device) for k, v in p.items()}
                                  for p in per_stage])
    params = {k: v.clone().requires_grad_() for k, v in local_stage(stacked, mesh).items()}
    apply = pipelined(tanh_stage, mesh=mesh, n_microbatches=x.shape[0])
    loss = apply(params, torch.from_numpy(x).to(device)).pow(2).mean()
    loss.backward()
    with torch.no_grad():
        for p in params.values():
            p -= 0.1 * p.grad
    return float(loss.detach())


def _strategy_size(n: int) -> int:
    """The reference's ep and pp: 4 where n allows, else 2 or 1."""
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """One training step of each strategy over `n_devices` ranks (rounded
    to a multiple of 16, so that each of the four dense axes is at least
    2). `device="cpu"`: gloo ranks on the CPU; default: one card per rank
    over NCCL."""
    if n_devices < 16 or n_devices % 16:
        n_devices = max(16, n_devices - n_devices % 16)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        cards = torch.cuda.device_count()
        if cards < n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) runs one rank per card and needs "
                             f"{n_devices} cards; this host has {cards}. Pass device='cpu' "
                             f"for gloo ranks on the CPU")
    kind, backend = ("cpu", "gloo") if cpu else ("cuda", "nccl")

    def run(fn, world, *args):
        return spawn(fn, world, *args, kind, deadline_s=DEADLINE_S, backend=backend)[0]

    # Factor n into dp x fsdp x seq x tp: every axis gets 2, the leftover
    # factor rides fsdp (the axis batch sharding leans on).
    factors = {"data": 2, "fsdp": 2 * (n_devices // 16), "seq": 2, "tensor": 2}
    cfg = replace(CONFIGS["llama-tiny"], dtype=torch.float32)
    batch = max(4, 2 * factors["data"] * factors["fsdp"])
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, 32 * factors["seq"]))
    loss = run(_dense_rank, n_devices, MeshSpec(**factors), cfg, ids)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    print(f"dryrun_multichip OK: {n_devices} devices, mesh {factors}, loss {loss:.4f}",
          flush=True)

    ep = _strategy_size(n_devices)
    mcfg = replace(MOE_CONFIGS["mixtral-tiny"], dtype=torch.float32, remat=False,
                   moe_dispatch="capacity")
    mids = rng.randint(0, mcfg.vocab_size, (max(4, 2 * (n_devices // ep)), 32))
    mloss = run(_moe_rank, n_devices, MeshSpec(data=n_devices // ep, expert=ep), mcfg, mids)
    if not math.isfinite(mloss):
        raise RuntimeError(f"non-finite MoE loss {mloss}")
    print(f"dryrun_multichip MoE OK: mesh data={n_devices // ep} expert={ep}, "
          f"loss {mloss:.4f}", flush=True)

    pp = _strategy_size(n_devices)
    d, mb, m_count = 16, 2, 2 * pp
    gen = torch.Generator().manual_seed(2)
    per_stage = [{"w": (torch.randn(d, d, generator=gen) * 0.3).numpy(),
                  "b": (torch.randn(d, generator=gen) * 0.1).numpy()} for _ in range(pp)]
    x = torch.randn(m_count, mb, d, generator=torch.Generator().manual_seed(3)).numpy()
    ploss = run(_pipeline_rank, pp, per_stage, x)
    if not math.isfinite(ploss):
        raise RuntimeError(f"non-finite pipeline loss {ploss}")
    print(f"dryrun_multichip PP OK: pipe={pp} stages, {m_count} microbatches, "
          f"loss {ploss:.4f}", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=16, help="ranks (rounded to 16s)")
    parser.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    fn, example = entry(device)
    with torch.no_grad():
        out = fn(*example)
    print("entry forward OK:", tuple(out.shape), flush=True)
    dryrun_multichip(args.n, device)


if __name__ == "__main__":
    main()
