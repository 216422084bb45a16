"""The sequence- and data-parallel train step, written out.

In the reference one jitted program does this under GSPMD
(`__graft_entry__.py:144-160`, `tests/test_llama.py:73-97`): global ids
go in, XLA splits them over the mesh and inserts the gradient reductions.
Here each rank runs its own block of the batch and the reductions are
explicit:

- `shard_batch` gives each rank its [B / (data * fsdp), T / seq] block of
  ids and targets; the caller rolls the targets over the GLOBAL sequence
  first, so the shift crosses shard boundaries;
- each rank's loss is its block's mean divided by the `seq` size, so
  that the sum over the `seq` group is the replica's mean (the
  reference's `jnp.mean`);
- gradients are summed over `seq` and averaged over `data` and `fsdp`.

A model placed by `parallel.mesh.shard_params` holds DTensor parameters,
whose gradients FSDP2 and tensor parallelism reduce over "data", "fsdp"
and "tensor"; only their sum over "seq" is added here.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import train
from ..train import LossFn, lm_loss
from .collectives import all_reduce_sum_

BATCH_AXES = ("data", "fsdp")


def shard_batch(ids: torch.Tensor, targets: torch.Tensor,
                mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of global `ids` and `targets` [B, T]: rows split
    over ("data", "fsdp") (data major), the sequence over "seq", both
    contiguously, as the reference's P(("data", "fsdp"), "seq")."""
    b, t = ids.shape
    replicas = mesh["data"].size() * mesh["fsdp"].size()
    seq = mesh["seq"].size()
    if b % replicas or t % seq:
        raise ValueError(f"batch {b} x sequence {t} does not split over "
                         f"{replicas} replicas x {seq} sequence shards")
    row = mesh["data"].get_local_rank() * mesh["fsdp"].size() + mesh["fsdp"].get_local_rank()
    col = mesh["seq"].get_local_rank()
    rows = slice(row * b // replicas, (row + 1) * b // replicas)
    cols = slice(col * t // seq, (col + 1) * t // seq)
    return ids[rows, cols], targets[rows, cols]


def _reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over "seq", mean over "data" and "fsdp", in place."""
    all_reduce_sum_(t, mesh.get_group("seq"))
    for axis in BATCH_AXES:
        n = mesh[axis].size()
        if n > 1:
            all_reduce_sum_(t, mesh.get_group(axis)).div_(n)
    return t


def _flat_(grads, reduce) -> None:
    """`reduce` over one flat buffer of `grads` (one dtype), copied back."""
    flat = reduce(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def reduce_gradients(model: torch.nn.Module, mesh) -> None:
    """Reduces every plain-tensor gradient over the mesh (`_reduce`), one
    flat buffer per dtype. A DTensor gradient (`parallel.mesh.shard_params`)
    comes out of backward reduced by FSDP2 over "data" and "fsdp" and by
    tensor parallelism over "tensor"; its local shard is then summed over
    "seq" here, through `all_reduce_sum_`, so that host staging applies.
    An expert axis needs nothing: its ranks see the same rows, and the
    MoE layer's own collectives leave every replicated gradient whole on
    each of them (`models.mixtral`)."""
    plain, sharded = {}, {}
    for p in model.parameters():
        if p.grad is None:
            continue
        if isinstance(p.grad, DTensor):
            sharded.setdefault(p.grad.dtype, []).append(p.grad.to_local())
        else:
            plain.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in plain.values():
        _flat_(grads, lambda t: _reduce(t, mesh))
    if mesh["seq"].size() > 1:
        for grads in sharded.values():
            _flat_(grads, lambda t: all_reduce_sum_(t, mesh.get_group("seq")))


def forward_backward(model, ids, targets, loss_fn: LossFn = lm_loss, *, mesh) -> torch.Tensor:
    """`train.forward_backward` of this rank's block (`shard_batch`), its
    loss divided by the `seq` size and its gradients reduced over the
    mesh; returns the global loss (the reference's mean over the whole
    batch), detached."""
    seq = mesh["seq"].size()
    loss = train.forward_backward(model, ids, targets,
                                  lambda m, i, t: loss_fn(m, i, t) / seq)
    reduce_gradients(model, mesh)
    return _reduce(loss.clone(), mesh)


def train_step(model, optimizer, ids, targets, mesh, loss_fn: LossFn = lm_loss) -> torch.Tensor:
    """`train.train_step` with this module's `forward_backward`; returns
    the global loss."""
    return train.train_step(model, optimizer, ids, targets, loss_fn,
                            functools.partial(forward_backward, mesh=mesh))
