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
and "tensor"; only their sum over "seq" is added here. A DTensor over
"tensor" alone (a Mixtral's attention, `models.mixtral`) is also averaged
over "data" and "fsdp" here.
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
from .timing import span

BATCH_AXES = ("data", "fsdp")


def batch_slices(shape: Tuple[int, ...], mesh) -> Tuple[slice, slice]:
    """The (rows, columns) of this rank's block of a global [B, T, ...]
    batch: rows split over ("data", "fsdp") (data major), the sequence
    over "seq", both contiguously, as the reference's P(("data", "fsdp"),
    "seq")."""
    if len(shape) < 2:
        raise ValueError(f"a batch column of shape {tuple(shape)} has no "
                         "sequence dim to split")
    b, t = shape[:2]
    replicas = mesh["data"].size() * mesh["fsdp"].size()
    seq = mesh["seq"].size()
    if b % replicas or t % seq:
        raise ValueError(f"batch {b} x sequence {t} does not split over "
                         f"{replicas} replicas x {seq} sequence shards")
    row = mesh["data"].get_local_rank() * mesh["fsdp"].size() + mesh["fsdp"].get_local_rank()
    col = mesh["seq"].get_local_rank()
    return (slice(row * b // replicas, (row + 1) * b // replicas),
            slice(col * t // seq, (col + 1) * t // seq))


def shard_batch(ids: torch.Tensor, targets: torch.Tensor,
                mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of global `ids` and `targets` [B, T]
    (`batch_slices`)."""
    block = batch_slices(ids.shape, mesh)
    return ids[block], targets[block]


def _reduce(t: torch.Tensor, mesh, batch_axes: Tuple[str, ...] = BATCH_AXES) -> torch.Tensor:
    """Sum over "seq", mean over `batch_axes` ("data" and "fsdp"), in
    place."""
    with span("grad_all_reduce"):
        all_reduce_sum_(t, mesh.get_group("seq"))
        for axis in batch_axes:
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
    flat buffer per dtype. A DTensor gradient comes out of backward
    reduced over the axes of its own mesh: by FSDP2 over "data" and
    "fsdp" (`parallel.mesh.shard_params`) and by tensor parallelism over
    "tensor"; its local shard is then summed over "seq" and averaged over
    the batch axes its mesh lacks here, through `all_reduce_sum_`, so that
    host staging applies. An expert axis needs nothing: its ranks see the
    same rows, and the MoE layer's own collectives leave every replicated
    gradient whole on each of them (`models.mixtral`)."""
    buffers = {}
    for p in model.parameters():
        if p.grad is None:
            continue
        grad, axes = p.grad, BATCH_AXES
        if isinstance(grad, DTensor):
            axes = tuple(a for a in BATCH_AXES if a not in grad.device_mesh.mesh_dim_names)
            grad = grad.to_local()
        buffers.setdefault((grad.dtype, axes), []).append(grad)
    for (_, axes), grads in buffers.items():
        if axes or mesh["seq"].size() > 1:
            _flat_(grads, lambda t, axes=axes: _reduce(t, mesh, axes))


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
