"""GPipe pipeline parallelism on torch.distributed: the port of
`ray_tpu/parallel/pipeline.py`.

The reference puts the whole schedule inside one SPMD program over a
`pipe` mesh axis: each device holds one stage's parameters (a pytree
stacked on a leading axis), activations move between ticks with one
`lax.ppermute`, and `jax.grad` of the pipelined loss gives the backward
pipeline, the transpose of a `ppermute` being the reverse `ppermute`.
Here each rank of the `pipe` group is a process that holds only its own
stage's parameters (a module or a pytree of tensors), and the schedule
is written out:

- forward: M + S - 1 ticks (M microbatches, S stages). At tick t stage 0
  ingests microbatch t, stage s consumes what its left neighbour sent,
  and the last stage commits microbatch t - (S - 1). After each tick
  every stage sends its output to rank (s + 1) % S
  (`parallel.ring.start_shift`, which picks the transport by the group's
  backend: NCCL, or gloo with host staging). A stage skips the compute of
  a bubble tick (a tick with no microbatch of its own), as ring attention
  launches nothing for a future block; every rank still takes part in
  every tick's shift, sending zeros. The committed outputs are summed
  over the group (the reference's `psum` of the masked buffer), so every
  rank returns them.
- backward: one `torch.autograd.Function` over the whole schedule, since
  each rank's autograd sees only its own graph (a received tensor whose
  sender's graph lives in another process would never run its backward
  there, and its neighbour would wait on the group's timeout). The ticks
  run in reverse: each stage takes the gradient of its tick's output from
  its right neighbour (the reverse shift; the last stage reads it from
  the output's gradient), takes the stage's VJP, adds the parameter
  gradients up, and sends the input's gradient to its left neighbour.
  Every rank computes its loss on the same replicated output, so only
  the last stage's cotangent enters: the gradients equal
  `sequential_reference`'s, as the reference's do.

`remat` decides only whether the forward keeps each tick's graph (False)
or only its input, the backward re-running the stage (True, the
reference's `jax.checkpoint(stage_fn)`). Per rank the stage runs M times
forward and, under `remat`, M more times backward.

Constraint, as in the reference: every stage maps a microbatch to one of
the same shape and dtype. The microbatched input is given to every rank;
only stage 0 reads it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .collectives import all_reduce_sum_
from .ring import start_shift
from .timing import span


def stack_stage_params(per_stage: Sequence[Any]):
    """Stack S per-stage parameter pytrees on a new leading axis, as the
    reference does; rank s takes its stage back with `local_stage`."""
    return tree_map(lambda *xs: torch.stack(xs), per_stage[0], *per_stage[1:])


def pipeline_spec(mesh, axis: str = "pipe") -> Tuple[List[Any], List[Any]]:
    """(params placements, replicated placements) on the 1-D `pipe` mesh:
    stacked stage parameters split on their leading axis, everything else
    replicated (the reference's `NamedSharding(mesh, P(axis))` and
    `P()`)."""
    del mesh, axis
    return [Shard(0)], [Replicate()]


def local_stage(stacked, mesh, axis: str = "pipe"):
    """This rank's stage of `stack_stage_params`'s stack."""
    s = mesh.get_local_rank(axis)
    return tree_map(lambda p: p[s], stacked)


def _leaves(stage_params) -> Tuple[List[torch.Tensor], Any, List[torch.Tensor]]:
    """(the tensors autograd sees, the params object the stage function
    gets, the tensors the schedule differentiates, in the same order). A
    module's own parameters serve as all three; a pytree's leaves are
    replaced by detached copies, so the schedule can take gradients with
    respect to them inside its backward."""
    if isinstance(stage_params, nn.Module):
        params = list(stage_params.parameters())
        return params, stage_params, params
    flat, spec = tree_flatten(stage_params)
    live = [p.detach().requires_grad_(p.requires_grad) for p in flat]
    return flat, tree_unflatten(live, spec), live


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, params, live, x, *leaves):
        stage_fn, group, m_count, remat = sched
        n, s = dist.get_world_size(group), dist.get_rank(group)
        ticks = m_count + n - 1
        need_dx = s > 0 or ctx.needs_input_grad[3]
        saved = {}
        out = torch.zeros_like(x)
        zeros = torch.zeros_like(x[0])
        received = zeros
        with span("pipeline"):
            for t in range(ticks):
                m = t - s
                if 0 <= m < m_count:
                    inp = (x[m] if s == 0 else received).detach().requires_grad_(need_dx)
                    with span("stage"), torch.set_grad_enabled(not remat):
                        y = stage_fn(params, inp)
                    if y.shape != zeros.shape or y.dtype != zeros.dtype:
                        raise ValueError(f"a pipeline stage must keep the microbatch's shape and "
                                         f"dtype {tuple(zeros.shape)} {zeros.dtype}, got "
                                         f"{tuple(y.shape)} {y.dtype}")
                    saved[t] = (inp, None if remat else y)
                    send = y.detach()
                    if s == n - 1:
                        out[m] = send
                else:
                    send = zeros
                received = start_shift([send], group).wait()[0]
        ctx.sched, ctx.params, ctx.live, ctx.saved = sched, params, live, saved
        ctx.x_like = zeros
        return all_reduce_sum_(out, group)

    @staticmethod
    def backward(ctx, dout):
        stage_fn, group, m_count, remat = ctx.sched
        n, s = dist.get_world_size(group), dist.get_rank(group)
        ticks = m_count + n - 1
        params = ctx.live
        grads: List[Any] = [None] * len(params)
        want_dx = ctx.needs_input_grad[3]
        dx = torch.zeros_like(dout) if want_dx else None
        zeros = ctx.x_like
        received = zeros
        with span("pipeline"):
            for t in reversed(range(ticks)):
                m = t - s
                send = zeros
                if 0 <= m < m_count:
                    # The gradient of this tick's output: from the loss at the
                    # last stage, else what the right neighbour's input got.
                    dy = dout[m] if s == n - 1 else received
                    inp, y = ctx.saved.pop(t)
                    wrt = [p for p in params if p.requires_grad]
                    if inp.requires_grad:
                        wrt.append(inp)
                    with span("stage"):
                        if y is None:
                            with torch.enable_grad():
                                y = stage_fn(ctx.params, inp)
                        got = iter(torch.autograd.grad(y, wrt, dy, allow_unused=True))
                    for i, p in enumerate(params):
                        if p.requires_grad:
                            g = next(got)
                            if g is not None:
                                grads[i] = g if grads[i] is None else grads[i] + g
                    if inp.requires_grad:
                        dinp = next(got)
                        if dinp is not None:
                            if s > 0:
                                send = dinp
                            elif want_dx:
                                dx[m] = dinp
                if t > 0:
                    received = start_shift([send], group, reverse=True).wait()[0]
        if want_dx:
            all_reduce_sum_(dx, group)
        return (None, None, None, dx, *grads)


def pipelined(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    mesh,
    axis: str = "pipe",
    n_microbatches: int,
    remat: bool = False,
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Lift `stage_fn(stage_params, x) -> y` (one pipeline stage) into the
    S-stage pipelined apply over the `axis` group of `mesh` (a
    `DeviceMesh`, say `init_device_mesh(device_type, (S,),
    mesh_dim_names=("pipe",))`).

    Returns `apply(stage_params, x)`: `stage_params` are THIS rank's
    stage's (a module, or a pytree of tensors; see `local_stage`), `x` is
    [M, microbatch, ...] (M = `n_microbatches`) on every rank. The result
    is stage_{S-1}(...stage_0(x)) per microbatch, on every rank.
    Differentiable with respect to the stage's parameters and to `x`."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}: {names}")
    group = mesh.get_group(axis)
    sched = (stage_fn, group, n_microbatches, remat)

    @functools.wraps(stage_fn)
    def apply(stage_params, x):
        if x.shape[0] != n_microbatches:
            raise ValueError(f"expected leading microbatch axis {n_microbatches}, "
                             f"got {x.shape[0]}")
        leaves, params, live = _leaves(stage_params)
        return _Pipeline.apply(sched, params, live, x, *leaves)

    return apply


def sequential_reference(stage_fn, per_stage_params, x: torch.Tensor) -> torch.Tensor:
    """Unpipelined oracle: fold the stages over each microbatch of x
    [M, microbatch, ...]."""
    def one(mb):
        for p in per_stage_params:
            mb = stage_fn(p, mb)
        return mb

    return torch.stack([one(x[m]) for m in range(x.shape[0])])
