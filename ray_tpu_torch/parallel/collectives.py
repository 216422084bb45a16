"""All-reduces on torch.distributed, in place and differentiable.

`all_reduce_sum_` sums a tensor over a group in place, through host
memory where the group's backend cannot take the tensor's device
(`ring.host_staged`: a CUDA tensor on a gloo group, as when several ranks
share one card).

The three autograd functions carry a layer whose work is split over a
group while its input and output are replicated there (Megatron's pair,
here for the experts of an MoE layer split over the `expert` axis):

- `copy_to_group`: identity forward; the backward sums each rank's share
  of the input's gradient over the group;
- `reduce_from_group`: sums the ranks' partial outputs forward; identity
  backward (every rank holds the whole output's gradient);
- `sum_over_groups`: a sum over the ranks of a quantity that every rank
  then uses alike (the router's batch statistics under data parallelism);
  its adjoint is the same sum, so that averaging the ranks' gradients
  afterwards gives the gradient of the global quantity.

With a group of one rank each is the identity.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from . import ring


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sums `t` over `group` in place, through host memory where the
    group's backend cannot take `t`'s device (`ring.host_staged`)."""
    if dist.get_world_size(group) == 1:
        return t
    if ring.host_staged(group, t):
        host = t.to("cpu", copy=True)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _sum(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    t = t.contiguous().clone()
    for group in groups:
        all_reduce_sum_(t, group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return _sum(dx, [ctx.group]), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, [group])

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumOverGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.groups), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def sum_over_groups(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """`x` summed over every group of `groups` in turn (the groups of
    several mesh axes: their product group)."""
    return _SumOverGroups.apply(x, tuple(groups))
