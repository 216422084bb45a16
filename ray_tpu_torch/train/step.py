"""The train step of every model of the port, and its timing loop.

One forward, loss, backward and AdamW update (`train_step`), split at the
backward (`forward_backward`) so that `parallel.step` can put its gradient
reductions between the backward and the update. `bench` times it on one
card; `parallel.launch` times the sequence-parallel step on each rank.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch

from ..models.llama import causal_lm_loss

LossFn = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]


def make_optimizer(model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW as the reference's `optax.adamw(3e-4, b1=0.9, b2=0.95)`:
    optax decays every leaf by 1e-4 (torch's default is 1e-2). With bf16
    parameters both moments are bf16, as `mu_dtype=bfloat16` gives. A
    model with both DTensor and plain parameters (a Mixtral on a tensor
    axis) gets a group of each: a foreach update takes no mix of them."""
    from torch.distributed.tensor import DTensor

    params = list(model.parameters())
    kinds = [[p for p in params if not isinstance(p, DTensor)],
             [p for p in params if isinstance(p, DTensor)]]
    return torch.optim.AdamW([{"params": g} for g in kinds if g], lr=3e-4,
                             betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-4)


def lm_loss(model, ids, targets):
    return causal_lm_loss(model(ids), targets)


def forward_backward(model, ids, targets, loss_fn: LossFn = lm_loss) -> torch.Tensor:
    """The loss and its gradients; returns the loss, detached."""
    loss = loss_fn(model, ids, targets)
    loss.backward()
    return loss.detach()


def train_step(model, optimizer, ids, targets, loss_fn: LossFn = lm_loss,
               forward_backward: Callable = forward_backward) -> torch.Tensor:
    """One forward, loss, backward (`forward_backward(model, ids, targets,
    loss_fn)`) and update; returns the loss (on the device, not
    synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    loss = forward_backward(model, ids, targets, loss_fn)
    optimizer.step()
    return loss


def timed_steps(step: Callable[[], torch.Tensor], steps: int) -> Tuple[List[float], float]:
    """One warm-up `step()`, then `steps` timed ones; returns every loss,
    warm-up first, and the seconds the timed steps took (reading a loss
    waits for its step)."""
    losses = [step()]
    float(losses[0])
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    float(losses[-1])
    return [float(x) for x in losses], time.perf_counter() - t0
