"""Out-of-graph collectives over the object store.

Reference: ray.util.collective (util/collective/collective.py —
GroupManager :40, init_collective_group :120, allreduce/allgather/
reducescatter/broadcast :258-615) with NCCL/GLOO backends and a named
rendezvous actor holding the ncclUniqueId (util/collective/util.py:9);
and this repo's ray_tpu/util/collective, whose rendezvous actor became
the group coordinator itself: an async actor that gathers each round's
contributions through the shared-memory object store, reduces once, and
hands every rank the result. The port keeps that design for torch
tensors. A CUDA tensor is copied to the host and travels as the object
store sends every tensor; the coordinator reduces torch tensors with
torch on its CPU, so bfloat16 needs nothing beyond torch. A rank that
passed a tensor gets a tensor back on its tensor's device and in its
dtype; a rank that passed a numpy array gets numpy, reduced in numpy as
the reference does.

In-graph collectives between the ranks of one training job are
torch.distributed's (`parallel.collectives`); this module moves tensors
between actors of the runtime that share no process group.

API intentionally mirrors the reference so user code ports 1:1.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError, RayActorError

_REDUCE_OPS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "mean": lambda arrs: np.mean(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
    "product": lambda arrs: np.prod(arrs, axis=0),
}

# The same reductions over torch tensors stacked on dim 0. An integer mean
# is taken in float64, as numpy's.
_TORCH_REDUCE_OPS = {
    "sum": lambda s: s.sum(0),
    "mean": lambda s: (s if s.is_floating_point() else s.double()).mean(0),
    "max": lambda s: s.amax(0),
    "min": lambda s: s.amin(0),
    "product": lambda s: s.prod(0),
}


def _is_tensor(x: Any) -> bool:
    torch = sys.modules.get("torch")  # no torch loaded: no tensors
    return torch is not None and isinstance(x, torch.Tensor)


def _reduce(op: str, ordered: List[Any]) -> Any:
    if any(_is_tensor(p) for p in ordered):
        import torch

        return _TORCH_REDUCE_OPS[op](torch.stack([torch.as_tensor(p) for p in ordered]))
    return _REDUCE_OPS[op]([np.asarray(a) for a in ordered])


# After the first member leaves, the coordinator waits this long for the
# others before it exits anyway, so a member that crashed cannot keep it.
LEAVE_TIMEOUT_S = 60.0


class _GroupCoordinator:
    """Async actor: one instance per collective group. It lives until
    every member has left (`destroy_collective_group`); the reference's
    rank 0 kills it on its own return, under the others' replies."""

    def __init__(self, world_size: int, group_name: str = "default"):
        import asyncio

        self.world_size = world_size
        self.group_name = group_name
        self.rounds: Dict[str, Dict[int, Any]] = {}
        self.results: Dict[str, Any] = {}
        self.events: Dict[str, "asyncio.Event"] = {}
        self.left: set = set()
        self.leave_timeout_s = LEAVE_TIMEOUT_S
        self._expiry: Optional["asyncio.Task"] = None

    def _event(self, key: str):
        import asyncio

        if key not in self.events:
            self.events[key] = asyncio.Event()
        return self.events[key]

    async def contribute(self, key: str, rank: int, payload: Any, op: str):
        contributions = self.rounds.setdefault(key, {})
        contributions[rank] = payload
        ev = self._event(key)
        if len(contributions) == self.world_size:
            ordered = [contributions[r] for r in range(self.world_size)]
            if op in _REDUCE_OPS:
                self.results[key] = _reduce(op, ordered)
            elif op == "gather":
                self.results[key] = [_to_host(a) for a in ordered]
            elif op == "barrier":
                self.results[key] = True
            elif op == "broadcast":
                src = next(p for p in ordered if p is not None)
                self.results[key] = _to_host(src)
            else:
                raise ValueError(f"unknown collective op {op}")
            ev.set()
        else:
            await ev.wait()
        return self.results[key]

    async def cleanup(self, key: str):
        self.rounds.pop(key, None)
        self.results.pop(key, None)
        self.events.pop(key, None)
        return True

    async def leave(self, rank: int) -> bool:
        """`rank` has left the group. True for the last member to leave,
        which then ends the coordinator: every member's replies have
        returned by then. The expiry runs from the first leave on, so the
        coordinator ends even if the last member never hears its answer."""
        import asyncio

        self.left.add(rank)
        if self._expiry is None:
            self._expiry = asyncio.ensure_future(self._expire())
        return len(self.left) >= self.world_size

    async def _expire(self) -> None:
        import asyncio

        await asyncio.sleep(self.leave_timeout_s)
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(_coordinator_name(self.group_name)))


class _GroupState:
    def __init__(self, name: str, world_size: int, rank: int, coordinator):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self.op_counter = 0
        self.lock = threading.Lock()

    def next_key(self, op: str) -> str:
        with self.lock:
            self.op_counter += 1
            return f"{op}:{self.op_counter}"


_groups: Dict[str, _GroupState] = {}
_groups_lock = threading.Lock()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "host",
    group_name: str = "default",
) -> None:
    """Join a collective group; every member must call this
    (reference: init_collective_group :120; NCCL rendezvous replaced by
    a named coordinator actor). The one backend, "host", is that actor;
    the reference's "xla" names XLA's in-graph collectives, which torch
    does not have."""
    if backend != "host":
        raise ValueError(f"unsupported backend {backend!r} (host)")
    coordinator_cls = ray_tpu_torch.remote(_GroupCoordinator)
    coordinator = coordinator_cls.options(
        name=_coordinator_name(group_name), get_if_exists=True
    ).remote(world_size, group_name)
    with _groups_lock:
        _groups[group_name] = _GroupState(group_name, world_size, rank, coordinator)


def _coordinator_name(group_name: str) -> str:
    return f"__collective_{group_name}"


def _group(group_name: str) -> _GroupState:
    with _groups_lock:
        g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' not initialized in this process"
        )
    return g


def _to_host(tensor: Any) -> Any:
    """A payload on the host, as a rank sends it and the coordinator hands
    it on: a tensor as a CPU tensor of its dtype (a CUDA one copied to the
    host), anything else as a numpy array."""
    if _is_tensor(tensor):
        return tensor.detach().cpu()
    return np.asarray(tensor)


def _like(result: Any, tensor: Any) -> Any:
    """`result` on `tensor`'s device and in its dtype when `tensor` is a
    torch tensor; unchanged otherwise."""
    if _is_tensor(tensor):
        return result.to(device=tensor.device, dtype=tensor.dtype)
    return result


def allreduce(tensor: Any, group_name: str = "default", op: str = "sum") -> Any:
    g = _group(group_name)
    key = g.next_key(f"allreduce_{op}")
    return _like(ray_tpu_torch.get(
        g.coordinator.contribute.remote(key, g.rank, _to_host(tensor), op)
    ), tensor)


def allgather(tensor: Any, group_name: str = "default") -> List[Any]:
    g = _group(group_name)
    key = g.next_key("allgather")
    return [_like(t, tensor) for t in ray_tpu_torch.get(
        g.coordinator.contribute.remote(key, g.rank, _to_host(tensor), "gather")
    )]


def reducescatter(tensor: Any, group_name: str = "default", op: str = "sum") -> Any:
    g = _group(group_name)
    key = g.next_key(f"reducescatter_{op}")
    full = ray_tpu_torch.get(
        g.coordinator.contribute.remote(key, g.rank, _to_host(tensor), op)
    )
    if _is_tensor(full):
        import torch

        # tensor_split splits as np.array_split: the first chunks one larger.
        return _like(torch.tensor_split(full, g.world_size, dim=0)[g.rank], tensor)
    return np.array_split(full, g.world_size, axis=0)[g.rank]


def broadcast(tensor: Optional[Any], src_rank: int = 0, group_name: str = "default") -> Any:
    """`src_rank`'s tensor on every rank. A rank that passes a tensor gets
    the result on that tensor's device and in its dtype; a rank that
    passes None gets what the source sent, on the host."""
    g = _group(group_name)
    key = g.next_key("broadcast")
    payload = _to_host(tensor) if g.rank == src_rank else None
    return _like(ray_tpu_torch.get(
        g.coordinator.contribute.remote(key, g.rank, payload, "broadcast")
    ), tensor)


def barrier(group_name: str = "default") -> None:
    g = _group(group_name)
    key = g.next_key("barrier")
    ray_tpu_torch.get(g.coordinator.contribute.remote(key, g.rank, None, "barrier"))


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave the group. The last member to leave ends its coordinator;
    one that never leaves holds it LEAVE_TIMEOUT_S after the first did."""
    with _groups_lock:
        g = _groups.pop(group_name, None)
    if g is None:
        return
    try:
        last = ray_tpu_torch.get(g.coordinator.leave.remote(g.rank),
                                 timeout=LEAVE_TIMEOUT_S)
    except (RayActorError, GetTimeoutError):
        return  # gone, or too slow to answer: its own leave timeout ends it
    if last:
        ray_tpu_torch.kill(g.coordinator)
