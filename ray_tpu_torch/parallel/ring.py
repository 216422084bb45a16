"""The neighbour exchange of ring attention and the pipeline on
torch.distributed.

`ring_shift` is the reference's `lax.ppermute(x, axis, [(i, i + 1) % n])`
(`ray_tpu/ops/ring_attention.py:135-136`): every rank of a group sends
its tensors to the next rank and receives the previous rank's. All sends
and receives of one shift go into a single `dist.batch_isend_irecv`, so
no order of posting can deadlock, at n = 2 too.

`start_shift` posts a shift and returns at once; its `wait()` gives the
received tensors. Ring attention posts the next block's k/v before it
computes the current block, so that the exchange runs beside the kernels,
as XLA may schedule the reference's `ppermute`.

The transport is chosen by the group's backend, never by catching a
failure:

- NCCL sends CUDA tensors as they are (one rank per card);
- gloo sends CPU tensors as they are; CUDA tensors go through pinned host
  buffers (gloo has no point-to-point of CUDA tensors). This is how
  several ranks share one card, where NCCL refuses two ranks on a card.
  The copy to the host waits for the work queued before it on the
  device; gloo's transfer then runs on its own threads.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def host_staged(group, t: torch.Tensor) -> bool:
    """Whether `t` must go through host memory to be sent over `group`:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class Shift:
    """A posted `start_shift`; `wait()` returns the received tensors. It
    holds the send buffers until then."""

    def __init__(self, tensors, works=(), sends=None, recvs=None, staged=None):
        self._tensors, self._works = list(tensors), list(works)
        self._sends, self._recvs, self._staged = sends, recvs, staged

    def wait(self) -> List[torch.Tensor]:
        if self._recvs is None:
            return self._tensors
        for work in self._works:
            work.wait()
        return [buf.to(t.device, non_blocking=True) if stage else buf
                for t, buf, stage in zip(self._tensors, self._recvs, self._staged)]


def start_shift(tensors: Sequence[torch.Tensor], group, *, reverse: bool = False) -> Shift:
    """Posts the sends of each tensor to rank (r + 1) % n of `group` and
    the receives of those rank (r - 1) % n sends (with `reverse`, to
    (r - 1) % n and from (r + 1) % n); `wait()` returns them as new
    tensors of the same shapes, dtypes and devices. The tensors must not
    change until then. With one rank, `wait()` returns the tensors as
    they are."""
    n = dist.get_world_size(group)
    if n == 1:
        return Shift(tensors)
    r = dist.get_rank(group)
    step = -1 if reverse else 1
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    staged = [host_staged(group, t) for t in tensors]
    sends, recvs = [], []
    for t, stage in zip(tensors, staged):
        t = t.contiguous()
        if stage:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            host.copy_(t)  # synchronous: the send reads it next
            sends.append(host)
            recvs.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda))
        else:
            sends.append(t)
            recvs.append(torch.empty_like(t))
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    return Shift(tensors, dist.batch_isend_irecv(ops), sends, recvs, staged)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """`start_shift(tensors, group).wait()`."""
    return start_shift(tensors, group).wait()
