"""Batch iteration: rebatch blocks into fixed-size batches with prefetch,
and place numpy batches on a CUDA card as torch tensors.

Reference: python/ray/data/iterator.py (DataIterator.iter_batches :105,
iter_torch_batches :261) and the batcher in
data/_internal/block_batching/; and this repo's ray_tpu/data/iterator.py,
whose device edge is ``jax.device_put``. Here each column is copied once
into pinned host memory and from there to the card with a
``non_blocking`` copy on the current stream: like ``jax.device_put``,
``to_device`` returns before the transfer ends, and kernels that the
caller enqueues after it on the same stream see the data.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from .block import BlockAccessor, build_block, concat_blocks


def iter_batches_over_bundles(bundles, *, batch_size: Optional[int],
                              batch_format: str = "numpy",
                              drop_last: bool = False,
                              prefetch_blocks: int = 1):
    """Fetch blocks with a sliding prefetch window and slice into batches."""

    def fetched_blocks():
        window: deque = deque()
        for ref, _meta in bundles:
            window.append(ref)
            if len(window) > prefetch_blocks:
                yield ray_tpu_torch.get(window.popleft())
        while window:
            yield ray_tpu_torch.get(window.popleft())

    carry = None  # leftover rows, a numpy block
    for block in fetched_blocks():
        t = build_block(block)
        if carry is not None:
            t = concat_blocks([carry, t])
            carry = None
        acc = BlockAccessor(t)
        n = acc.num_rows()
        if batch_size is None:
            if n:
                yield acc.to_batch(batch_format)
            continue
        start = 0
        while n - start >= batch_size:
            piece = acc.slice(start, start + batch_size)
            start += batch_size
            yield BlockAccessor(piece).to_batch(batch_format)
        if start < n:
            carry = acc.slice(start, n)
    if carry is not None and not drop_last:
        yield BlockAccessor(carry).to_batch(batch_format)


def _column_to_device(name: str, col: np.ndarray, device, dtype):
    import torch

    if col.dtype == object:
        raise TypeError(
            f"column {name!r} holds Python objects, which have no torch dtype"
        )
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, col.dtype)).dtype
    pin = device.type == "cuda"
    # One host copy, cast on the way, into pinned memory on the way to a
    # card: the block's arrays may be read-only views of the object
    # store's shared memory, and a non_blocking copy is asynchronous only
    # from pinned memory and only without a cast.
    host = torch.empty(col.shape, dtype=dtype, pin_memory=pin)
    try:
        host.numpy()[...] = col
    except TypeError:  # a dtype numpy lacks (bfloat16): cast in torch
        host.copy_(torch.from_numpy(np.array(col)))
    return host.to(device, non_blocking=pin)


def to_device(batch: Dict[str, np.ndarray], *, device=None, dtypes=None,
              sharding=None) -> Dict[str, Any]:
    """A numpy batch as torch tensors on `device`: the current CUDA card
    when None (raising without one), or e.g. "cpu". `dtypes` is a torch
    dtype for every column or a dict from column to dtype (columns it
    leaves out keep theirs). With `sharding`, a device mesh of
    `parallel.mesh`, each [B, T, ...] column is cut to this rank's block
    as `parallel.step.shard_batch` cuts ids and targets, before its copy."""
    from .._device import resolve_device

    device = resolve_device(device)
    out = {}
    for name, col in batch.items():
        if sharding is not None:
            from ..parallel.step import batch_slices

            col = col[batch_slices(col.shape, sharding)]
        dtype = dtypes.get(name) if isinstance(dtypes, dict) else dtypes
        out[name] = _column_to_device(name, col, device, dtype)
    return out


class DataIterator:
    """A re-iterable handle over a dataset shard (reference: DataIterator)."""

    def __init__(self, make_bundles, world_rank: Optional[int] = None):
        self._make_bundles = make_bundles
        self.world_rank = world_rank

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     prefetch_batches: int = 1):
        return iter_batches_over_bundles(
            self._make_bundles(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch_blocks=max(1, prefetch_batches),
        )

    def iter_rows(self):
        for ref, _ in self._make_bundles():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(ref)).iter_rows()

    def iter_torch_batches(self, *, batch_size: int = 256, drop_last: bool = True,
                           device=None, dtypes=None, sharding=None):
        """Batches of `batch_size` rows as torch tensors (`to_device`)."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            yield to_device(batch, device=device, dtypes=dtypes,
                            sharding=sharding)

    def materialize(self):
        from .dataset import MaterializedDataset

        return MaterializedDataset(list(self._make_bundles()))
