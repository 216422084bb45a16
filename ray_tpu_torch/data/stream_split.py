"""streaming_split: one dataset feeding N training workers in lockstep.

Reference: python/ray/data/_internal/iterator/stream_split_iterator.py —
a ``SplitCoordinator`` actor (:32,:128) runs the execution and serves
output splits to N consumers, with an epoch barrier so every consumer
sees the same epoch boundary. Each `DataIterator` handed to a Train
worker pulls its split's blocks from the coordinator actor.

The port's copy of ray_tpu/data/stream_split.py, on the port's runtime.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import ray_tpu_torch
from .iterator import DataIterator


@ray_tpu_torch.remote
class SplitCoordinator:
    """Runs one execution per epoch and serves N block streams."""

    def __init__(self, dataset, n: int, equal: bool):
        self._ds = dataset
        self._n = n
        self._equal = equal
        # epoch -> splits; kept until every rank fetched its split so a
        # fast rank starting epoch k+1 can't clobber a slow rank's epoch k.
        self._epochs: Dict[int, List[List[Tuple]]] = {}
        self._fetched: Dict[int, set] = {}
        self._lock = threading.Lock()

    def _start_epoch(self, epoch: int) -> List[List[Tuple]]:
        ds = self._ds.repartition(self._n) if self._equal else self._ds
        bundles = list(ds.iter_internal_ref_bundles())
        splits: List[List[Tuple]] = [[] for _ in range(self._n)]
        for i, b in enumerate(bundles):
            splits[i % self._n].append(b)
        return splits

    def get_split(self, rank: int, epoch: int) -> List[Tuple]:
        """First caller of an epoch triggers execution; every rank reads
        that same epoch's split exactly once."""
        with self._lock:
            if epoch not in self._epochs:
                self._epochs[epoch] = self._start_epoch(epoch)
                self._fetched[epoch] = set()
            split = self._epochs[epoch][rank]
            self._fetched[epoch].add(rank)
            if len(self._fetched[epoch]) == self._n:
                del self._epochs[epoch]
                del self._fetched[epoch]
            # Bound retention: if a rank died / stopped iterating, old
            # epochs would otherwise pin their ref bundles forever.
            for old in [e for e in self._epochs if e < epoch - 1]:
                del self._epochs[old]
                del self._fetched[old]
            return split


class SplitDataIterator(DataIterator):
    def __init__(self, coordinator, rank: int):
        self._coord = coordinator
        self._rank = rank
        self._epoch = -1

        def make_bundles():
            self._epoch += 1
            bundles = ray_tpu_torch.get(
                self._coord.get_split.remote(self._rank, self._epoch)
            )
            return iter(bundles)

        super().__init__(make_bundles, world_rank=rank)


def make_streaming_splits(dataset, n: int, *, equal: bool = True
                          ) -> List[SplitDataIterator]:
    coord = SplitCoordinator.remote(dataset, n, equal)
    return [SplitDataIterator(coord, i) for i in range(n)]
