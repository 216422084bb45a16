"""Replay buffers for off-policy algorithms.

Reference: rllib/utils/replay_buffers/ — uniform ring buffer and
proportional prioritized replay (PER, sum-tree). Stored as flat numpy
column arrays so sampling produces a ready train batch with zero copies
beyond fancy-indexing.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros(
                    (self.capacity,) + v.shape[1:], v.dtype
                )
        for i in range(n):
            j = self._next
            for k, v in batch.items():
                self._cols[k][j] = v[i]
            self._on_add(j)
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def _on_add(self, idx: int) -> None:
        pass

    def add_episodes(self, episodes) -> None:
        from ..connectors.connector_v2 import EpisodesToBatch

        self.add_batch(EpisodesToBatch()(episodes=episodes))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx, priorities) -> None:
        pass


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER with a binary sum-tree (reference:
    prioritized_episode_buffer / segment trees)."""

    def __init__(
        self,
        capacity: int = 100_000,
        alpha: float = 0.6,
        beta: float = 0.4,
        eps: float = 1e-6,
        seed: Optional[int] = None,
    ):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        size = 1
        while size < capacity:
            size *= 2
        self._tree_size = size
        self._tree = np.zeros(2 * size, np.float64)
        self._max_priority = 1.0

    def _set_priority(self, idx: int, priority: float) -> None:
        i = idx + self._tree_size
        delta = priority - self._tree[i]
        while i >= 1:
            self._tree[i] += delta
            i //= 2

    def _on_add(self, idx: int) -> None:
        self._set_priority(idx, self._max_priority**self.alpha)

    def _sample_idx(self, mass: float) -> int:
        i = 1
        while i < self._tree_size:
            left = 2 * i
            if self._tree[left] >= mass:
                i = left
            else:
                mass -= self._tree[left]
                i = left + 1
        return i - self._tree_size

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        total = self._tree[1]
        masses = self._rng.random(batch_size) * total
        idx = np.array([self._sample_idx(m) for m in masses], np.int64)
        idx = np.clip(idx, 0, self._size - 1)
        probs = np.array(
            [self._tree[i + self._tree_size] / total for i in idx], np.float64
        )
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-self.beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indexes"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx, priorities) -> None:
        for i, p in zip(np.asarray(idx), np.asarray(priorities)):
            p = float(abs(p)) + self.eps
            self._max_priority = max(self._max_priority, p)
            self._set_priority(int(i), p**self.alpha)
