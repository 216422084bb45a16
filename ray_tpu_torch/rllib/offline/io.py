"""Offline sample IO: record rollouts, read them back for offline RL.

Reference: rllib/offline/ — OfflineData wraps ray.data to read
experience datasets (offline_data.py), output writers record rollouts
as JSON episodes (json_writer.py / offline_env_runner.py). Same design
here: episodes serialize to plain-JSON rows (one row per episode, lists
for arrays) and the reader rides the port's Data (ray_tpu_torch.data),
so offline training inherits the Data library's parallel reads,
shuffles, and streaming.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ...data.block import Block, build_block
from ...data.datasource import _FileDatasource
from ..env.episode import SingleAgentEpisode


def episodes_to_rows(episodes: List[SingleAgentEpisode]) -> List[Dict[str, Any]]:
    rows = []
    for ep in episodes:
        ep = ep.finalize()
        row = {
            "observations": np.asarray(ep.observations).tolist(),
            "actions": np.asarray(ep.actions).tolist(),
            "rewards": np.asarray(ep.rewards).tolist(),
            "terminated": bool(ep.is_terminated),
            "truncated": bool(ep.is_truncated),
        }
        for k, v in ep.extra_model_outputs.items():
            row[f"extra__{k}"] = np.asarray(v).tolist()
        rows.append(row)
    return rows


def _stacked(values, dtype=None) -> np.ndarray:
    """A row's list column as one array: a JSON list of lists, or the
    2-D array the port's Data stacks it into."""
    return np.asarray([np.asarray(v, dtype) for v in values], dtype)


def rows_to_episodes(rows: List[Dict[str, Any]]) -> List[SingleAgentEpisode]:
    eps = []
    for row in rows:
        obs = _stacked(row["observations"], np.float32)
        ep = SingleAgentEpisode(initial_observation=obs[0])
        actions = row["actions"]
        rewards = row["rewards"]
        extras = {
            k[len("extra__"):]: row[k] for k in row if k.startswith("extra__")
        }
        n = len(actions)
        for t in range(n):
            ep.add_env_step(
                obs[t + 1],
                np.asarray(actions[t]),
                float(rewards[t]),
                terminated=bool(row["terminated"]) and t == n - 1,
                truncated=bool(row["truncated"]) and t == n - 1,
                extra_model_outputs={
                    k: np.asarray(v[t]) for k, v in extras.items()
                },
            )
        eps.append(ep.finalize())
    return eps


class SampleWriter:
    """Append-only JSONL episode writer (reference: JsonWriter). Rolls
    to a new file every ``max_file_size`` bytes."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._f = None
        self._written = 0

    def _open(self):
        name = f"samples-{int(time.time() * 1000):x}-{os.getpid()}.jsonl"
        self._f = open(os.path.join(self.path, name), "w")
        self._written = 0

    def write(self, episodes: List[SingleAgentEpisode]) -> None:
        if self._f is None or self._written > self.max_file_size:
            if self._f:
                self._f.close()
            self._open()
        for row in episodes_to_rows(episodes):
            line = json.dumps(row)
            self._f.write(line + "\n")
            self._written += len(line) + 1
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class SampleReader:
    """Reads a JSONL sample dir directly (no cluster needed)."""

    def __init__(self, path: str, shuffle: bool = True,
                 seed: Optional[int] = None):
        self.files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(".jsonl")
        )
        if not self.files:
            raise FileNotFoundError(f"no .jsonl sample files under {path}")
        self._rng = np.random.default_rng(seed)
        self.shuffle = shuffle

    def read_all(self) -> List[SingleAgentEpisode]:
        rows = []
        for f in self.files:
            with open(f) as fh:
                rows.extend(json.loads(l) for l in fh if l.strip())
        return rows_to_episodes(rows)

    def iter_episodes(self, batch_size: int) -> Iterator[List[SingleAgentEpisode]]:
        """Infinite iterator of episode minibatches."""
        eps = self.read_all()
        while True:
            order = (
                self._rng.permutation(len(eps))
                if self.shuffle
                else np.arange(len(eps))
            )
            batch: List[SingleAgentEpisode] = []
            steps = 0
            for i in order:
                batch.append(eps[i])
                steps += len(eps[i])
                if steps >= batch_size:
                    yield batch
                    batch, steps = [], 0


class _EpisodeRowsDatasource(_FileDatasource):
    """SampleWriter's JSON lines, one row per line through the json
    module, so that an episode's columns are the same on every host
    (read_json's pyarrow types them by what it finds)."""

    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path) as f:
            yield build_block([json.loads(line) for line in f if line.strip()])


class OfflineData:
    """ray_tpu_torch.data-backed offline dataset (reference:
    rllib/offline/offline_data.py — wraps ray.data.read_json; here the
    port's read_datasource over _EpisodeRowsDatasource). Episodes stream
    through the Data library's parallel block reads; requires a running
    cluster."""

    def __init__(self, paths, *, parallelism: int = -1):
        import ray_tpu_torch.data as rdata

        if isinstance(paths, str) and os.path.isdir(paths):
            paths = [
                os.path.join(paths, f)
                for f in sorted(os.listdir(paths))
                if f.endswith(".jsonl") or f.endswith(".json")
            ]
        self.dataset = rdata.read_datasource(_EpisodeRowsDatasource(paths),
                                             parallelism=parallelism)

    def iter_episode_batches(
        self, *, batch_size: int
    ) -> Iterator[List[SingleAgentEpisode]]:
        """One pass over the dataset in episode minibatches of at least
        ``batch_size`` env steps."""
        batch: List[SingleAgentEpisode] = []
        steps = 0
        for row in self.dataset.iter_rows():
            (ep,) = rows_to_episodes([row])
            batch.append(ep)
            steps += len(ep)
            if steps >= batch_size:
                yield batch
                batch, steps = [], 0
        if batch:
            yield batch
