"""LearnerGroup: local learner or a gang of learner actors.

Reference: rllib/core/learner/learner_group.py:74. num_learners=0 runs
the learner in-process, on the current card. num_learners=N spawns N
actors, each with `num_gpus_per_learner` GPUs (one when unset; its
learner then runs on its card; 0 asks for CPU learners), and for N > 1
wires an out-of-graph collective group for gradient averaging
(the reference's DDP equivalent). `shutdown` leaves that group before
the actors go, so its coordinator ends with the last learner.
"""
from __future__ import annotations

import pickle
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ...exceptions import GetTimeoutError, RayActorError

from .learner import Learner, LearnerActor


class LearnerGroup:
    def __init__(self, *, learner_cls, module_spec, config: Dict[str, Any]):
        self._config = dict(config)
        n = config.get("num_learners", 0)
        self._local: Optional[Learner] = None
        self._actors: List[Any] = []
        self.collective_group: Optional[str] = None
        if n == 0:
            self._local = learner_cls(module_spec=module_spec, config=config)
            self._local.build()
        else:
            gpus = _gpus_per_learner(config.get("num_gpus_per_learner"), n)
            blobs = (
                pickle.dumps(learner_cls),
                pickle.dumps(module_spec),
                pickle.dumps({**config, "num_gpus_per_learner": gpus}),
            )
            actor_cls = ray_tpu_torch.remote(LearnerActor).options(
                num_cpus=config.get("num_cpus_per_learner", 1),
                num_gpus=gpus,
            )
            self._actors = [actor_cls.remote(*blobs) for _ in range(n)]
            if n > 1:
                group = self.collective_group = f"learners-{uuid.uuid4().hex[:6]}"
                ray_tpu_torch.get(
                    [
                        a.setup_collective.remote(group, n, rank)
                        for rank, a in enumerate(self._actors)
                    ]
                )
            # Align initial weights (each actor seeded identically, but
            # make it explicit).
            if n > 1:
                w = ray_tpu_torch.get(self._actors[0].get_weights.remote())
                ref = ray_tpu_torch.put(w)
                ray_tpu_torch.get([a.set_weights.remote(ref) for a in self._actors[1:]])

    @property
    def is_local(self) -> bool:
        return self._local is not None

    # ------------------------------------------------------------ update
    def update_from_episodes(self, episodes) -> Dict[str, Any]:
        if self._local is not None:
            batch = self._local.build_batch(episodes)  # type: ignore[attr-defined]
            return self._local.update(batch)
        n = len(self._actors)
        shards = [episodes[i::n] for i in range(n)]
        refs = [
            a.update_from_episodes.remote(shard)
            for a, shard in zip(self._actors, shards)
            if shard
        ]
        results = ray_tpu_torch.get(refs)
        return _mean_metrics(results)

    def update_from_batch(self, batch) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.update(batch)
        n = len(self._actors)
        size = len(next(iter(batch.values())))
        per = max(1, size // n)
        refs = []
        for i, a in enumerate(self._actors):
            lo, hi = i * per, (i + 1) * per if i < n - 1 else size
            if lo >= size:
                break
            refs.append(a.update.remote({k: v[lo:hi] for k, v in batch.items()}))
        return _mean_metrics(ray_tpu_torch.get(refs))

    # ----------------------------------------------------------- weights
    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def set_weights(self, weights):
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ref = ray_tpu_torch.put(weights)
            ray_tpu_torch.get([a.set_weights.remote(ref) for a in self._actors])

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._actors[0].get_state.remote())

    def set_state(self, state):
        if self._local is not None:
            self._local.set_state(state)
        else:
            ref = ray_tpu_torch.put(state)
            ray_tpu_torch.get([a.set_state.remote(ref) for a in self._actors])

    def shutdown(self):
        try:
            if len(self._actors) > 1:
                ray_tpu_torch.get([a.leave_collective.remote() for a in self._actors],
                                  timeout=120)
        except (RayActorError, GetTimeoutError):
            pass  # a learner that never leaves: the coordinator times out
        finally:
            for a in self._actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # noqa: BLE001
                    pass
            self._actors = []


def _gpus_per_learner(gpus, num_learners: int):
    """The GPUs each learner actor asks for: `gpus` where the caller set
    it, else one card each. Unset on a cluster without a card apiece, it
    raises rather than queue the actors forever or train on the CPU."""
    if gpus is not None:
        return gpus
    have = ray_tpu_torch.cluster_resources().get("GPU", 0)
    if have < num_learners:
        raise ValueError(
            f"{num_learners} learner(s) take a card each, and the cluster has "
            f"{have:g}; pass num_gpus_per_learner=0 to train on the CPU"
        )
    return 1


def _mean_metrics(results: List[Dict[str, Any]]) -> Dict[str, Any]:
    import numpy as np

    if not results:
        return {}
    return {
        k: float(np.mean([r[k] for r in results if k in r]))
        for k in results[0]
    }
