"""FaultTolerantActorManager: keep a fleet of actors useful through
failures.

Reference: rllib/utils/actor_manager.py:196 — calls fan out to healthy
actors; an actor that raises a system error is marked unhealthy and
restarted (here: re-created from its factory), and results from the
dead actor are dropped rather than failing the caller.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError


class FaultTolerantActorManager:
    def __init__(self, actor_factory: Callable[[int], Any], num_actors: int):
        self._factory = actor_factory
        self._actors: Dict[int, Any] = {
            i: actor_factory(i) for i in range(num_actors)
        }
        self._restarts = 0

    @property
    def num_actors(self) -> int:
        return len(self._actors)

    @property
    def num_restarts(self) -> int:
        return self._restarts

    def healthy_actor_ids(self) -> List[int]:
        return sorted(self._actors)

    def actor(self, i: int):
        return self._actors[i]

    def foreach_actor(
        self,
        fn_name: str,
        *args,
        kwargs_per_actor: Optional[Dict[int, dict]] = None,
        # Liveness bound, not a perf assertion: a restarted actor builds
        # its envs and module afresh, which on a contended host can take
        # minutes.
        timeout: Optional[float] = 600.0,
        **kwargs,
    ) -> List[Tuple[int, Any]]:
        """Call ``actor.<fn_name>(*args)`` on every actor; returns
        [(actor_id, result)] for the calls that succeeded, restarting
        actors that died."""
        refs = {}
        for i, actor in self._actors.items():
            kw = dict(kwargs)
            kw.update((kwargs_per_actor or {}).get(i, {}))
            refs[i] = getattr(actor, fn_name).remote(*args, **kw)
        results = []
        for i, ref in refs.items():
            try:
                results.append((i, ray_tpu_torch.get(ref, timeout=timeout)))
            except (RayActorError, WorkerCrashedError):
                self._restart(i)
            except Exception:
                raise
        return results

    def _restart(self, i: int):
        self._restarts += 1
        try:
            ray_tpu_torch.kill(self._actors[i])
        except Exception:  # noqa: BLE001
            pass
        self._actors[i] = self._factory(i)

    def shutdown(self):
        for actor in self._actors.values():
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001
                pass
        self._actors.clear()
