"""Queue-length autoscaling (reference:
serve/_private/autoscaling_state.py AutoscalingStateManager:82 + default
policy serve/autoscaling_policy.py:85).

desired = ceil(total_requests / target_ongoing_requests) where
total_requests = mean over the look-back window of (sum of per-replica
ongoing) + (sum of per-handle queued). A scale decision is applied only
after it has persisted for upscale_delay_s / downscale_delay_s.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Optional, Tuple

from .common import DeploymentID


class _DeploymentAutoscaling:
    def __init__(self, config, current_target: int):
        self.config = config
        # (timestamp, value) series per source.
        self.replica_metrics: Dict[str, Deque[Tuple[float, float]]] = defaultdict(
            lambda: deque(maxlen=256)
        )
        self.handle_metrics: Dict[str, Deque[Tuple[float, float]]] = defaultdict(
            lambda: deque(maxlen=256)
        )
        self.target = current_target
        self._proposal: Optional[int] = None
        self._proposal_since: float = 0.0

    def record_replica(self, replica_id: str, ongoing: float, ts: float):
        self.replica_metrics[replica_id].append((ts, ongoing))

    def record_handle(self, handle_id: str, queued: float, ts: float):
        self.handle_metrics[handle_id].append((ts, queued))

    def _windowed_mean(self, series: Deque[Tuple[float, float]], now: float) -> float:
        lo = now - self.config.look_back_period_s
        vals = [v for (t, v) in series if t >= lo]
        return sum(vals) / len(vals) if vals else 0.0

    def _prune(self, now: float) -> None:
        """Drop series from replicas/handles gone longer than the
        look-back window (otherwise controller memory and per-tick work
        grow with replica churn forever)."""
        horizon = now - 2 * self.config.look_back_period_s
        for table in (self.replica_metrics, self.handle_metrics):
            dead = [
                k for k, s in table.items() if not s or s[-1][0] < horizon
            ]
            for k in dead:
                del table[k]

    def decide(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        self._prune(now)
        cfg = self.config
        total = sum(
            self._windowed_mean(s, now) for s in self.replica_metrics.values()
        ) + sum(self._windowed_mean(s, now) for s in self.handle_metrics.values())
        raw = math.ceil(total / max(cfg.target_ongoing_requests, 1e-9))
        if raw > self.target:
            desired = self.target + max(
                1, math.ceil((raw - self.target) * cfg.upscaling_factor)
            )
            delay = cfg.upscale_delay_s
        elif raw < self.target:
            desired = self.target - max(
                1, math.ceil((self.target - raw) * cfg.downscaling_factor)
            )
            delay = cfg.downscale_delay_s
        else:
            self._proposal = None
            return self.target
        desired = cfg.bound(desired)
        if desired == self.target:
            self._proposal = None
            return self.target
        if self._proposal is None or (desired > self.target) != (
            self._proposal > self.target
        ):
            self._proposal = desired
            self._proposal_since = now
            return self.target
        # Same direction pending: apply once the delay has elapsed; take
        # the latest magnitude.
        if now - self._proposal_since >= delay:
            self.target = desired
            self._proposal = None
        else:
            self._proposal = desired
        return self.target


class AutoscalingStateManager:
    def __init__(self):
        self._states: Dict[DeploymentID, _DeploymentAutoscaling] = {}

    def register(self, dep_id: DeploymentID, config, current_target: int):
        state = self._states.get(dep_id)
        if state is None or state.config != config:
            state = _DeploymentAutoscaling(config, current_target)
            self._states[dep_id] = state

    def deregister(self, dep_id: DeploymentID):
        self._states.pop(dep_id, None)

    def record_replica(self, dep_id: DeploymentID, replica_id, ongoing, ts):
        if dep_id in self._states:
            self._states[dep_id].record_replica(replica_id, ongoing, ts)

    def record_handle(self, dep_id: DeploymentID, handle_id, queued, ts):
        if dep_id in self._states:
            self._states[dep_id].record_handle(handle_id, queued, ts)

    def get_decision(self, dep_id: DeploymentID) -> Optional[int]:
        state = self._states.get(dep_id)
        return state.decide() if state else None
