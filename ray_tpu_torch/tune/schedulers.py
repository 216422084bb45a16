"""Trial schedulers: early stopping + population based training.

Reference: python/ray/tune/schedulers/ — FIFOScheduler (trial_scheduler.py),
ASHA (async_hyperband.py), MedianStoppingRule (median_stopping_rule.py),
PopulationBasedTraining (pbt.py). Decisions are returned to the
TuneController on every reported result.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

import numpy as np


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"

    def set_properties(self, metric: str, mode: str) -> None:
        self.metric = metric
        self.mode = mode

    def on_trial_result(self, controller, trial, result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, controller, trial, result) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung is stopped
    unless it is in the top 1/reduction_factor of results recorded there."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: float = 4,
                 max_t: int = 100):
        self.time_attr = time_attr
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._rungs: Dict[int, List[float]] = {}
        self._trial_rungs: Dict[str, set] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(int(t))
            t *= reduction_factor
        self._milestones = milestones

    def _score(self, result) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return self.CONTINUE
        reached = self._trial_rungs.setdefault(trial.trial_id, set())
        for m in self._milestones:
            # >= not ==: a trial reporting every k iterations must still be
            # evaluated at rungs it jumps over.
            if t >= m and m not in reached:
                reached.add(m)
                rung = self._rungs.setdefault(m, [])
                rung.append(score)
                cutoff = np.percentile(rung, (1 - 1 / self.rf) * 100)
                if score < cutoff:
                    return self.STOP
        if t >= self.max_t:
            return self.STOP
        return self.CONTINUE


# Reference alias (ray.tune.schedulers.ASHAScheduler)
ASHAScheduler = AsyncHyperBandScheduler


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average is worse than the median of
    completed averages at the same step (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._histories: Dict[str, List[float]] = {}

    def _signed(self, result) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._signed(result)
        if score is None:
            return self.CONTINUE
        hist = self._histories.setdefault(trial.trial_id, [])
        hist.append(score)
        if t <= self.grace:
            return self.CONTINUE
        others = [
            float(np.mean(h))
            for tid, h in self._histories.items()
            if tid != trial.trial_id and len(h) > 0
        ]
        if len(others) < self.min_samples:
            return self.CONTINUE
        if float(np.mean(hist)) < float(np.median(others)):
            return self.STOP
        return self.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): every
    ``perturbation_interval`` steps, bottom-quantile trials clone the
    checkpoint of a top-quantile trial and continue with mutated
    hyperparameters (exploit + explore)."""

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: Optional[int] = None):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}

    def _signed(self, result):
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .search import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                new[key] = self._rng.choice(spec)
            elif isinstance(spec, Domain):
                new[key] = spec.sample(self._rng)
            elif callable(spec):
                new[key] = spec()
            elif key in new and isinstance(new[key], (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                new[key] = type(new[key])(new[key] * factor)
        return new

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._signed(result)
        if score is not None:
            self._scores[trial.trial_id] = score
        if t - self._last_perturb.get(trial.trial_id, 0) < self.interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        if len(self._scores) < 2:
            return self.CONTINUE
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        k = max(1, int(len(ranked) * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id in bottom and top:
            src_id = self._rng.choice(top)
            src = controller.get_trial(src_id)
            if src is not None and src.latest_checkpoint is not None:
                new_config = self._mutate(src.config)
                controller.exploit_trial(trial, src, new_config)
        return self.CONTINUE
