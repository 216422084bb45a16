"""Tuner: the public entry point.

Reference: python/ray/tune/tuner.py (Tuner.fit → TuneController) and
tune/result_grid.py (ResultGrid). `Tuner(trainer)` wraps a Train
trainer the same way the reference's BaseTrainer.as_trainable does
(train/base_trainer.py:819): each trial runs a full `fit()` with the
trial config merged into train_loop_config.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..train.checkpoint import Checkpoint
from ..train.config import Result, RunConfig
from .schedulers import TrialScheduler
from .search import Searcher
from .tune_controller import ERROR, TERMINATED, Trial, TuneController


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None


class ResultGrid:
    """Reference: tune/result_grid.py."""

    def __init__(self, trials, metric, mode):
        self._trials = list(trials)
        self._metric = metric
        self._mode = mode
        self.results = [
            Result(
                metrics=t.last_result or None,
                checkpoint=Checkpoint(t.best_checkpoint or t.latest_checkpoint)
                if (t.best_checkpoint or t.latest_checkpoint) else None,
                error=RuntimeError(t.error) if t.error else None,
                path=t.local_dir,
                metrics_history=t.metrics_history,
                config=dict(t.config),
            )
            for t in self._trials
        ]

    def __len__(self):
        return len(self.results)

    def __getitem__(self, i):
        return self.results[i]

    @property
    def errors(self):
        return [r.error for r in self.results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [
            r for r in self.results
            if r.metrics and metric in r.metrics
        ]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self.results if r.metrics])


def _default_experiment_dir(name: Optional[str],
                            storage_path: Optional[str]) -> str:
    base = storage_path or os.path.join(
        os.environ.get("RAY_TPU_TORCH_RESULTS_DIR",
                       os.path.expanduser("~/ray_tpu_torch_results"))
    )
    return os.path.join(base, name or "tune_experiment")


class Tuner:
    def __init__(
        self,
        trainable=None,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restore_path: Optional[str] = None,
    ):
        from ..train.trainer import TorchTrainer

        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._param_space = dict(param_space or {})
        if isinstance(trainable, TorchTrainer):
            # trial config is merged into the trainer's train_loop_config
            self._trainable = _trainer_to_trainable(trainable)
        else:
            self._trainable = trainable
        self._restore_path = _restore_path

    @classmethod
    def restore(
        cls,
        path: str,
        trainable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ) -> "Tuner":
        """Resume an interrupted experiment from its state file
        (reference: Tuner.restore). param_space/tune_config/run_config
        must match the original run; pass them again so restored
        PENDING trials keep their search space, metric, and stop
        criteria."""
        return cls(
            trainable,
            param_space=param_space,
            tune_config=tune_config,
            run_config=run_config,
            _restore_path=path,
        )

    def fit(self) -> ResultGrid:
        exp_dir = self._restore_path or _default_experiment_dir(
            self._run_config.name, self._run_config.storage_path
        )
        stop = getattr(self._run_config, "stop", None)
        controller = TuneController(
            self._trainable,
            param_space=self._param_space,
            metric=self._tune_config.metric,
            mode=self._tune_config.mode,
            search_alg=self._tune_config.search_alg,
            scheduler=self._tune_config.scheduler,
            num_samples=self._tune_config.num_samples,
            max_concurrent_trials=self._tune_config.max_concurrent_trials,
            stop=stop,
            max_failures=self._run_config.failure_config.max_failures,
            infra_retries=self._run_config.failure_config.infra_retries,
            experiment_dir=exp_dir,
        )
        if self._restore_path and os.path.exists(
            os.path.join(exp_dir, "experiment_state.json")
        ):
            controller.restore_experiment_state()
        trials = controller.run()
        return ResultGrid(trials, self._tune_config.metric,
                          self._tune_config.mode)


def _trainer_to_trainable(trainer):
    """Each trial re-runs the trainer with the trial config merged into
    train_loop_config (reference: base_trainer.py as_trainable :819)."""

    def trainable(config: Dict[str, Any]):
        import copy

        from ..train import session as train_session

        t = copy.copy(trainer)
        loop_config = dict(t._config or {})
        loop_config.update(config)
        t._config = loop_config
        outer = train_session.get_session()
        result = t.fit()
        # fit() consumed the inner session; re-report the final metrics to
        # the trial's session so Tune sees them.
        if outer is not None:
            train_session._session = outer
        if result.error:
            raise result.error
        if result.metrics:
            train_session.report(result.metrics, checkpoint=result.checkpoint)

    return trainable


def run(trainable, *, param_space=None, config=None, metric=None, mode="max",
        num_samples=1, search_alg=None, scheduler=None, stop=None,
        name=None, storage_path=None, max_concurrent_trials=None) -> ResultGrid:
    """Functional entry point (reference: tune.run)."""
    run_config = RunConfig(name=name, storage_path=storage_path)
    run_config.stop = stop  # type: ignore[attr-defined]
    return Tuner(
        trainable,
        param_space=param_space or config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples,
            search_alg=search_alg, scheduler=scheduler,
            max_concurrent_trials=max_concurrent_trials,
        ),
        run_config=run_config,
    ).fit()
