"""TuneController: the experiment event loop.

Reference: python/ray/tune/execution/tune_controller.py — `step` (:666)
schedules trial actors (:964), drains results, feeds searcher +
scheduler, checkpoints experiment state (:1691) and restores (:1791).
One actor per trial; PBT exploits restart the actor from the source
trial's checkpoint with a mutated config.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ..exceptions import RayActorError
from .schedulers import FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator, Searcher
from .trainable import _TrialActor

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class Trial:
    """Reference: tune/experiment/trial.py."""

    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    latest_checkpoint: Optional[str] = None
    best_checkpoint: Optional[str] = None
    best_score: Optional[float] = None
    error: Optional[str] = None
    num_failures: int = 0
    num_infra_failures: int = 0
    local_dir: str = ""

    def public_state(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "latest_checkpoint": self.latest_checkpoint,
            "best_checkpoint": self.best_checkpoint,
            "error": self.error,
        }


class TuneController:
    def __init__(
        self,
        trainable,
        *,
        param_space: Dict[str, Any],
        metric: Optional[str],
        mode: str = "max",
        search_alg: Optional[Searcher] = None,
        scheduler: Optional[TrialScheduler] = None,
        num_samples: int = 1,
        max_concurrent_trials: Optional[int] = None,
        stop: Optional[Dict[str, Any]] = None,
        max_failures: int = 0,
        infra_retries: int = 3,
        experiment_dir: str = "",
        poll_interval_s: float = 0.05,
    ):
        self.trainable = trainable
        self.metric = metric
        self.mode = mode
        self.stop_criteria = stop or {}
        self.max_failures = max_failures
        # Infra failures (the actor died: worker preempted/OOM-killed/
        # registration starved under load) retry on their OWN budget,
        # separate from user-code failures — a wedged host must not
        # convert healthy trials into ERROR results (reference: trial
        # actor restarts in tune/execution/ray_trial_executor; the
        # round-4 flakiness was exactly spurious actor loss under
        # contention surfacing as trial errors).
        self.infra_retries = infra_retries
        self.experiment_dir = experiment_dir
        os.makedirs(experiment_dir, exist_ok=True)
        # searcher; a user-supplied search_alg keeps its own settings.
        self.searcher = search_alg or BasicVariantGenerator(num_samples=num_samples)
        # Reference semantics (tune/tune.py): with an explicit
        # model-based searcher, num_samples caps total suggestions
        # (those searchers never self-exhaust). Queue-based searchers
        # (total_trials anywhere in the wrapper chain) encode their own
        # budget and must not be capped by the num_samples default.
        def _self_exhausting(s):
            while s is not None:
                if hasattr(s, "total_trials"):
                    return True
                s = getattr(s, "searcher", None)
            return False

        self._max_trials = (
            None if search_alg is None or _self_exhausting(search_alg)
            else num_samples
        )
        self.searcher.set_search_properties(metric, mode, param_space)
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_properties(metric, mode)
        if max_concurrent_trials is None:
            try:
                max_concurrent_trials = max(
                    1, int(ray_tpu_torch.cluster_resources().get("CPU", 2)) - 1
                )
            except Exception:
                max_concurrent_trials = 2
        self.max_concurrent = max_concurrent_trials
        self.poll_interval_s = poll_interval_s

        self.trials: List[Trial] = []
        self._actors: Dict[str, Any] = {}  # trial_id -> actor handle
        self._searcher_done = False

    # ------------------------------------------------------------ helpers

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def _new_trial(self):
        if self._max_trials is not None and len(self.trials) >= self._max_trials:
            return None
        trial_id = f"trial_{len(self.trials):04d}_{uuid.uuid4().hex[:6]}"
        cfg = self.searcher.suggest(trial_id)
        if cfg is None or cfg is Searcher.BACKOFF:
            return cfg  # None = exhausted; BACKOFF = retry next step
        t = Trial(
            trial_id=trial_id,
            config=cfg,
            local_dir=os.path.join(self.experiment_dir, trial_id),
        )
        self.trials.append(t)
        return t

    def _start_trial(self, trial: Trial,
                     checkpoint_path: Optional[str] = None) -> None:
        actor = _TrialActor.remote(trial.trial_id, trial.local_dir)
        actor.run.remote(self.trainable, trial.config, checkpoint_path,
                         self.stop_criteria)
        self._actors[trial.trial_id] = actor
        trial.status = RUNNING

    def _stop_trial_actor(self, trial: Trial) -> None:
        actor = self._actors.pop(trial.trial_id, None)
        if actor is not None:
            try:
                actor.stop.remote()
                ray_tpu_torch.kill(actor)
            except Exception:
                pass

    # ------------------------------------------------------- PBT exploit

    def exploit_trial(self, trial: Trial, source: Trial,
                      new_config: Dict[str, Any]) -> None:
        """Restart `trial` from `source`'s checkpoint with a mutated
        config (reference: pbt.py _exploit)."""
        self._stop_trial_actor(trial)
        trial.config = new_config
        trial.latest_checkpoint = source.latest_checkpoint
        self._start_trial(trial, checkpoint_path=source.latest_checkpoint)

    # ---------------------------------------------------------- the loop

    def _handle_result(self, trial: Trial, metrics: Dict[str, Any],
                       ckpt_path: Optional[str]) -> None:
        metrics.setdefault("training_iteration",
                           len(trial.metrics_history) + 1)
        metrics.setdefault("trial_id", trial.trial_id)
        trial.last_result = metrics
        trial.metrics_history.append(metrics)
        if ckpt_path:
            trial.latest_checkpoint = ckpt_path
            if self.metric and self.metric in metrics:
                score = float(metrics[self.metric])
                signed = score if self.mode == "max" else -score
                if trial.best_score is None or signed > trial.best_score:
                    trial.best_score = signed
                    trial.best_checkpoint = ckpt_path
        self.searcher.on_trial_result(trial.trial_id, metrics)
        decision = self.scheduler.on_trial_result(self, trial, metrics)
        stop_now = decision == TrialScheduler.STOP
        for key, bound in self.stop_criteria.items():
            if key in metrics and metrics[key] >= bound:
                stop_now = True
        if stop_now and trial.status == RUNNING:
            self._stop_trial_actor(trial)
            trial.status = TERMINATED
            self.searcher.on_trial_complete(trial.trial_id, trial.last_result)

    def _handle_done(self, trial: Trial) -> None:
        self._stop_trial_actor(trial)
        trial.status = TERMINATED
        self.searcher.on_trial_complete(trial.trial_id, trial.last_result)
        self.scheduler.on_trial_complete(self, trial, trial.last_result)

    def _handle_error(self, trial: Trial, err: BaseException) -> None:
        trial.num_failures += 1
        if trial.num_failures <= self.max_failures:
            self._stop_trial_actor(trial)
            self._start_trial(trial, checkpoint_path=trial.latest_checkpoint)
            return
        self._stop_trial_actor(trial)
        trial.status = ERROR
        trial.error = repr(err)
        self.searcher.on_trial_complete(trial.trial_id, error=True)

    def _handle_infra_failure(self, trial: Trial, err: BaseException) -> None:
        """The trial's actor died without the trainable raising (worker
        preemption, OOM kill, a registration timeout under host load).
        Restart from the latest checkpoint on the infra budget; only a
        persistently failing environment errors the trial."""
        trial.num_infra_failures += 1
        if trial.num_infra_failures <= self.infra_retries:
            import sys

            sys.stderr.write(
                f"tune: trial {trial.trial_id} lost its actor "
                f"({err!r}); restarting "
                f"({trial.num_infra_failures}/{self.infra_retries})\n"
            )
            self._stop_trial_actor(trial)
            self._start_trial(trial, checkpoint_path=trial.latest_checkpoint)
            return
        self._stop_trial_actor(trial)
        trial.status = ERROR
        trial.error = repr(err)
        self.searcher.on_trial_complete(trial.trial_id, error=True)

    def step(self) -> bool:
        """One controller iteration; returns False when all trials are done
        (reference: TuneController.step :666)."""
        # 1. fill free slots
        running = [t for t in self.trials if t.status == RUNNING]
        while len(running) < self.max_concurrent and not self._searcher_done:
            pending = [t for t in self.trials if t.status == PENDING]
            trial = pending[0] if pending else self._new_trial()
            if trial is None:
                self._searcher_done = True
                break
            if trial is Searcher.BACKOFF:
                break  # limiter at capacity; retry next step
            if trial.status == PENDING:
                self._start_trial(trial, checkpoint_path=trial.latest_checkpoint)
                running.append(trial)

        if not running:
            return False

        # 2. poll all running actors for their next event; each poll is
        # pinned to the actor incarnation it was sent to so a mid-step
        # restart (PBT exploit, infra retry) never consumes — or
        # errors on — a stale ref from the killed predecessor.
        polls = {
            t.trial_id: (
                self._actors[t.trial_id],
                self._actors[t.trial_id].next_result.remote(
                    timeout=self.poll_interval_s
                ),
            )
            for t in running
            if t.trial_id in self._actors
        }
        for trial_id, (actor, ref) in polls.items():
            trial = self.get_trial(trial_id)
            if trial is None or trial.status != RUNNING:
                continue  # stopped mid-step (scheduler/PBT)
            if self._actors.get(trial_id) is not actor:
                continue  # restarted mid-step: stale poll
            try:
                kind, payload = ray_tpu_torch.get(ref)
            except RayActorError as e:
                self._handle_infra_failure(trial, e)
                continue
            if kind == "result":
                self._handle_result(trial, payload[0], payload[1])
            elif kind == "done":
                self._handle_done(trial)
            elif kind == "error":
                self._handle_error(trial, payload)
        self.save_experiment_state()
        return any(t.status in (PENDING, RUNNING) for t in self.trials) or (
            not self._searcher_done
        )

    def run(self) -> List[Trial]:
        while self.step():
            pass
        self.save_experiment_state()
        return self.trials

    # -------------------------------------------------- experiment state

    def _state_path(self) -> str:
        return os.path.join(self.experiment_dir, "experiment_state.json")

    def save_experiment_state(self) -> None:
        state = {
            "timestamp": time.time(),
            "metric": self.metric,
            "mode": self.mode,
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": {k: v for k, v in t.config.items()},
                    "status": t.status,
                    "last_result": t.last_result,
                    "metrics_history": t.metrics_history,
                    "latest_checkpoint": t.latest_checkpoint,
                    "best_checkpoint": t.best_checkpoint,
                    "error": t.error,
                    "local_dir": t.local_dir,
                }
                for t in self.trials
            ],
        }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, default=repr)
        os.replace(tmp, self._state_path())

    def restore_experiment_state(self) -> None:
        """Reload trial states; RUNNING trials are reset to PENDING and
        resume from their latest checkpoint (reference:
        tune_controller.py:1791 trial restore)."""
        with open(self._state_path()) as f:
            state = json.load(f)
        self.trials = []
        for ts in state["trials"]:
            t = Trial(
                trial_id=ts["trial_id"],
                config=ts["config"],
                status=ts["status"],
                last_result=ts["last_result"],
                metrics_history=ts.get("metrics_history", []),
                latest_checkpoint=ts.get("latest_checkpoint"),
                best_checkpoint=ts.get("best_checkpoint"),
                error=ts.get("error"),
                local_dir=ts.get("local_dir") or os.path.join(
                    self.experiment_dir, ts["trial_id"]
                ),
            )
            if t.status == RUNNING:
                t.status = PENDING
            self.trials.append(t)
        # Searcher alignment: drop one suggestion per existing trial.
        for t in self.trials:
            self.searcher.suggest(t.trial_id)
            if t.status in (TERMINATED, ERROR):
                self.searcher.on_trial_complete(
                    t.trial_id, t.last_result, error=t.status == ERROR
                )
