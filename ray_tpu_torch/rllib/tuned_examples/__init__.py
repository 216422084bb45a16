"""Tuned-example regression configs: declarative pass/fail bars.

Reference: rllib/tuned_examples/ — per-algorithm YAML configs with a
``stop`` block that doubles as the CI pass criterion ("this algorithm
must reach return X on env Y within budget Z"). The runner here loads
a config, builds the algorithm through the same public config API a
user would, trains until the stop criteria are met (pass) or the
budget runs out (fail), and reports the trajectory — so every algo's
learning behavior is pinned by data, not by hand-written test code.

Config schema (YAML)::

    algorithm: PPO                # class name in the port's rllib.algorithms
    env: CartPole-v1
    stop:
      episode_return_mean: 400.0  # pass when reached
    max_iterations: 40            # fail if not reached by then
    config:                       # AlgorithmConfig section calls
      env_runners: {num_env_runners: 0, num_envs_per_env_runner: 8}
      training: {lr: 0.0003, train_batch_size: 2000}
      debugging: {seed: 0}
"""
from __future__ import annotations

import glob
import importlib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_ALGO_MODULES = {
    "PPO": "ppo",
    "DQN": "dqn",
    "IMPALA": "impala",
    "APPO": "appo",
    "SAC": "sac",
    "CQL": "cql",
    "MARWIL": "marwil",
    "BC": "marwil",
    "DreamerV3": "dreamerv3",
}

EXAMPLES_DIR = os.path.dirname(__file__)


def list_examples() -> List[str]:
    return sorted(glob.glob(os.path.join(EXAMPLES_DIR, "*.yaml")))


@dataclass
class RegressionResult:
    name: str
    passed: bool
    iterations: int
    best: Dict[str, float]
    history: List[Dict[str, float]] = field(default_factory=list)


def _config_for(spec: Dict[str, Any], extra: Optional[Dict[str, Any]] = None):
    algo_name = spec["algorithm"]
    mod = importlib.import_module(
        f"..algorithms.{_ALGO_MODULES[algo_name]}", __name__
    )
    cfg = getattr(mod, f"{algo_name}Config")()
    cfg.environment(spec["env"])
    for sections in (spec.get("config") or {}, extra or {}):
        for section, kwargs in sections.items():
            getattr(cfg, section)(**kwargs)
    return cfg


def _metric_value(result: Dict[str, Any], dotted: str) -> Optional[float]:
    cur: Any = result
    for part in dotted.split("/"):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    try:
        return float(cur)
    except (TypeError, ValueError):
        return None


def run_regression(path: str, *, config: Optional[Dict[str, Any]] = None) -> RegressionResult:
    """Train one example to its stop criteria; pass/fail by the bar.
    `config`: more section calls, applied after the file's (for example
    ``{"learners": {"num_gpus_per_learner": 0}}`` to learn on the CPU)."""
    import numpy as np
    import yaml

    with open(path) as f:
        spec = yaml.safe_load(f)
    stop: Dict[str, float] = spec["stop"]
    max_iters = int(spec.get("max_iterations", 100))
    algo = _config_for(spec, config).build()
    history: List[Dict[str, float]] = []
    best: Dict[str, float] = {}
    passed = False
    it = 0
    try:
        for it in range(1, max_iters + 1):
            result = algo.train()
            snap = {}
            for metric in stop:
                v = _metric_value(result, metric)
                if v is not None and np.isfinite(v):
                    snap[metric] = v
                    best[metric] = max(best.get(metric, -np.inf), v)
            history.append(snap)
            if stop and all(
                best.get(m, -np.inf) >= bar for m, bar in stop.items()
            ):
                passed = True
                break
    finally:
        algo.stop()
    return RegressionResult(
        name=os.path.basename(path),
        passed=passed,
        iterations=it,
        best=best,
        history=history,
    )
