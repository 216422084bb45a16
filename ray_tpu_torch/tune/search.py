"""Search spaces + search algorithms.

Reference: python/ray/tune/search/ — sample domains
(tune/search/sample.py: Categorical/Float/Integer, grid_search),
BasicVariantGenerator (tune/search/basic_variant.py) doing grid
cartesian expansion x num_samples random resolution, the Searcher
interface (tune/search/searcher.py) and ConcurrencyLimiter
(tune/search/concurrency_limiter.py).
"""
from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np


# ------------------------------------------------------------------ domains

class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Float(Domain):
    def __init__(self, lower, upper, log=False, q=None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.lower), np.log(self.upper))))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn({})
        except TypeError:
            return self.fn()


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def randn(mean: float = 0.0, sd: float = 1.0) -> Function:
    return Function(lambda: random.gauss(mean, sd))


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values) -> Dict[str, Any]:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, GridSearch) or (
        isinstance(v, dict) and set(v.keys()) == {"grid_search"}
    )


def _grid_values(v):
    return v.values if isinstance(v, GridSearch) else v["grid_search"]


def resolve_config(space: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    """Sample every Domain leaf; grid leaves must be pre-resolved."""
    out = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict) and not _is_grid(v):
            out[k] = resolve_config(v, rng)
        elif _is_grid(v):
            raise ValueError("unexpanded grid_search leaf")
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------- searchers

class Searcher:
    """Reference: tune/search/searcher.py:Searcher."""

    #: suggest() sentinel: no config available *right now*, retry later
    #: (vs. None = search space exhausted, stop creating trials).
    BACKOFF = "__backoff__"

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric, mode, space) -> None:
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        self._space = space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result=None, error=False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cartesian product x num_samples random draws (reference:
    tune/search/basic_variant.py)."""

    def __init__(self, num_samples: int = 1, seed: Optional[int] = None,
                 points_to_evaluate: Optional[List[Dict]] = None):
        super().__init__()
        self.num_samples = num_samples
        self._rng = random.Random(seed)
        self._points = list(points_to_evaluate or [])
        self._queue: Optional[List[Dict[str, Any]]] = None

    def set_search_properties(self, metric, mode, space) -> None:
        super().set_search_properties(metric, mode, space)
        grid_keys = [k for k, v in space.items() if _is_grid(v)]
        grids = [_grid_values(space[k]) for k in grid_keys]
        variants: List[Dict[str, Any]] = []
        combos = itertools.product(*grids) if grid_keys else [()]
        for combo in combos:
            base = dict(space)
            for k, val in zip(grid_keys, combo):
                base[k] = val
            variants.append(base)
        self._queue = []
        for point in self._points:
            # Unpinned grid keys resolve to their first value so the
            # config stays complete.
            merged = {
                k: (_grid_values(v)[0] if _is_grid(v) else v)
                for k, v in space.items()
            }
            merged.update(point)
            self._queue.append(resolve_config(merged, self._rng))
        for _ in range(self.num_samples):
            for v in variants:
                self._queue.append(resolve_config(v, self._rng))

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._queue:
            return None
        return self._queue.pop(0)

    @property
    def total_trials(self) -> Optional[int]:
        return len(self._queue) if self._queue is not None else None


class ConcurrencyLimiter(Searcher):
    """Reference: tune/search/concurrency_limiter.py."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, space) -> None:
        super().set_search_properties(metric, mode, space)
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return Searcher.BACKOFF  # controller retries next step
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg is not Searcher.BACKOFF:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class OptunaSearch(Searcher):
    """Optuna TPE adapter (reference: tune/search/optuna/optuna_search.py).
    Gated: raises at construction if optuna is unavailable in this image."""

    def __init__(self, metric=None, mode=None, seed: Optional[int] = None):
        super().__init__(metric, mode)
        try:
            import optuna  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "OptunaSearch requires the `optuna` package"
            ) from e
        import optuna

        self._optuna = optuna
        sampler = optuna.samplers.TPESampler(seed=seed)
        self._study = optuna.create_study(
            direction=None, sampler=sampler,
            directions=None,
        )
        self._trials: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str):
        ot = self._study.ask()
        self._trials[trial_id] = ot
        cfg = {}
        for k, v in self._space.items():
            if isinstance(v, Categorical):
                cfg[k] = ot.suggest_categorical(k, v.categories)
            elif isinstance(v, Float):
                cfg[k] = ot.suggest_float(k, v.lower, v.upper, log=v.log)
            elif isinstance(v, Integer):
                cfg[k] = ot.suggest_int(k, v.lower, v.upper - 1)
            else:
                cfg[k] = v
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        if error or result is None or self.metric not in result:
            self._study.tell(ot, state=self._optuna.trial.TrialState.FAIL)
            return
        value = result[self.metric]
        if self.mode == "max":
            value = -value  # study minimizes
        self._study.tell(ot, value)
