"""Native model-based searchers: TPE, BOHB, Repeater.

Reference: python/ray/tune/search/hyperopt/hyperopt_search.py (TPE via
the hyperopt package), tune/search/bohb/ (TuneBOHB via hpbandster),
tune/search/repeater.py. Those adapters wrap external packages this
image doesn't carry; here the algorithms are implemented natively on
the same Searcher interface:

- ``TPESearch``: Tree-structured Parzen Estimator (Bergstra et al.,
  NeurIPS 2011). Observations split into good/bad by the gamma
  quantile of the objective; each dimension gets a kernel-density
  ("Parzen") model l(x) of the good points and g(x) of the bad, and
  candidates sampled from l are ranked by l(x)/g(x).
- ``BOHBSearch``: BOHB's model-based half (Falkner et al., ICML 2018):
  a TPE model per fidelity (training_iteration), always using the
  HIGHEST budget that has enough observations; pairs with the ASHA /
  HyperBand schedulers for the bandit half.
- ``Repeater``: evaluates every suggested config k times and reports
  the mean metric to the wrapped searcher (noisy objectives).
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from .search import Categorical, Domain, Float, Integer, Searcher, resolve_config


class _ParzenDim:
    """Per-dimension kernel density over observed values, mixed with a
    uniform prior so unexplored regions keep probability mass."""

    def __init__(self, domain: Domain):
        self.domain = domain

    # ------------------------------------------------------------ float
    def _bounds(self):
        d = self.domain
        if isinstance(d, Float) and d.log:
            return math.log(d.lower), math.log(d.upper)
        return float(d.lower), float(d.upper)

    def _to_unit(self, v: float) -> float:
        lo, hi = self._bounds()
        x = math.log(v) if isinstance(self.domain, Float) and self.domain.log \
            else float(v)
        return (x - lo) / (hi - lo)

    def _from_unit(self, u: float) -> Any:
        lo, hi = self._bounds()
        x = lo + min(max(u, 0.0), 1.0) * (hi - lo)
        d = self.domain
        if isinstance(d, Float):
            v = math.exp(x) if d.log else x
            if d.q:
                v = round(v / d.q) * d.q
            return min(max(v, d.lower), d.upper)
        return min(int(round(x)), d.upper - 1)

    def fit(self, obs: List[Any]) -> "_FittedDim":
        return _FittedDim(self, obs)

    def _bandwidth(self, us: List[float]) -> float:
        # Scott's rule on the unit interval: adapts to the spread of
        # the observations, so sampling tightens as the good set
        # concentrates. Floored so kernels never collapse to spikes —
        # and for integers the floor is ONE STEP, so neighboring
        # values stay reachable when the good set piles on one value
        # (otherwise a local optimum is inescapable).
        floor = 0.02
        if isinstance(self.domain, Integer):
            lo, hi = self._bounds()
            floor = max(floor, 1.0 / max(hi - lo, 1.0))
        n = len(us)
        if n < 2:
            return max(0.25, floor)
        mean = sum(us) / n
        var = sum((u - mean) ** 2 for u in us) / (n - 1)
        return max(floor, math.sqrt(var) * n ** -0.2)


class _FittedDim:
    """A _ParzenDim bound to one observation set: unit transforms,
    bandwidth, and category weights computed once, then reused across
    every candidate of a suggest() pass."""

    def __init__(self, pd: _ParzenDim, obs: List[Any]):
        self.pd = pd
        d = pd.domain
        self.categorical = isinstance(d, Categorical)
        if self.categorical:
            # Smoothed counts (add-one prior over all categories).
            self.weights = [1.0] * len(d.categories)
            for v in obs:
                self.weights[d.categories.index(v)] += 1.0
            self.total = sum(self.weights)
        else:
            self.us = [pd._to_unit(v) for v in obs]
            self.bw = pd._bandwidth(self.us)
            self._norm = self.bw * math.sqrt(2 * math.pi)

    def sample(self, rng: random.Random) -> Any:
        d = self.pd.domain
        if self.categorical:
            return rng.choices(d.categories, weights=self.weights)[0]
        if not self.us or rng.random() < 0.2:  # prior draw: exploration
            return d.sample(rng)
        center = rng.choice(self.us)
        return self.pd._from_unit(rng.gauss(center, self.bw))

    def logpdf(self, value: Any) -> float:
        d = self.pd.domain
        if self.categorical:
            return math.log(
                self.weights[d.categories.index(value)] / self.total
            )
        u = self.pd._to_unit(value)
        # Mixture: uniform prior (weight 1) + one kernel per observation.
        dens = 1.0  # uniform on [0, 1]
        for o in self.us:
            z = (u - o) / self.bw
            dens += math.exp(-0.5 * z * z) / self._norm
        return math.log(dens / (len(self.us) + 1))


class TPESearch(Searcher):
    """Tree-structured Parzen Estimator (reference adapter:
    hyperopt_search.py; algorithm implemented natively here)."""

    def __init__(self, metric=None, mode=None, seed: Optional[int] = None,
                 gamma: float = 0.25, n_candidates: int = 24,
                 min_observations: int = 8):
        super().__init__(metric, mode)
        self._rng = random.Random(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.min_observations = min_observations
        self._results: List[Dict[str, Any]] = []  # {config, value}
        self._pending: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------- model
    def _split(self, results):
        vals = sorted(r["value"] for r in results)
        cut = vals[max(0, int(math.ceil(self.gamma * len(vals))) - 1)]
        good = [r for r in results if r["value"] <= cut]
        bad = [r for r in results if r["value"] > cut]
        return good, bad

    def _model_dims(self):
        return {
            k: _ParzenDim(v)
            for k, v in self._space.items()
            if isinstance(v, (Float, Integer, Categorical))
        }

    @staticmethod
    def _key(cfg: Dict[str, Any]):
        try:
            return tuple(sorted(cfg.items()))
        except TypeError:  # unhashable leaf: no dedup possible
            return None

    def _suggest_from(self, results) -> Dict[str, Any]:
        if len(results) < self.min_observations:
            return resolve_config(self._space, self._rng)
        good, bad = self._split(results)
        dims = self._model_dims()
        # Tabu on exact repeats: re-evaluating a deterministic config
        # teaches nothing, and in discrete spaces the duplicates flood
        # the good-set quantile until the model collapses onto the
        # incumbent and can never escape it.
        tried = {self._key(r["config"]) for r in results}
        tried.update(self._key(c) for c in self._pending.values())
        tried.discard(None)  # unhashable configs can't be deduped
        models = {
            k: (
                dim.fit([r["config"][k] for r in good]),
                dim.fit([r["config"][k] for r in bad]),
            )
            for k, dim in dims.items()
        }
        best_cfg, best_score = None, -math.inf
        fallback = None
        for _ in range(self.n_candidates):
            cfg = resolve_config(self._space, self._rng)
            score = 0.0
            for k, (l_model, g_model) in models.items():
                cfg[k] = l_model.sample(self._rng)
                score += l_model.logpdf(cfg[k]) - g_model.logpdf(cfg[k])
            fallback = fallback or cfg
            key = self._key(cfg)
            if key is not None and key in tried:
                continue
            if score > best_score:
                best_cfg, best_score = cfg, score
        return best_cfg or fallback

    # --------------------------------------------------------- interface
    def suggest(self, trial_id: str):
        cfg = self._suggest_from(self._results)
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or error or result is None or self.metric not in result:
            return
        value = result[self.metric]
        if self.mode == "max":
            value = -value
        self._results.append({"config": cfg, "value": value})


class BOHBSearch(TPESearch):
    """BOHB's model half (reference adapter: tune/search/bohb/): one
    TPE model per fidelity, preferring the highest training_iteration
    with enough observations. Pair with the ASHA/HyperBand scheduler
    for early stopping (the bandit half)."""

    def __init__(self, metric=None, mode=None, seed=None, gamma=0.25,
                 n_candidates=24, min_observations=8):
        super().__init__(metric, mode, seed, gamma, n_candidates,
                         min_observations)
        # budget -> {trial_id: {config, value}}: ONE entry per trial
        # per fidelity (a mid-train report then a terminal report at
        # the same budget must overwrite, not append — duplicates made
        # min_observations trip on 3 unique configs and the model
        # locked onto best-of-3-random).
        self._by_budget: Dict[int, Dict[str, Dict[str, Any]]] = {}

    def on_trial_result(self, trial_id, result):
        cfg = self._pending.get(trial_id)
        if cfg is None or self.metric not in result:
            return
        budget = int(result.get("training_iteration", 1))
        value = result[self.metric]
        if self.mode == "max":
            value = -value
        self._by_budget.setdefault(budget, {})[trial_id] = {
            "config": dict(cfg), "value": value,
        }

    def on_trial_complete(self, trial_id, result=None, error=False):
        # Terminal result counts at its budget too.
        if result is not None and not error:
            self.on_trial_result(trial_id, result)
        self._pending.pop(trial_id, None)

    def suggest(self, trial_id: str):
        # Highest fidelity with a modelable population wins (BOHB §3.2).
        results: List[Dict[str, Any]] = []
        for budget in sorted(self._by_budget, reverse=True):
            if len(self._by_budget[budget]) >= self.min_observations:
                results = list(self._by_budget[budget].values())
                break
        cfg = self._suggest_from(results)
        self._pending[trial_id] = cfg
        return cfg


class Repeater(Searcher):
    """Evaluate each suggestion ``repeat`` times; the wrapped searcher
    sees one completion with the MEAN metric (reference:
    tune/search/repeater.py)."""

    def __init__(self, searcher: Searcher, repeat: int = 3):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.repeat = repeat
        self._groups: Dict[str, Dict[str, Any]] = {}  # group id -> state
        self._trial_group: Dict[str, str] = {}
        self._open: Optional[str] = None

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str):
        if self._open is None:
            cfg = self.searcher.suggest(trial_id)
            if cfg is None or cfg is Searcher.BACKOFF:
                return cfg
            self._groups[trial_id] = {
                "config": cfg, "values": [], "spawned": 1, "lead": trial_id,
            }
            self._trial_group[trial_id] = trial_id
            if self.repeat > 1:
                self._open = trial_id
            return cfg
        group = self._groups[self._open]
        group["spawned"] += 1
        self._trial_group[trial_id] = self._open
        if group["spawned"] >= self.repeat:
            self._open = None
        return dict(group["config"])

    def on_trial_complete(self, trial_id, result=None, error=False):
        gid = self._trial_group.pop(trial_id, None)
        if gid is None:
            return
        group = self._groups[gid]
        if not error and result is not None and self.metric in result:
            group["values"].append(result[self.metric])
        remaining = sum(1 for g in self._trial_group.values() if g == gid)
        if remaining == 0 and group["spawned"] < self.repeat:
            # Sequential execution (e.g. max_concurrent=1): the lead
            # finished before any sibling was suggested. Keep the group
            # open — the next suggest() continues it.
            self._open = gid
            return
        if remaining == 0:
            vals = group["values"]
            mean = (sum(vals) / len(vals)) if vals else None
            self.searcher.on_trial_complete(
                group["lead"],
                result=None if mean is None else {self.metric: mean},
                error=mean is None,
            )
            self._groups.pop(gid, None)
            if self._open == gid:
                self._open = None
