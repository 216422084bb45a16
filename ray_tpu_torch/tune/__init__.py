"""ray_tpu_torch.tune: distributed hyperparameter tuning, the port's copy of
ray_tpu.tune on the port's runtime and Train.

Reference: python/ray/tune — Tuner.fit drives a TuneController event
loop over one actor per trial; searchers propose configs, schedulers
stop/exploit trials on reported results; experiment state checkpoints
for resume.

    from ray_tpu_torch import tune

    def trainable(config):
        for step in range(10):
            tune.report({"score": config["lr"] * step})

    results = tune.Tuner(
        trainable,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(metric="score", mode="max", num_samples=8),
    ).fit()
"""
from ..train.session import get_context
from ..train.session import report as _train_report
from .schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    OptunaSearch,
    Searcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from .tpe import BOHBSearch, Repeater, TPESearch
from .trainable import Trainable, wrap_function
from .tune_controller import Trial, TuneController
from .tuner import ResultGrid, TuneConfig, Tuner, run


def report(metrics, *, checkpoint=None) -> None:
    """Reference: ray.tune.report — same session contract as
    ray_tpu_torch.train.report."""
    _train_report(metrics, checkpoint=checkpoint)


def get_checkpoint():
    """Latest checkpoint for restoration inside a trial (reference:
    tune.get_checkpoint)."""
    from ..train.session import get_session

    s = get_session()
    return getattr(s.context, "latest_checkpoint", None) if s else None


def with_parameters(fn, **kwargs):
    """Reference: tune.with_parameters."""
    return wrap_function(fn, kwargs)


__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "MedianStoppingRule",
    "OptunaSearch",
    "TPESearch",
    "BOHBSearch",
    "Repeater",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "Trainable",
    "Trial",
    "TrialScheduler",
    "TuneConfig",
    "TuneController",
    "Tuner",
    "choice",
    "get_checkpoint",
    "get_context",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "report",
    "run",
    "sample_from",
    "uniform",
    "with_parameters",
]

from ray_tpu_torch._private import usage_stats as _usage

_usage.record_library_usage("tune")
