"""The port's Tune (`ray_tpu_torch.tune`) against the reference's
(`ray_tpu.tune`).

tests/test_tune.py's cases run through each module on its own runtime
(both at once in this process, one module-scoped cluster of each), with
the reference's assertions; where a case is deterministic its results
are compared across the two. tests/test_tune_searchers.py's cases run
through each module with the same seeds, and every searcher suggestion
and scheduler decision must be equal exactly: both modules are the same
numpy and `random` code. Then the port's own: its results directory and
env, and a Tuner over a `TorchTrainer` (phase 21 of chip_smoke.py at
llama-tiny on the CPU), whose trial at the in-process learning rate gives
the in-process losses.

Every test has a deadline after which it fails instead of hanging.
"""
import importlib
import json
import os
import random
import signal
import tempfile
import time

import pytest

import ray_tpu
import ray_tpu_torch

DEADLINE_S = 150
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
NAMES = sorted(RUNTIMES)


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def clusters():
    # 8 CPUs apiece: up to 7 trials at once (the controller's default).
    ray_tpu.init(num_cpus=8, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=8, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _tune(name):
    return importlib.import_module(f"{name}.tune")


def _train(name):
    return importlib.import_module(f"{name}.train")


def _quadratic(name):
    """tests/test_tune.py's `_quadratic`, reporting through `name`'s tune."""

    def trainable(config):
        tune = importlib.import_module(f"{name}.tune")
        for i in range(5):
            tune.report({"score": -((config["x"] - 3.0) ** 2) - 0.01 * (5 - i)})

    return trainable


def _by_config(results, key):
    return sorted((r.config[key], r.metrics_history and [
        {k: v for k, v in m.items() if k in ("score", "total", "acc", "perf")}
        for m in r.metrics_history]) for r in results.results)


# ----------------------------------------------------------- tests/test_tune.py


@pytest.mark.parametrize("name", NAMES)
def test_grid_search(clusters, tmp_path, name):
    tune = _tune(name)
    results = tune.Tuner(
        _quadratic(name),
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=_train(name).RunConfig(storage_path=str(tmp_path), name="grid"),
    ).fit()
    assert len(results) == 4
    best = results.get_best_result()
    assert best.config["x"] == 3.0
    assert abs(best.metrics["score"]) < 0.1


def test_grid_search_results_equal_the_references(clusters, tmp_path):
    out = {}
    for name in NAMES:
        tune = _tune(name)
        out[name] = _by_config(tune.Tuner(
            _quadratic(name),
            param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=_train(name).RunConfig(storage_path=str(tmp_path / name), name="grid"),
        ).fit(), "x")
    assert out["ray_tpu_torch"] == out["ray_tpu"]


@pytest.mark.parametrize("name", NAMES)
def test_random_search_num_samples(clusters, tmp_path, name):
    tune = _tune(name)
    results = tune.Tuner(
        _quadratic(name),
        param_space={"x": tune.uniform(0, 6)},
        tune_config=tune.TuneConfig(metric="score", mode="max", num_samples=6),
        run_config=_train(name).RunConfig(storage_path=str(tmp_path), name="rand"),
    ).fit()
    assert len(results) == 6
    assert not results.errors


def _counter(name):
    tune = _tune(name)

    class Counter(tune.Trainable):
        def setup(self, config):
            self.total = 0
            self.inc = config["inc"]

        def step(self):
            self.total += self.inc
            return {"total": self.total}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "state.txt"), "w") as f:
                f.write(str(self.total))
            return d

        def load_checkpoint(self, d):
            with open(os.path.join(d, "state.txt")) as f:
                self.total = int(f.read())

    return Counter


@pytest.mark.parametrize("name", NAMES)
def test_trainable_class_and_checkpointing(clusters, tmp_path, name):
    tune = _tune(name)
    rc = _train(name).RunConfig(storage_path=str(tmp_path), name="cls",
                                stop={"training_iteration": 4})
    results = tune.Tuner(
        _counter(name),
        param_space={"inc": tune.grid_search([1, 10])},
        tune_config=tune.TuneConfig(metric="total", mode="max"),
        run_config=rc,
    ).fit()
    assert len(results) == 2
    best = results.get_best_result()
    assert best.metrics["total"] == 40
    assert best.checkpoint is not None
    with open(os.path.join(best.checkpoint.path, "state.txt")) as f:
        assert f.read() == "40"


def _asha(name, tmp_path):
    tune = _tune(name)

    def trainable(config):
        tune = importlib.import_module(f"{name}.tune")
        for i in range(1, 17):
            tune.report({"acc": config["q"] * i})

    sched = tune.ASHAScheduler(grace_period=2, reduction_factor=2, max_t=16)
    return tune.Tuner(
        trainable,
        param_space={"q": tune.grid_search([1.0, 0.5, 0.2, 0.1])},
        tune_config=tune.TuneConfig(metric="acc", mode="max", scheduler=sched,
                                    max_concurrent_trials=1),
        run_config=_train(name).RunConfig(storage_path=str(tmp_path), name="asha"),
    ).fit()


def test_asha_stops_bad_trials_on_both_alike(clusters, tmp_path):
    """The reference's case on each, and each trial stopped at the same
    rung on both (sequential trials: ASHA's decisions are deterministic)."""
    out = {}
    for name in NAMES:
        results = _asha(name, tmp_path / name)
        iters = sorted(len(r.metrics_history) for r in results.results)
        assert iters[0] < 16
        assert results.get_best_result().metrics["acc"] == pytest.approx(16.0)
        out[name] = sorted((r.config["q"], len(r.metrics_history)) for r in results.results)
    assert out["ray_tpu_torch"] == out["ray_tpu"]


@pytest.mark.parametrize("name", NAMES)
def test_pbt_exploits(clusters, tmp_path, name):
    tune, train = _tune(name), _train(name)

    def trainable(config):
        tune = importlib.import_module(f"{name}.tune")
        train = importlib.import_module(f"{name}.train")
        ckpt = tune.get_checkpoint()
        start = 0
        if ckpt:
            with open(os.path.join(ckpt.path, "v.txt")) as f:
                start = int(f.read())
        for i in range(start + 1, 21):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "v.txt"), "w") as f:
                f.write(str(i))
            tune.report({"perf": config["lr"] * i, "training_iteration": i},
                        checkpoint=train.Checkpoint(d))

    sched = tune.PopulationBasedTraining(
        perturbation_interval=5, hyperparam_mutations={"lr": [0.1, 1.0, 10.0]}, seed=0)
    results = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.1, 10.0])},
        tune_config=tune.TuneConfig(metric="perf", mode="max", scheduler=sched,
                                    max_concurrent_trials=2),
        run_config=train.RunConfig(storage_path=str(tmp_path), name="pbt"),
    ).fit()
    assert len(results) == 2
    assert all(r.metrics["perf"] > 2.0 for r in results.results)


@pytest.mark.parametrize("name", NAMES)
def test_actor_loss_restarts_trial(clusters, tmp_path, name):
    tune_controller = importlib.import_module(f"{name}.tune.tune_controller")

    def slow(config):
        tune = importlib.import_module(f"{name}.tune")
        train = importlib.import_module(f"{name}.train")
        ckpt = tune.get_checkpoint()
        start = 0
        if ckpt:
            with open(os.path.join(ckpt.path, "i.txt")) as f:
                start = int(f.read())
        for i in range(start + 1, 6):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "i.txt"), "w") as f:
                f.write(str(i))
            tune.report({"i": i}, checkpoint=train.Checkpoint(d))
            time.sleep(0.2)

    controller = tune_controller.TuneController(
        slow, param_space={}, metric="i", mode="max",
        experiment_dir=str(tmp_path / "infra"),
    )
    while not any(t.status == tune_controller.RUNNING and t.metrics_history
                  for t in controller.trials):
        assert controller.step()
    trial = controller.trials[0]
    RUNTIMES[name].kill(controller._actors[trial.trial_id])
    while controller.step():
        pass
    assert trial.status == "TERMINATED", trial.error
    assert trial.num_infra_failures >= 1
    assert trial.num_failures == 0
    assert trial.last_result["i"] == 5


@pytest.mark.parametrize("name", NAMES)
def test_failed_trial_reports_error(clusters, tmp_path, name):
    tune = _tune(name)

    def bad(config):
        importlib.import_module(f"{name}.tune").report({"x": 1})
        raise ValueError("boom")

    results = tune.Tuner(
        bad, param_space={}, tune_config=tune.TuneConfig(metric="x", mode="max"),
        run_config=_train(name).RunConfig(storage_path=str(tmp_path), name="fail"),
    ).fit()
    assert len(results.errors) == 1
    assert "boom" in str(results.errors[0])


@pytest.mark.parametrize("name", NAMES)
def test_experiment_state_saved(clusters, tmp_path, name):
    tune = _tune(name)
    tune.Tuner(
        _quadratic(name),
        param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=_train(name).RunConfig(storage_path=str(tmp_path), name="state"),
    ).fit()
    state_file = tmp_path / "state" / "experiment_state.json"
    assert state_file.exists()
    state = json.loads(state_file.read_text())
    assert len(state["trials"]) == 2
    assert all(t["status"] == "TERMINATED" for t in state["trials"])


@pytest.mark.parametrize("name", NAMES)
def test_tune_run_functional(clusters, tmp_path, name):
    results = _tune(name).run(
        _quadratic(name), config={"x": _tune(name).grid_search([2.0, 3.0])},
        metric="score", mode="max", storage_path=str(tmp_path), name="func",
    )
    assert len(results) == 2


# ------------------------------------------------- tests/test_tune_searchers.py


SPACE_BOUNDS = {"x": (-1.0, 1.0), "y": (-1.0, 1.0)}


def _space(tune):
    return {k: tune.uniform(lo, hi) for k, (lo, hi) in SPACE_BOUNDS.items()}


def branin_ish(cfg):
    return (cfg["x"] - 0.7) ** 2 + (cfg["y"] + 0.3) ** 2


def _run(tune, searcher, n_trials, objective):
    """tests/test_tune_searchers.py's `_run`, keeping every suggestion."""
    searcher.set_search_properties("loss", "min", _space(tune))
    best, suggested = float("inf"), []
    for i in range(n_trials):
        tid = f"t{i}"
        cfg = searcher.suggest(tid)
        suggested.append(cfg)
        loss = objective(cfg)
        best = min(best, loss)
        searcher.on_trial_complete(tid, {"loss": loss})
    return best, suggested


def _random_best(tune, n_trials, seed, objective):
    from importlib import import_module

    resolve_config = import_module(f"{tune.__name__}.search").resolve_config
    rng = random.Random(seed)
    return min(objective(resolve_config(_space(tune), rng)) for _ in range(n_trials))


def _both(case):
    """`case(tune)` through each module; the port's result must equal the
    reference's exactly."""
    want, got = (case(_tune(name)) for name in NAMES)
    assert got == want
    return got


def test_tpe_beats_random():
    n = 60
    tpe_best, _ = _both(lambda tune: _run(tune, tune.TPESearch(seed=0), n, branin_ish))
    rand_best = _both(lambda tune: min(_random_best(tune, n, s, branin_ish) for s in (0, 1, 2)))
    assert tpe_best < rand_best, (tpe_best, rand_best)
    assert tpe_best < 0.01


def test_tpe_categorical_and_int():
    def case(tune):
        space = {"opt": tune.choice(["adam", "sgd", "lion"]), "layers": tune.randint(1, 9)}

        def obj(cfg):
            return (0.0 if cfg["opt"] == "lion" else 1.0) + abs(cfg["layers"] - 6)

        searcher = tune.TPESearch(seed=1, min_observations=6)
        searcher.set_search_properties("loss", "min", space)
        best_cfg, best, suggested = None, float("inf"), []
        for i in range(50):
            cfg = searcher.suggest(f"t{i}")
            suggested.append(cfg)
            loss = obj(cfg)
            if loss < best:
                best, best_cfg = loss, cfg
            searcher.on_trial_complete(f"t{i}", {"loss": loss})
        return best, best_cfg, suggested

    best, best_cfg, _ = _both(case)
    assert best == 0.0 and best_cfg["opt"] == "lion"


def test_bohb_uses_highest_informative_budget():
    def staged(cfg, iters):
        if iters < 3:
            return (cfg["x"] + 0.5) ** 2 + (cfg["y"] - 0.5) ** 2
        return branin_ish(cfg)

    def case(tune):
        bohb = tune.BOHBSearch(seed=0, min_observations=6)
        bohb.set_search_properties("loss", "min", _space(tune))
        best, suggested = float("inf"), []
        for i in range(60):
            tid = f"t{i}"
            cfg = bohb.suggest(tid)
            suggested.append(cfg)
            for it in (1, 3):
                bohb.on_trial_result(tid, {"loss": staged(cfg, it), "training_iteration": it})
            final = staged(cfg, 3)
            best = min(best, final)
            bohb.on_trial_complete(tid, {"loss": final, "training_iteration": 3})
        return best, suggested

    best, _ = _both(case)
    rand_best = _both(lambda tune: min(_random_best(tune, 60, s, branin_ish) for s in (0, 1, 2)))
    assert best < rand_best and best < 0.01


def _recording(tune):
    class Recording(tune.Searcher):
        def __init__(self):
            super().__init__("loss", "min")
            self.completed = []
            self._i = 0

        def suggest(self, trial_id):
            self._i += 1
            return {"x": self._i}

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append((trial_id, result, error))

    return Recording()


def test_repeater_reports_mean_to_wrapped_searcher():
    def case(tune):
        inner = _recording(tune)
        rep = tune.Repeater(inner, repeat=3)
        rep.set_search_properties("loss", "min", _space(tune))
        cfgs = [rep.suggest(f"t{k}") for k in range(3)]
        assert cfgs[0] == cfgs[1] == cfgs[2]
        for k, loss in enumerate([1.0, 2.0, 6.0]):
            rep.on_trial_complete(f"t{k}", {"loss": loss})
        return cfgs, inner.completed, rep.suggest("t3")

    cfgs, completed, nxt = _both(case)
    assert len(completed) == 1
    tid, result, error = completed[0]
    assert not error and result["loss"] == pytest.approx(3.0)
    assert nxt == {"x": 2}


def test_repeater_under_concurrency_limiter():
    def case(tune):
        tpe = tune.TPESearch(seed=3, min_observations=4)
        rep = tune.ConcurrencyLimiter(tune.Repeater(tpe, repeat=2), max_concurrent=2)
        rep.set_search_properties("loss", "min", _space(tune))
        c0, c1 = rep.suggest("a"), rep.suggest("b")
        assert c0 == c1
        assert rep.suggest("c") is tune.Searcher.BACKOFF
        rep.on_trial_complete("a", {"loss": branin_ish(c0)})
        rep.on_trial_complete("b", {"loss": branin_ish(c1)})
        c2 = rep.suggest("c")
        assert c2 is not tune.Searcher.BACKOFF and c2 is not None
        return c0, c2

    _both(case)


@pytest.mark.parametrize("name", NAMES)
def test_tpe_through_tuner_end_to_end(clusters, tmp_path, name):
    tune = _tune(name)

    def objective(config):
        importlib.import_module(f"{name}.tune").report(
            {"loss": (config["x"] - 0.7) ** 2 + (config["y"] + 0.3) ** 2})

    results = tune.Tuner(
        objective,
        param_space=_space(tune),
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=25,
            search_alg=tune.TPESearch(seed=0, min_observations=5),
        ),
        run_config=_train(name).RunConfig(storage_path=str(tmp_path), name="tpe"),
    ).fit()
    assert len(results) == 25
    assert results.get_best_result().metrics["loss"] < 0.15


def test_repeater_sequential_execution_still_repeats():
    def case(tune):
        inner = _recording(tune)
        rep = tune.Repeater(inner, repeat=3)
        rep.set_search_properties("loss", "min", _space(tune))
        losses = iter([1.0, 3.0, 8.0])
        cfgs = []
        for k in range(3):
            cfgs.append(rep.suggest(f"t{k}"))
            rep.on_trial_complete(f"t{k}", {"loss": next(losses)})
        return cfgs, [r for _, r, _ in inner.completed]

    cfgs, completed = _both(case)
    assert cfgs[0] == cfgs[1] == cfgs[2]
    assert len(completed) == 1 and completed[0]["loss"] == pytest.approx(4.0)


def test_queue_searcher_not_capped_by_default_num_samples(tmp_path):
    def case(tune):
        controller = importlib.import_module(f"{tune.__name__}.tune_controller")
        search = importlib.import_module(f"{tune.__name__}.search")

        def make(alg, **kw):
            return controller.TuneController(
                lambda cfg: None, param_space=_space(tune), metric="loss", mode="min",
                search_alg=alg, experiment_dir=str(tmp_path / tune.__name__),
                max_concurrent_trials=1, **kw)

        return (make(search.BasicVariantGenerator(num_samples=5))._max_trials,
                make(tune.ConcurrencyLimiter(search.BasicVariantGenerator(num_samples=5),
                                             2))._max_trials,
                make(tune.TPESearch(seed=0), num_samples=7)._max_trials)

    assert _both(case) == (None, None, 7)


# -------------------------------------------- searchers and schedulers, exactly


def test_basic_variant_generator_suggests_the_references_configs():
    def case(tune):
        gen = importlib.import_module(f"{tune.__name__}.search").BasicVariantGenerator(
            num_samples=3, seed=7)
        gen.set_search_properties("loss", "min", {
            "lr": tune.loguniform(1e-4, 1e-1), "layers": tune.randint(1, 9),
            "opt": tune.choice(["adam", "sgd"]), "q": tune.quniform(0, 1, 0.25),
            "grid": tune.grid_search([1, 2]), "nested": {"u": tune.uniform(-1, 1)}})
        out = []
        while (cfg := gen.suggest(f"t{len(out)}")) is not None:
            out.append(cfg)
        return out

    assert len(_both(case)) == 6


def _stream(n_trials=6, n_iters=12, seed=0):
    """Results of n_trials trials, interleaved, from RandomState-free
    `random.Random(seed)`: (trial index, iteration, metric)."""
    rng = random.Random(seed)
    quality = [rng.random() for _ in range(n_trials)]
    return [(t, i, quality[t] * i + rng.random()) for i in range(1, n_iters + 1)
            for t in range(n_trials)]


class _Trial:
    def __init__(self, i):
        self.trial_id = f"trial_{i}"
        self.config = {"lr": [0.1, 1.0, 10.0][i % 3]}
        self.status = "RUNNING"
        self.latest_checkpoint = f"ckpt_{i}"
        self.last_result = {}


class _Controller:
    """What the schedulers read and call on the TuneController."""

    def __init__(self, n):
        self.trials = [_Trial(i) for i in range(n)]
        self.exploits = []

    def get_trial(self, trial_id):
        return next((t for t in self.trials if t.trial_id == trial_id), None)

    def exploit_trial(self, trial, source, new_config):
        self.exploits.append((trial.trial_id, source.trial_id, dict(new_config)))
        trial.config = new_config


@pytest.mark.parametrize("scheduler", ["asha", "median", "pbt"])
def test_scheduler_decisions_equal_the_references(scheduler):
    """ASHA, the median stopping rule and PBT, fed the same stream of
    results: every decision (and PBT's every exploit with its mutated
    config) equal on both."""

    def case(tune):
        make = {
            "asha": lambda: tune.ASHAScheduler(grace_period=2, reduction_factor=2, max_t=12),
            "median": lambda: tune.MedianStoppingRule(grace_period=3, min_samples_required=3),
            "pbt": lambda: tune.PopulationBasedTraining(
                perturbation_interval=3, hyperparam_mutations={"lr": [0.1, 1.0, 10.0]}, seed=0),
        }[scheduler]
        sched = make()
        sched.set_properties("score", "max")
        controller = _Controller(6)
        decisions = []
        for t, i, score in _stream():
            trial = controller.trials[t]
            result = {"score": score, "training_iteration": i}
            trial.last_result = result
            decisions.append(sched.on_trial_result(controller, trial, result))
        return decisions, controller.exploits

    decisions, exploits = _both(case)
    assert len(decisions) == 72
    if scheduler == "pbt":
        assert exploits
    else:
        assert "STOP" in decisions


# ------------------------------------------------------------ the port's own


def test_results_dir_and_env_are_the_ports(tmp_path, monkeypatch):
    """The pinned divergence: with no storage path the port writes under
    RAY_TPU_TORCH_RESULTS_DIR, else ~/ray_tpu_torch_results; the
    reference reads RAY_TPU_RESULTS_DIR and ~/ray_tpu_results."""
    port = importlib.import_module("ray_tpu_torch.tune.tuner")
    ref = importlib.import_module("ray_tpu.tune.tuner")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("RAY_TPU_TORCH_RESULTS_DIR", raising=False)
    monkeypatch.delenv("RAY_TPU_RESULTS_DIR", raising=False)
    home = str(tmp_path / "home")
    assert port._default_experiment_dir("x", None) == f"{home}/ray_tpu_torch_results/x"
    assert ref._default_experiment_dir("x", None) == f"{home}/ray_tpu_results/x"
    monkeypatch.setenv("RAY_TPU_TORCH_RESULTS_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("RAY_TPU_RESULTS_DIR", str(tmp_path / "ref"))
    assert port._default_experiment_dir(None, None) == str(tmp_path / "port" / "tune_experiment")
    assert ref._default_experiment_dir(None, None) == str(tmp_path / "ref" / "tune_experiment")
    assert port._default_experiment_dir("x", "/s") == "/s/x"


def test_the_tuner_wraps_a_torch_trainer_as_the_reference_wraps_its_jax_trainer(
        clusters, tmp_path):
    """A Tuner over each module's trainer: every trial runs fit() with its
    config merged into train_loop_config, and reports the loop's last
    metrics; equal on both."""
    out = {}
    for name in NAMES:
        train, tune = _train(name), _tune(name)
        trainer_cls = train.TorchTrainer if name == "ray_tpu_torch" else train.JaxTrainer

        def loop(config, name=name):
            train = importlib.import_module(f"{name}.train")
            for i in range(3):
                train.report({"score": config["a"] * config["b"] * i})

        trainer = trainer_cls(loop, train_loop_config={"a": 2.0},
                              scaling_config=train.ScalingConfig(num_workers=1),
                              run_config=train.RunConfig(storage_path=str(tmp_path / name / "t")))
        results = tune.Tuner(
            trainer, param_space={"b": tune.grid_search([1.0, 3.0])},
            tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=1),
            run_config=train.RunConfig(storage_path=str(tmp_path / name), name="trainer"),
        ).fit()
        assert not results.errors
        out[name] = sorted((r.config["b"], r.metrics["score"]) for r in results.results)
    assert out["ray_tpu_torch"] == out["ray_tpu"] == [(1.0, 4.0), (3.0, 12.0)]


def tune_llama_loop(config):
    """Phase 21's loop at llama-tiny on the CPU: a fresh model, the
    in-process batch, `make_optimizer` at the trial's learning rate."""
    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM
    from ray_tpu_torch.ops import attention as A

    torch.set_num_threads(1)
    cfg = CONFIGS["llama-tiny"]
    model = LlamaForCausalLM(cfg, device="cpu")
    optimizer = train.make_optimizer(model)
    for group in optimizer.param_groups:
        group["lr"] = config["lr"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)))
    A.reset_launch_counts()
    losses = [float(train.train_step(model, optimizer, ids, ids.roll(-1, 1))) for _ in range(3)]
    train.report({"losses": losses, "launches": dict(A.LAUNCHES)})


def test_a_tuner_over_a_torch_trainer_at_llama_tiny_gives_the_in_process_losses(
        clusters, tmp_path):
    """Phase 21 at llama-tiny on the CPU: two trials, at make_optimizer's
    learning rate and another, queued one at a time; the first gives the
    same steps' losses in process bitwise, the other finite losses that
    differ after the first step. The kernels' plain versions count no
    launches on the CPU."""
    import torch

    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    torch.manual_seed(0)
    lr = train.make_optimizer(torch.nn.Linear(1, 1)).defaults["lr"]
    results = tune.Tuner(
        train.TorchTrainer(tune_llama_loop,
                           scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
                           run_config=train.RunConfig(storage_path=str(tmp_path / "t"))),
        param_space={"lr": tune.grid_search([lr, 10 * lr])},
        tune_config=tune.TuneConfig(metric="losses", mode="min", max_concurrent_trials=1),
        run_config=train.RunConfig(storage_path=str(tmp_path), name="llama"),
    ).fit()
    assert not results.errors
    by_lr = {r.config["lr"]: r.metrics["losses"] for r in results.results}
    import numpy as np

    cfg = CONFIGS["llama-tiny"]
    model = LlamaForCausalLM(cfg, device="cpu")
    optimizer = train.make_optimizer(model)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)))
    want = [float(train.train_step(model, optimizer, ids, ids.roll(-1, 1))) for _ in range(3)]
    assert by_lr[lr] == want
    launches = [r.metrics["launches"] for r in results.results]
    assert all(n == 0 for counts in launches for n in counts.values()), launches
    other = by_lr[10 * lr]
    assert all(np.isfinite(other)) and other[0] == want[0] and other[1:] != want[1:]
