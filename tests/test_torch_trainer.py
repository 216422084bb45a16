"""TorchTrainer (`ray_tpu_torch.train`) against the reference's JaxTrainer.

Mirrors of tests/test_train.py (the report contract, ranks, checkpoint
persistence, the error surfacing) and a restart from the last
checkpoint; `save_pytree`/`load_pytree` on torch.distributed.checkpoint;
two gloo workers joined by the KV rendezvous; and llama-tiny trained for
three AdamW steps from the same flax parameters through both trainers,
jax in the reference's worker and torch in the port's; and llama-tiny
fed by the port's Data module through `datasets=`, against the
reference's `iter_jax_batches` and the same steps in this process.

On this CPU every loop asks for the CPU (`use_gpu=False`, `device="cpu"`);
each test has a deadline after which it fails instead of hanging.
"""
import os
import signal

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    load_pytree,
    save_pytree,
)

DEADLINE_S = 180
# float32 compute on both sides: summation order only
# (tests/test_torch_llama.py's F32_TOL).
F32_TOL = 1e-4
PARITY_STEPS = 3
# The Data-fed run: one block of DATA_BATCH x DATA_SEQ ids a step.
DATA_STEPS, DATA_BATCH, DATA_SEQ = 3, 2, 32


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# One cluster for the class's fits, not one per test: the suite runs
# beside timing-sensitive reference tests.
@pytest.fixture(scope="class")
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray4(cluster, tmp_path):
    return str(tmp_path / "results")


def _fit(loop, storage, **kw):
    kw.setdefault("scaling_config", ScalingConfig(num_workers=1))
    return TorchTrainer(loop, run_config=RunConfig(storage_path=storage,
                                                   **kw.pop("run", {})), **kw).fit()


class TestOnOneCluster:
    """The trainer's contract, one fit per test on one cluster."""

    def test_single_worker_report(self, ray4):
        def loop(config):
            for i in range(3):
                train.report({"iter": i, "loss": 1.0 / (i + 1)})

        result = _fit(loop, ray4, train_loop_config={})
        assert result.error is None
        assert result.metrics["iter"] == 2
        assert len(result.metrics_history) == 3


    def test_multi_worker_ranks(self, ray4):
        def loop(config):
            ctx = train.get_context()
            train.report({"rank": ctx.world_rank, "world": ctx.world_size})

        result = _fit(loop, ray4, scaling_config=ScalingConfig(num_workers=3))
        assert result.error is None
        assert result.metrics["world"] == 3
        assert result.metrics["rank"] == 0  # rank-0 metrics surface


    def test_checkpoint_persistence(self, ray4, tmp_path):
        def loop(config):
            ctx = train.get_context()
            for i in range(2):
                if ctx.world_rank == 0:
                    d = os.path.join(config["scratch"], f"ckpt_{i}")
                    os.makedirs(d, exist_ok=True)
                    with open(os.path.join(d, "state.txt"), "w") as f:
                        f.write(f"iter={i}")
                    train.report({"iter": i}, checkpoint=Checkpoint(d))
                else:
                    train.report({"iter": i})

        result = _fit(loop, ray4, scaling_config=ScalingConfig(num_workers=2),
                      train_loop_config={"scratch": str(tmp_path / "scratch")})
        assert result.error is None
        assert result.checkpoint is not None
        assert result.checkpoint.path.startswith(ray4)
        with open(os.path.join(result.checkpoint.as_directory(), "state.txt")) as f:
            assert f.read() == "iter=1"


    def test_train_error_surfaces(self, ray4):
        def loop(config):
            raise ValueError("train loop blew up")

        with pytest.raises(Exception, match="train loop blew up"):
            _fit(loop, ray4)


    def test_restart_resumes_from_the_last_checkpoint(self, ray4, tmp_path):
        """The worker dies after its second checkpoint; the group restarts and
        the loop resumes from that checkpoint (FailureConfig)."""

        def loop(config):
            start = 0
            ckpt = train.get_checkpoint()
            if ckpt is not None:
                with open(os.path.join(ckpt.as_directory(), "iter.txt")) as f:
                    start = int(f.read()) + 1
            for i in range(start, 4):
                d = os.path.join(config["scratch"], f"ckpt_{i}")
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "iter.txt"), "w") as f:
                    f.write(str(i))
                train.report({"iter": i, "start": start}, checkpoint=Checkpoint(d))
                crashed = os.path.join(config["scratch"], "crashed")
                if i == 1 and not os.path.exists(crashed):
                    import time

                    open(crashed, "w").close()
                    time.sleep(1.0)  # let the driver persist iteration 1
                    os._exit(1)

        result = _fit(loop, ray4, train_loop_config={"scratch": str(tmp_path / "s")},
                      run={"failure_config": FailureConfig(max_failures=1)})
        assert result.error is None
        assert result.metrics == {"iter": 3, "start": 2}
        with open(os.path.join(result.checkpoint.as_directory(), "iter.txt")) as f:
            assert f.read() == "3"


    def test_use_gpu_without_a_gpu_raises(self, ray4):
        def loop(config):
            train.report({"ran": True})

        with pytest.raises(RuntimeError, match="GPU"):
            _fit(loop, ray4, scaling_config=ScalingConfig(num_workers=1, use_gpu=True))


    def test_two_gloo_workers_all_reduce(self, ray4):
        def loop(config):
            import torch
            import torch.distributed as dist

            ctx = train.get_context()
            x = torch.tensor([float(ctx.world_rank + 1)])
            dist.all_reduce(x)
            train.report({"sum": float(x), "backend": dist.get_backend(),
                          "world": dist.get_world_size()})

        result = _fit(loop, ray4, scaling_config=ScalingConfig(
            num_workers=2, use_torch_distributed=True))
        assert result.error is None
        assert result.metrics == {"sum": 3.0, "backend": "gloo", "world": 2}


    def test_llama_checkpoint_reloads_on_the_driver(self, ray4):
        """Phase 18 of chip_smoke.py at llama-tiny on the CPU: the worker
        trains, saves the state dict with save_pytree into its checkpoint and
        reports a fixed batch's no-grad loss; the driver reloads it into a
        fresh model and recomputes that loss."""

        def loop(config):
            import tempfile

            import numpy as np
            import torch

            from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, causal_lm_loss
            from ray_tpu_torch.train import make_optimizer, train_step

            torch.set_num_threads(1)
            cfg = CONFIGS["llama-tiny"]
            model = LlamaForCausalLM(cfg, device="cpu")
            ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)))
            opt = make_optimizer(model)
            for _ in range(2):
                train.report({"loss": float(train_step(model, opt, ids, ids.roll(-1, 1)))})
            d = tempfile.mkdtemp()
            save_pytree(os.path.join(d, "model"), model.state_dict())
            fixed = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 32)))
            with torch.no_grad():
                loss = float(causal_lm_loss(model(fixed), fixed.roll(-1, 1)))
            train.report({"fixed_loss": loss}, checkpoint=Checkpoint(d))

        result = _fit(loop, ray4)
        assert result.error is None
        from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, causal_lm_loss

        cfg = CONFIGS["llama-tiny"]
        fresh = LlamaForCausalLM(cfg, device="cpu")
        fresh.load_state_dict(load_pytree(os.path.join(result.checkpoint.path, "model")))
        fixed = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 32)))
        with torch.no_grad():
            loss = float(causal_lm_loss(fresh(fixed), fixed.roll(-1, 1)))
        assert loss == pytest.approx(result.metrics["fixed_loss"], rel=1e-5)


    def test_data_fed_llama_tiny_matches_the_reference_batches_and_the_in_process_steps(
            self, ray4):
        """Phase 19 of chip_smoke.py at llama-tiny on the CPU: a Dataset
        (`from_numpy`, one block a step, `map_batches` adding the rolled
        targets) given to the trainer as `datasets={"train": ds}`; the
        worker reads `config["__datasets__"]["train"]` and steps on
        `iter_torch_batches(device="cpu", dtypes=torch.long)`. Its batches
        equal, value for value, what the reference's `iter_jax_batches`
        yields for the same pipeline (jax holds them in int32, x64 being
        off), and its losses equal the same steps run here."""
        import ray_tpu
        from ray_tpu import data as jrd

        from ray_tpu_torch import data as trd
        from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM
        from ray_tpu_torch.train import make_optimizer, train_step

        x = np.random.RandomState(0).randint(0, 512, (DATA_STEPS * DATA_BATCH, DATA_SEQ))
        blocks = [x[i * DATA_BATCH:(i + 1) * DATA_BATCH] for i in range(DATA_STEPS)]

        def with_targets(b):
            return {"ids": b["item"], "targets": np.roll(b["item"], -1, axis=1)}

        def loop(config):
            import torch

            from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM
            from ray_tpu_torch.train import make_optimizer, train_step

            torch.set_num_threads(1)
            model = LlamaForCausalLM(CONFIGS["llama-tiny"], device="cpu")
            opt = make_optimizer(model)
            for b in config["__datasets__"]["train"].iter_torch_batches(
                    batch_size=config["batch"], device="cpu", dtypes=torch.long):
                loss = train_step(model, opt, b["ids"], b["targets"])
                train.report({"loss": float(loss), "ids": b["ids"].numpy(),
                              "targets": b["targets"].numpy(),
                              "devices": sorted({t.device.type for t in b.values()}),
                              "dtypes": sorted({str(t.dtype) for t in b.values()})})

        ds = trd.from_numpy(blocks).map_batches(with_targets)
        result = _fit(loop, ray4, train_loop_config={"batch": DATA_BATCH},
                      datasets={"train": ds})
        assert result.error is None
        history = result.metrics_history
        assert len(history) == DATA_STEPS
        assert all(m["devices"] == ["cpu"] and m["dtypes"] == ["torch.int64"] for m in history)

        ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
        try:
            want = [{k: np.asarray(v) for k, v in b.items()} for b in
                    jrd.from_numpy(blocks).map_batches(with_targets)
                    .iter_jax_batches(batch_size=DATA_BATCH)]
        finally:
            ray_tpu.shutdown()
        assert len(want) == DATA_STEPS
        for m, w in zip(history, want):
            for k in ("ids", "targets"):
                assert w[k].dtype == np.int32
                np.testing.assert_array_equal(m[k], w[k].astype(np.int64))

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            model = LlamaForCausalLM(CONFIGS["llama-tiny"], device="cpu")
            opt = make_optimizer(model)
            losses = [float(train_step(model, opt, torch.from_numpy(w["ids"].astype(np.int64)),
                                       torch.from_numpy(w["targets"].astype(np.int64))))
                      for w in want]
        finally:
            torch.set_num_threads(threads)
        assert [m["loss"] for m in history] == losses


def test_worker_that_holds_a_gpu_but_sees_none_fails(monkeypatch, tmp_path):
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "1")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ray_tpu_torch.init(num_cpus=2)
    try:
        def loop(config):
            train.report({"ran": True})

        # The actor's constructor fails, and the group is not restarted
        # (max_failures 0): the error comes back in the result.
        result = _fit(loop, str(tmp_path),
                      scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
        assert result.metrics is None
        assert "creation task failed" in str(result.error)
        assert "sees no CUDA device" in str(result.error)
    finally:
        ray_tpu_torch.shutdown()


# --------------------------------------------------------------- checkpoints


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "model": {"layers.0.w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
                  "embed": torch.randn(16, 4, generator=g)},
        "step": torch.tensor(7),
        "moments": [torch.randn(3, generator=g).to(torch.bfloat16)],
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_save_load_pytree_without_template(tmp_path):
    state = _state()
    save_pytree(str(tmp_path / "ckpt"), state)
    _assert_same(load_pytree(str(tmp_path / "ckpt")), state)


def test_save_load_pytree_into_template(tmp_path):
    state = _state()
    save_pytree(str(tmp_path / "ckpt"), state)
    template = {
        "model": {k: torch.zeros_like(v) for k, v in state["model"].items()},
        "step": torch.tensor(0),
        "moments": [torch.zeros(3, dtype=torch.bfloat16)],
    }
    target = template["model"]["layers.0.w"]
    restored = load_pytree(str(tmp_path / "ckpt"), template)
    assert restored is template
    assert restored["model"]["layers.0.w"] is target  # loaded in place
    _assert_same(restored, state)


def test_async_checkpointer(tmp_path):
    state = _state()
    ckptr = train.AsyncCheckpointer()
    ckptr.save(str(tmp_path / "a"), state)
    ckptr.wait()
    ckptr.close()
    _assert_same(load_pytree(str(tmp_path / "a")), state)


# ------------------------------------------------------ parity with JaxTrainer


def test_llama_tiny_losses_match_the_reference_trainer(tmp_path):
    import jax
    import jax.numpy as jnp

    import ray_tpu
    from ray_tpu.models import llama as jllama
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as JRunConfig
    from ray_tpu.train import ScalingConfig as JScalingConfig

    jmodel = jllama.LlamaForCausalLM(jllama.CONFIGS["llama-tiny"])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    ids = np.random.RandomState(0).randint(0, 512, (2, 64)).astype(np.int32)
    config = {"params": params, "ids": ids, "steps": PARITY_STEPS}

    # The loops are closures, so each trainer ships them by value.
    def _jax_loop(config):
        from dataclasses import replace

        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu import train as jtrain
        from ray_tpu.models import llama as jllama

        cfg = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)
        model = jllama.LlamaForCausalLM(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, config["params"])
        ids = jnp.asarray(config["ids"])
        targets = jnp.roll(ids, -1, axis=1)
        tx = optax.adamw(3e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)
        opt = tx.init(params)

        @jax.jit
        def step(p, o):
            loss, g = jax.value_and_grad(
                lambda p_: jllama.causal_lm_loss(model.apply(p_, ids), targets))(p)
            up, o = tx.update(g, o, p)
            return optax.apply_updates(p, up), o, loss

        for _ in range(config["steps"]):
            params, opt, loss = step(params, opt)
            jtrain.report({"loss": float(loss)})

    def _torch_loop(config):
        from dataclasses import replace

        import torch

        from ray_tpu_torch.convert import llama_params_from_flax
        from ray_tpu_torch.models import llama as tllama
        from ray_tpu_torch.train import make_optimizer, train_step

        torch.set_num_threads(1)
        cfg = replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32)
        model = tllama.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(llama_params_from_flax(config["params"]))
        ids = torch.from_numpy(config["ids"]).long()
        targets = torch.roll(ids, -1, dims=1)
        opt = make_optimizer(model)
        for _ in range(config["steps"]):
            train.report({"loss": float(train_step(model, opt, ids, targets))})

    ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
    try:
        ref = JaxTrainer(_jax_loop, train_loop_config=config,
                         scaling_config=JScalingConfig(num_workers=1),
                         run_config=JRunConfig(storage_path=str(tmp_path / "jax"))).fit()
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    try:
        port = TorchTrainer(_torch_loop, train_loop_config=config,
                            scaling_config=ScalingConfig(num_workers=1),
                            run_config=RunConfig(storage_path=str(tmp_path / "torch"))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert ref.error is None and port.error is None
    want = [m["loss"] for m in ref.metrics_history]
    got = [m["loss"] for m in port.metrics_history]
    assert len(want) == len(got) == PARITY_STEPS
    np.testing.assert_allclose(got, want, rtol=F32_TOL)
    assert got[-1] < got[0]
