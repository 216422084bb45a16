"""The port's runtime (`ray_tpu_torch`) against the reference (`ray_tpu`).

The basic flows run on both runtimes and must give the same results:
tasks, an actor with state, a named actor, `kill`, a placement group and
a large numpy array through shared memory. Both runtimes then run at once
in this process. Tensors go through the port's object store bit for bit
with their dtype; a node faked to two GPUs gives each one-GPU actor its
own CUDA_VISIBLE_DEVICES and every other worker none.

Every cluster here has at most 4 CPUs, and every test a deadline after
which it fails instead of hanging.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private import serialization

DEADLINE_S = 120
GET_TIMEOUT_S = 60
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# One cluster per class, not per test: the suite runs beside
# timing-sensitive reference tests, and each fresh cluster's workers pay
# their imports (torch's among them) again.
@pytest.fixture(scope="class", params=sorted(RUNTIMES))
def rt(request):
    r = RUNTIMES[request.param]
    r.init(num_cpus=4, ignore_reinit_error=True)
    yield r
    r.shutdown()


@pytest.fixture(scope="class")
def port():
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# --------------------------------------------------------------- both runtimes


class TestBothRuntimes:
    """The verify flows, each on both runtimes, with the same results."""

    def test_task(self, rt):
        @rt.remote
        def add(a, b):
            return a + b

        refs = [add.remote(i, i) for i in range(8)]
        assert rt.get(refs, timeout=GET_TIMEOUT_S) == [2 * i for i in range(8)]
        assert rt.get(add.remote(add.remote(1, 2), 3), timeout=GET_TIMEOUT_S) == 6


    def test_actor_keeps_state(self, rt):
        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def inc(self, by=1):
                self.n += by
                return self.n

        c = Counter.remote(10)
        refs = [c.inc.remote() for _ in range(5)]
        assert rt.get(refs, timeout=GET_TIMEOUT_S) == [11, 12, 13, 14, 15]
        assert rt.get(c.inc.remote(by=5), timeout=GET_TIMEOUT_S) == 20


    def test_named_actor(self, rt):
        @rt.remote
        class Box:
            def __init__(self):
                self.v = None

            def set(self, v):
                self.v = v

            def get(self):
                return self.v

        box = Box.options(name="box").remote()
        rt.get(box.set.remote("kept"), timeout=GET_TIMEOUT_S)
        again = rt.get_actor("box")
        assert rt.get(again.get.remote(), timeout=GET_TIMEOUT_S) == "kept"


    def test_kill_then_call_raises(self, rt):
        @rt.remote
        class A:
            def ping(self):
                return "pong"

        a = A.remote()
        assert rt.get(a.ping.remote(), timeout=GET_TIMEOUT_S) == "pong"
        rt.kill(a)
        with pytest.raises(rt.exceptions.RayActorError):
            rt.get(a.ping.remote(), timeout=GET_TIMEOUT_S)


    def test_placement_group_reserve_release(self, rt):
        from_util = rt.util
        before = rt.available_resources()["CPU"]
        pg = from_util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=30)

        @rt.remote(num_cpus=1)
        def where():
            return "ran"

        strategy = from_util.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=1)
        assert rt.get(where.options(scheduling_strategy=strategy).remote(),
                      timeout=GET_TIMEOUT_S) == "ran"
        assert rt.available_resources()["CPU"] <= before - 2
        from_util.remove_placement_group(pg)
        deadline = time.time() + 30
        while rt.available_resources()["CPU"] < before and time.time() < deadline:
            time.sleep(0.1)
        assert rt.available_resources()["CPU"] == before


    def test_large_numpy_through_shared_memory(self, rt):
        a = np.random.RandomState(0).standard_normal(50_000)  # 400 KB
        ref = rt.put(a)
        got = rt.get(ref, timeout=GET_TIMEOUT_S)
        np.testing.assert_array_equal(got, a)

        @rt.remote
        def total(x):
            return float(x.sum()), x.shape

        assert rt.get(total.remote(ref), timeout=GET_TIMEOUT_S) == (float(a.sum()), a.shape)


# ---------------------------------------------------------- side by side


def test_both_runtimes_at_once_in_one_process():
    ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    try:
        assert os.environ["RAY_TPU_POOL_NAME"] != os.environ["RAY_TPU_TORCH_POOL_NAME"]
        a = np.arange(40_000, dtype=np.float64)
        results = {}
        for name, r in RUNTIMES.items():
            @r.remote
            def where():
                import sys

                return sorted(m for m in ("ray_tpu", "ray_tpu_torch") if m in sys.modules)

            @r.remote
            def pids():
                return os.getpid(), os.getppid()

            ref = r.put(a)
            results[name] = (r.get(ref, timeout=GET_TIMEOUT_S),
                             r.get(where.remote(), timeout=GET_TIMEOUT_S),
                             r.get(pids.remote(), timeout=GET_TIMEOUT_S))
        for name, (got, _, _) in results.items():
            np.testing.assert_array_equal(got, a)
        # Each runtime's workers run its own worker module and import
        # nothing of the other runtime.
        assert results["ray_tpu"][1] == ["ray_tpu"]
        assert results["ray_tpu_torch"][1] == ["ray_tpu_torch"]
        # Each runtime's clean-up pattern (`pkill -f`) finds its own live
        # worker and that worker's parent (the zygote), never the other's.
        patterns = {"ray_tpu": r"ray_tpu\._private", "ray_tpu_torch": r"ray_tpu_torch\._private"}
        found = {name: {int(p) for p in subprocess.run(
            ["pgrep", "-f", pattern], capture_output=True, text=True).stdout.split()}
            for name, pattern in patterns.items()}
        for name, (_, _, (pid, parent)) in results.items():
            other = "ray_tpu" if name == "ray_tpu_torch" else "ray_tpu_torch"
            assert {pid, parent} <= found[name], (name, pid, parent, found)
            assert not {pid, parent} & found[other], (name, pid, parent, found)
        assert "ray_tpu_torch._private.zygote" in open(
            f"/proc/{results['ray_tpu_torch'][2][1]}/cmdline").read()
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
    assert not ray_tpu.is_initialized() and not ray_tpu_torch.is_initialized()


def test_port_imports_nothing_of_the_reference():
    serve = ", ".join(["ray_tpu_torch.serve", "ray_tpu_torch.serve.schema"] + [
        f"ray_tpu_torch.serve._private.{m}" for m in (
            "common", "long_poll", "autoscaling_state", "deployment_state",
            "application_state", "replica", "controller", "router", "proxy", "grpc_proxy")])
    tooling = [
        "ray_tpu_torch.cluster_utils", "ray_tpu_torch.autoscaler",
        "ray_tpu_torch.autoscaler.gpu_hosts", "ray_tpu_torch.autoscaler.gce",
        "ray_tpu_torch.job_submission", "ray_tpu_torch.scripts.cli",
        "ray_tpu_torch.util.state", "ray_tpu_torch.util.rpdb",
        "ray_tpu_torch._private.head_main",
        # Imports aiohttp only where its server starts, so it imports
        # (and is checked) on a machine without aiohttp too.
        "ray_tpu_torch.dashboard",
    ]
    surface = [
        "ray_tpu_torch.dag", "ray_tpu_torch.dag.compiled_dag", "ray_tpu_torch.workflow",
        "ray_tpu_torch._private.channel", "ray_tpu_torch._private.posix_sem",
        "ray_tpu_torch._private.client_proxy", "ray_tpu_torch._private.runtime_env_plugins",
        "ray_tpu_torch.util.pubsub", "ray_tpu_torch.util.multiprocessing",
        "ray_tpu_torch.util.joblib", "ray_tpu_torch.experimental.tqdm_ray",
        "ray_tpu_torch._private.ray_perf", "ray_tpu_torch._private.native_tools",
        "ray_tpu_torch._lint", "ray_tpu_torch._lint.__main__", "ray_tpu_torch._lint.race",
    ]
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.train, ray_tpu_torch.tune, "
            "ray_tpu_torch.rllib, ray_tpu_torch.rllib.algorithms.ppo, ray_tpu_torch.convert, "
            f"{serve}, {', '.join(tooling + surface)}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ray_tpu', 'jax', 'flax', 'optax', 'orbax', 'tools')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=DEADLINE_S, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"


def test_port_builds_only_its_own_sources():
    """Every source the port compiles lies in `ray_tpu_torch/`: the object
    store's and the codec's (`_SRC` of `native_store` and `fastpath`), the
    C client's and the stress harness's (`native_tools`), and the CUDA
    kernels' (`ops._build.CSRC`); none is the reference's `native/`."""
    from ray_tpu_torch._private import fastpath, native_store, native_tools
    from ray_tpu_torch.ops import _build

    port = os.path.realpath(os.path.dirname(ray_tpu_torch.__file__)) + os.sep
    kernels = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    sources = [native_store._SRC, fastpath._SRC, *native_tools.sources(), *kernels]
    assert kernels and len(native_tools.sources()) == 5
    for src in sources:
        assert os.path.isfile(src), src
        assert os.path.realpath(src).startswith(port), src


# ------------------------------------------------------------------ tensors


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(64, 33, generator=g),
        "bf16": torch.randn(17, 5, generator=g).to(torch.bfloat16),
        "i64": torch.randint(-2**40, 2**40, (9,), generator=g),
        "noncontig": torch.randn(8, 6, generator=g).t()[::2],
        "scalar": torch.tensor(3.5, dtype=torch.float64),
        "empty": torch.empty(0, 4, dtype=torch.float16),
        "bool": torch.tensor([True, False, True]),
    }


def _assert_bitwise(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().view(-1).view(torch.uint8)
                       if got.numel() else got,
                       want.contiguous().view(-1).view(torch.uint8)
                       if want.numel() else want)


class TestOnePortCluster:
    """The port's names and its tensors through the object store."""

    def test_process_wide_names_are_the_ports_own(self, port, tmp_path, monkeypatch):
        import tempfile

        from ray_tpu_torch import train
        from ray_tpu_torch._private import object_store, usage_stats, worker
        from ray_tpu_torch._private.config import temp_root
        from ray_tpu_torch._private.ids import ObjectID

        assert os.environ["RAY_TPU_TORCH_POOL_NAME"].startswith("/rtpt_pool_")
        assert object_store.segment_name(ObjectID.from_random()).startswith("rtpt_")
        # Everything the runtime writes lies under its temp root, which
        # follows TMPDIR unless RAY_TPU_TORCH_TEMP_DIR says otherwise.
        if "RAY_TPU_TORCH_TEMP_DIR" not in os.environ:
            assert temp_root() == os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
        assert os.path.dirname(worker._global.node.session_dir) == temp_root()
        assert usage_stats._sink_path() == os.path.join(temp_root(), "usage_stats.jsonl")
        monkeypatch.setenv("RAY_TPU_TORCH_TEMP_DIR", str(tmp_path))
        result = train.TorchTrainer(
            lambda: train.report({"ok": 1}),
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
            run_config=train.RunConfig(name="default_storage")).fit()
        assert result.error is None and result.metrics == {"ok": 1}
        assert result.path == str(tmp_path / "results" / "default_storage")
        assert os.path.isdir(result.path)


    @pytest.mark.parametrize("name", sorted(_tensors()))
    def test_tensor_put_get_bitwise(self, port, name):
        t = _tensors()[name]
        _assert_bitwise(port.get(port.put(t), timeout=GET_TIMEOUT_S), t)


    def test_tensors_nested_in_args_and_returns(self, port):
        tensors = _tensors()

        @port.remote
        def echo(d, scale):
            out = {k: v for k, v in d.items()}
            out["scaled"] = d["f32"] * scale
            return out, [d["bf16"], (d["i64"],)]

        out, rest = port.get(echo.remote(tensors, 2.0), timeout=GET_TIMEOUT_S)
        for k, v in tensors.items():
            _assert_bitwise(out[k], v)
        _assert_bitwise(out["scaled"], tensors["f32"] * 2.0)
        _assert_bitwise(rest[0], tensors["bf16"])
        _assert_bitwise(rest[1][0], tensors["i64"])


    def test_gotten_tensor_is_a_private_copy(self, port):
        t = torch.arange(100_000, dtype=torch.float32)  # through shared memory
        ref = port.put(t)
        a = port.get(ref, timeout=GET_TIMEOUT_S)
        a.zero_()  # writable, and writing it leaves the sealed object as it was
        _assert_bitwise(port.get(ref, timeout=GET_TIMEOUT_S), t)


def test_parameter_and_grad_flag_survive():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.ones(2).requires_grad_()
    got = serialization.unpack(serialization.pack({"p": p, "q": q}))
    assert type(got["p"]) is torch.nn.Parameter and got["p"].requires_grad
    assert got["q"].requires_grad and type(got["q"]) is torch.Tensor


def test_64mib_tensor_is_one_out_of_band_buffer():
    t = torch.zeros(32 * 1024 * 1024, dtype=torch.bfloat16)  # 64 MiB
    payload, buffers = serialization.dumps(t)
    assert len(payload) < 4096
    assert len(buffers) == 1 and len(buffers[0].raw()) == 64 * 1024 * 1024
    got = serialization.unpack(serialization.pack(t))
    _assert_bitwise(got, t)


def test_torch_save_is_unaffected_by_the_reducer(tmp_path):
    # The reducer lives in the port's pickler, not in copyreg.
    serialization.dumps(torch.ones(2))
    path = tmp_path / "t.pt"
    torch.save({"w": torch.arange(4)}, path)
    assert torch.equal(torch.load(path)["w"], torch.arange(4))


# ------------------------------------------------------------------- GPUs


@pytest.fixture
def two_fake_gpus(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "2")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_gpu_actors_see_disjoint_devices(two_fake_gpus):
    rt = two_fake_gpus
    assert rt.cluster_resources()["GPU"] == 2.0

    @rt.remote(num_gpus=1)
    class OnCard:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    a, b = OnCard.remote(), OnCard.remote()
    seen = rt.get([a.visible.remote(), b.visible.remote()], timeout=GET_TIMEOUT_S)
    assert sorted(seen) == ["0", "1"]
    # A third waits for a card, and takes the one a killed actor held.
    c = OnCard.remote()
    ref = c.visible.remote()
    ready, _ = rt.wait([ref], timeout=3)
    assert not ready
    rt.kill(a)
    assert rt.get(ref, timeout=GET_TIMEOUT_S) == seen[0]


def test_cpu_workers_see_no_device(two_fake_gpus):
    rt = two_fake_gpus

    @rt.remote
    def visible():
        import torch

        return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count()

    assert rt.get(visible.remote(), timeout=GET_TIMEOUT_S) == ("", 0)


def test_num_gpus_maps_to_the_gpu_resource():
    from ray_tpu_torch._private.submit import resources_from_options

    assert resources_from_options({"num_gpus": 1}) == {"CPU": 1.0, "GPU": 1.0}
    assert resources_from_options({"num_tpus": 2}, is_actor=True) == {"TPU": 2.0}


def test_gpu_count_never_starts_cuda(monkeypatch):
    from ray_tpu_torch._private.accelerators import gpu

    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS", raising=False)
    monkeypatch.setattr(gpu, "_count_physical", lambda: 4)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert gpu.GPUAcceleratorManager.get_current_node_num_accelerators() == 2
    assert gpu.GPUAcceleratorManager.node_device_ids(2) == ["2", "3"]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu.GPUAcceleratorManager.get_current_node_num_accelerators() == 4
    assert gpu.GPUAcceleratorManager.node_device_ids(2) == ["0", "1"]
    code = ("import torch, ray_tpu_torch._private.zygote, "
            "ray_tpu_torch._private.accelerators.gpu as g; "
            "g.GPUAcceleratorManager.get_current_node_num_accelerators(); "
            "print(torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=DEADLINE_S, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"


def test_node_daemon_gives_gpu_workers_their_own_cards(tmp_path):
    """A node daemon (`_private.raylet`) with 2 GPUs joins a head without
    any: the head routes each one-GPU actor's spawn to it, and the daemon
    pins each worker to a card of its own. Its logs go under its temp
    root."""
    import json

    from ray_tpu_torch._private import worker

    ray_tpu_torch.init(num_cpus=1, num_gpus=0, tcp_port=0)
    node = worker._global.node
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    daemon = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.raylet",
         "--address", node.tcp_address, "--authkey", node.authkey.hex(),
         "--resources", json.dumps({"CPU": 2, "GPU": 2}),
         "--transfer-host", "127.0.0.1"],
        env={**os.environ, "PYTHONPATH": repo, "RAY_TPU_TORCH_TEMP_DIR": str(tmp_path)},
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 30
        while len(ray_tpu_torch.nodes()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0

        @ray_tpu_torch.remote(num_gpus=1)
        class OnCard:
            def visible(self):
                return os.environ.get("CUDA_VISIBLE_DEVICES")

        actors = [OnCard.remote() for _ in range(2)]
        seen = ray_tpu_torch.get([a.visible.remote() for a in actors],
                                 timeout=GET_TIMEOUT_S)
        assert sorted(seen) == ["0", "1"]
        assert len(os.listdir(tmp_path / "raylet_logs")) == 1
    finally:
        # The head's shutdown stops the daemon, which then destroys its
        # shm pool; a signal in the middle of that would leak the pool.
        ray_tpu_torch.shutdown()
        try:
            daemon.wait(timeout=10)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()


def test_profile_runtime_rehearses_on_the_cpu(capsys):
    """`python -m ray_tpu_torch.profile_runtime --device cpu`: the step in
    process, in a fresh thread and in a trainer worker with the CPU of
    the loop's thread, and the object plane's parts."""
    import json

    from ray_tpu_torch import profile_runtime

    assert profile_runtime.main(["--device", "cpu", "--fits", "1", "--mib", "1",
                                 "--seq", "32"]) == 0
    out = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    assert not ray_tpu_torch.is_initialized()
    assert set(out["object_plane"]) >= {"device_to_host", "put", "get_here", "get_in_actor"}
    for where, thread in (("in_process", "MainThread"), ("in_thread", None),
                          ("trainer_0", None)):
        result = out[where]
        assert len(result["rounds"]) == profile_runtime.ROUNDS
        assert thread is None or result["thread"] == thread
        for r in result["rounds"]:
            assert r["losses"][-1] < r["losses"][0]
            usage = r["usage"]
            assert usage["loop_thread_cpu_s"] > 0
            assert any(t["thread"] == result["thread"] for t in usage["threads"])
    # The trainer's loop runs in a thread of the worker, not in its main thread.
    assert out["trainer_0"]["thread"] != "MainThread"


def test_profile_runtime_steps_the_cpu_rehearsal_on_one_thread(monkeypatch):
    """The rehearsal's steps run on one intra-op thread, and the process's
    pool size comes back after. With a pool of every core, each of the
    suite's parallel workers spun against the others, and the test above
    ran eight times slower on a loaded host (past its deadline)."""
    from ray_tpu_torch import bench, profile_runtime

    seen = []
    real = bench.bench_model

    def counting(*args, **kwargs):
        seen.append(torch.get_num_threads())
        return real(*args, **kwargs)

    monkeypatch.setattr(bench, "bench_model", counting)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = profile_runtime.build_and_step(
            {"model": "llama-tiny", "batch": 1, "seq": 16, "device": "cpu"})
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(threads)
    assert seen == [1] * profile_runtime.ROUNDS
    assert len(out["rounds"]) == profile_runtime.ROUNDS
