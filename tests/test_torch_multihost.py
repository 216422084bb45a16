"""The port's multi-host control and data plane: tests/test_multihost.py,
case for case, on the port's runtime and its `cluster_utils`; every test
has a deadline after which it fails instead of hanging, and every `get`
a timeout. The reference's JaxTrainer case becomes a TorchTrainer whose
two workers, on two daemon nodes, form one gloo process group; then the
daemon's `num_gpus`, which pins its GPU workers to their cards.

The reference's docstring: multi-host control + data plane: real
node-daemon processes over TCP.

Reference behaviors modeled: raylet registration with the GCS
(src/ray/gcs/gcs_server — node membership), cross-node scheduling, and
chunked node-to-node object transfer
(src/ray/object_manager/object_manager.h:63,117). The daemons run as
separate processes on this machine with their own shm pools and
namespaces, so a cross-node `get` must ride the transfer plane exactly
as it would between two hosts.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import DaemonCluster

BIG = 1 << 20  # > max_inline_object_size: forces the shm/transfer path
DEADLINE_S = 150


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def daemon_cluster():
    cluster = DaemonCluster(head_node_args={"num_cpus": 1, "tcp_port": 0})
    yield cluster
    cluster.shutdown()


@ray_tpu_torch.remote
def whereami():
    return os.environ.get("RAY_TPU_TORCH_NODE_NS", "head")


@ray_tpu_torch.remote
def make_big(seed):
    rng = np.random.default_rng(seed)
    return rng.random(BIG // 8)  # ~1 MiB of float64


@ray_tpu_torch.remote
def consume(arr):
    return float(arr.sum())


def test_daemons_register_and_run_tasks(daemon_cluster):
    daemon_cluster.add_node(num_cpus=2, resources={"node_a": 1.0}, label="a")
    daemon_cluster.add_node(num_cpus=2, resources={"node_b": 1.0}, label="b")
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU", 0) >= 5.0
    assert total.get("node_a") == 1.0 and total.get("node_b") == 1.0

    # Tasks pinned to each daemon node run in that daemon's namespace
    # (i.e. in a worker spawned by that daemon, not by the head).
    ns_a = ray_tpu_torch.get(
        whereami.options(resources={"node_a": 0.01}).remote(), timeout=60
    )
    ns_b = ray_tpu_torch.get(
        whereami.options(resources={"node_b": 0.01}).remote(), timeout=60
    )
    assert ns_a not in ("head", ns_b)


def test_cross_node_object_transfer(daemon_cluster):
    daemon_cluster.add_node(num_cpus=2, resources={"node_a": 1.0})
    daemon_cluster.add_node(num_cpus=2, resources={"node_b": 1.0})

    # Seal a large object on node A, read it from the driver (pull #1)
    # and from node B (pull #2) — three distinct stores.
    ref = make_big.options(resources={"node_a": 0.01}).remote(7)
    expected = np.random.default_rng(7).random(BIG // 8)
    got = ray_tpu_torch.get(ref, timeout=60)
    assert np.allclose(got, expected)

    total = ray_tpu_torch.get(
        consume.options(resources={"node_b": 0.01}).remote(ref), timeout=60
    )
    assert abs(total - expected.sum()) < 1e-6


def test_driver_object_pulled_by_remote_node(daemon_cluster):
    daemon_cluster.add_node(num_cpus=2, resources={"node_a": 1.0})
    arr = np.random.default_rng(3).random(BIG // 8)
    ref = ray_tpu_torch.put(arr)  # sealed into the head store
    total = ray_tpu_torch.get(
        consume.options(resources={"node_a": 0.01}).remote(ref), timeout=60
    )
    assert abs(total - arr.sum()) < 1e-6


def test_scheduling_spills_to_free_node(daemon_cluster):
    # Head has 1 CPU; 8 concurrent 2-CPU tasks only fit on the daemon.
    daemon_cluster.add_node(num_cpus=4, resources={"node_a": 1.0})

    @ray_tpu_torch.remote(num_cpus=2)
    def ns():
        return os.environ.get("RAY_TPU_TORCH_NODE_NS", "head")

    spots = ray_tpu_torch.get([ns.remote() for _ in range(8)], timeout=120)
    assert all(s != "head" for s in spots)


def test_node_death_detected(daemon_cluster):
    proc = daemon_cluster.add_node(num_cpus=2, resources={"node_a": 1.0})
    assert ray_tpu_torch.cluster_resources().get("node_a") == 1.0

    @ray_tpu_torch.remote
    def sleepy():
        from ray_tpu_torch._private.worker import global_client

        global_client().kv_put(b"sleepy_started", b"1")
        time.sleep(60)

    ref = sleepy.options(resources={"node_a": 0.01}, max_retries=0).remote()
    # Only kill once the task is actually running on the daemon's worker —
    # killed-while-pending would (correctly) leave it queued as infeasible.
    from ray_tpu_torch._private.worker import global_client

    deadline = time.time() + 30
    while time.time() < deadline:
        if global_client().kv_get(b"sleepy_started"):
            break
        time.sleep(0.1)
    else:
        raise TimeoutError("task never started on the daemon node")
    daemon_cluster.kill_node(proc)
    with pytest.raises(ray_tpu_torch.exceptions.WorkerCrashedError):
        ray_tpu_torch.get(ref, timeout=30)
    deadline = time.time() + 10
    while time.time() < deadline:
        if ray_tpu_torch.cluster_resources().get("node_a", 0) == 0:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.cluster_resources().get("node_a", 0) == 0


def test_remote_driver_over_tcp(daemon_cluster):
    # A second driver process connects over host:port?authkey, submits
    # work, and round-trips a large object both directions.
    script = """
import sys
import numpy as np
import ray_tpu_torch

address = sys.argv[1]
ray_tpu_torch.init(address=address)

@ray_tpu_torch.remote
def double(a):
    return a * 2

arr = np.arange(300_000, dtype=np.float64)
out = ray_tpu_torch.get(double.remote(arr), timeout=60)
assert np.allclose(out, arr * 2)
print("REMOTE-DRIVER-OK")
"""
    addr = f"{daemon_cluster.head_address}?{daemon_cluster.authkey.hex()}"
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("RAY_TPU_TORCH_POOL_NAME", "RAY_TPU_TORCH_NODE_NS")
    }
    out = subprocess.run(
        [sys.executable, "-c", script, addr],
        capture_output=True,
        timeout=120,
        env=env,
    )
    assert b"REMOTE-DRIVER-OK" in out.stdout, out.stderr.decode(errors="replace")


def test_torch_distributed_train_across_daemon_nodes(daemon_cluster, tmp_path):
    # Two TorchTrainer workers on two different daemon nodes form one
    # torch.distributed process group (gloo on the CPU), and an
    # all-reduce crosses the process boundary (the reference's case runs
    # a JaxTrainer over jax.distributed; reference: torch-XLA backend
    # train/torch/xla/config.py:73 dist.init_process_group).
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    daemon_cluster.add_node(num_cpus=2, resources={"slot": 1.0})
    daemon_cluster.add_node(num_cpus=2, resources={"slot": 1.0})

    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        out = torch.ones(1)
        dist.all_reduce(out)
        rt_train.report(
            {
                "world_size": dist.get_world_size(),
                "backend": dist.get_backend(),
                "global_sum": float(out[0]),
                "node_ns": os.environ.get("RAY_TPU_TORCH_NODE_NS", "head"),
            }
        )

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(
            num_workers=2,
            resources_per_worker={"slot": 1.0, "CPU": 1.0},
            use_torch_distributed=True,
        ),
        run_config=RunConfig(storage_path=str(tmp_path / "mh_train")),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["world_size"] == 2
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["global_sum"] == 2.0
    assert result.metrics["node_ns"] != "head"


def test_hung_node_declared_dead_by_heartbeat(daemon_cluster):
    # SIGSTOP the daemon: its TCP connection stays established but
    # heartbeats stop; the GCS health loop must declare the node dead
    # (reference: gcs_health_check_manager.h:39).
    import signal

    proc = daemon_cluster.add_node(num_cpus=2, resources={"node_a": 1.0})
    assert ray_tpu_torch.cluster_resources().get("node_a") == 1.0
    os.kill(proc.pid, signal.SIGSTOP)
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            if ray_tpu_torch.cluster_resources().get("node_a", 0) == 0:
                break
            time.sleep(0.3)
        assert ray_tpu_torch.cluster_resources().get("node_a", 0) == 0
    finally:
        os.kill(proc.pid, signal.SIGCONT)
        daemon_cluster.kill_node(proc)


def test_daemon_num_gpus_pins_gpu_workers_to_their_cards(daemon_cluster):
    # `add_node(num_gpus=2)` starts the daemon with `--num-gpus 2`: the
    # node holds GPU 2, and each num_gpus=1 worker it runs sees its own
    # card through CUDA_VISIBLE_DEVICES (no card is touched here).
    daemon_cluster.add_node(num_cpus=2, num_gpus=2, resources={"gpu_node": 1.0})
    node = next(n for n in ray_tpu_torch.nodes()
                if n["total"].get("gpu_node") == 1.0)
    assert node["total"]["GPU"] == 2.0

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES"), os.environ.get(
                "RAY_TPU_TORCH_NODE_ID")

    holders = [Holder.remote() for _ in range(2)]
    seen = ray_tpu_torch.get([h.visible.remote() for h in holders], timeout=60)
    assert sorted(v for v, _ in seen) == ["0", "1"]
    assert {nid for _, nid in seen} == {node["node_id"].hex()}


def test_a_sigterm_during_a_pushed_shutdown_leaves_no_pool(daemon_cluster):
    # A drained node's daemon runs the shutdown the head pushes on a
    # reader thread; a SIGTERM that lands meanwhile (a provider
    # terminating the host) must not end the process before that
    # shutdown has destroyed the node's shm pool. Pinned divergence:
    # the reference's signal handler exits at once and leaves it.
    proc = daemon_cluster.add_node(num_cpus=2, resources={"node_a": 1.0}, label="a")

    @ray_tpu_torch.remote
    def pool_name():
        return os.environ["RAY_TPU_TORCH_POOL_NAME"]

    pool = ray_tpu_torch.get(
        pool_name.options(resources={"node_a": 0.01}).remote(), timeout=60
    ).lstrip("/")
    assert os.path.exists(f"/dev/shm/{pool}")
    node = next(n for n in ray_tpu_torch.nodes() if n["label"] == "a")
    assert ray_tpu_torch.drain_node(node["node_id"], reason="test", deadline_s=30.0)
    deadline = time.time() + 30
    while time.time() < deadline and any(
        n["node_id"] == node["node_id"] and n["alive"] for n in ray_tpu_torch.nodes()
    ):
        time.sleep(0.01)
    proc.send_signal(signal.SIGTERM)  # the head's shutdown is in flight
    proc.wait(timeout=30)
    assert not os.path.exists(f"/dev/shm/{pool}")


_SLOW_INIT_DAEMON = """
import sys, time
from ray_tpu_torch._private.accelerators import gpu
ids = gpu.GPUAcceleratorManager.node_device_ids
# Slow the constructor after registration: the head's spawn for the
# waiting demand arrives before the card ids exist.
gpu.GPUAcceleratorManager.node_device_ids = staticmethod(
    lambda n: (time.sleep(2.0), ids(n))[1])
from ray_tpu_torch._private import raylet
raylet.main(sys.argv[1:])
"""


def test_work_pushed_before_the_daemon_is_built_waits_for_it(daemon_cluster):
    # A num_gpus=1 task waits at the head for a GPU node (as it does
    # under an autoscaler); the node that joins is pushed its spawn the
    # moment it registers. The daemon holds the push until its
    # constructor has finished. Pinned divergence: the reference's
    # reader thread raises AttributeError there, its connection closes
    # and the node dies and rejoins as a new one.
    from ray_tpu_torch._private.worker import global_client

    global_client().request({"type": "set_autoscaling", "enabled": True})

    @ray_tpu_torch.remote(num_gpus=1)
    def where():
        return os.environ.get("RAY_TPU_TORCH_NODE_ID"), os.environ.get(
            "CUDA_VISIBLE_DEVICES")

    ref = where.remote()
    proc = subprocess.Popen(
        [sys.executable, "-c", _SLOW_INIT_DAEMON,
         "--address", daemon_cluster.head_address,
         "--authkey", daemon_cluster.authkey.hex(),
         "--num-cpus", "1", "--num-gpus", "1", "--label", "late",
         "--transfer-host", "127.0.0.1"],
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        node_id, visible = ray_tpu_torch.get(ref, timeout=60)
        late = [n for n in ray_tpu_torch.nodes() if n["label"] == "late"]
        assert [n["alive"] for n in late] == [True], late
        assert node_id == late[0]["node_id"].hex() and visible == "0"
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    assert b"AttributeError" not in err, err.decode(errors="replace")
