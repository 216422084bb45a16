"""The port's object lifetime: distributed reference counting and lineage
reconstruction: tests/test_object_lifetime.py, case for case, on the
port's runtime. Every test has a deadline after which it fails instead
of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Distributed refcounting + lineage reconstruction.

Reference behaviors modeled: reference_count.h:61 (instance counting,
refs-inside-objects pinning), object_recovery_manager.h:41 +
task_manager.h:269 (owner resubmits the producing task when the data is
lost), worker_killing/eviction interplay.
"""
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import _global, global_client
from torch_runtime_cases import daemon_shm  # noqa: F401 - a fixture

DEADLINE_S = 120
GET_TIMEOUT_S = 60


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
def ray_start():
    """A fresh local cluster of 4 CPUs per test (the reference's
    conftest `ray_start`)."""
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


BIG = 300_000  # floats, ~2.4 MB serialized: forced to the shm store


@pytest.fixture
def ray4():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _directory_size():
    return len(_global.node.gcs.objects)


def _entry(ref):
    return _global.node.gcs.objects.get(ref.id().binary())


def _flush_refs():
    client = global_client()
    client._tracker.flush(client)


def test_auto_free_on_last_ref_drop(ray4):
    @ray_tpu_torch.remote
    def make():
        return np.zeros(BIG)

    ref = make.remote()
    _ = ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)
    _flush_refs()  # add_ref lands
    assert _entry(ref) is not None
    oid = ref.id()
    del ref
    import gc

    gc.collect()
    _flush_refs()  # removal lands -> directory reclaims
    deadline = time.time() + 5
    while time.time() < deadline:
        if _global.node.gcs.objects.get(oid.binary()) is None:
            break
        time.sleep(0.05)
    assert _global.node.gcs.objects.get(oid.binary()) is None
    # The shm data is gone too.
    assert not global_client().store.contains(oid)


def test_put_object_freed_when_ref_dies(ray4):
    arr = np.random.rand(BIG)
    ref = ray_tpu_torch.put(arr)
    _flush_refs()
    oid = ref.id()
    del ref
    import gc

    gc.collect()
    _flush_refs()
    deadline = time.time() + 5
    while time.time() < deadline:
        if _global.node.gcs.objects.get(oid.binary()) is None:
            break
        time.sleep(0.05)
    assert _global.node.gcs.objects.get(oid.binary()) is None


def test_dep_pinned_while_task_in_flight(ray4):
    # The driver drops its ref the instant the dependent task is
    # submitted; the task-dependency pin must keep the object alive
    # until the consumer has run.
    @ray_tpu_torch.remote
    def consume(a):
        time.sleep(0.5)
        return float(np.sum(a))

    arr = np.random.rand(BIG)
    ref = ray_tpu_torch.put(arr)
    _flush_refs()
    out = consume.remote(ref)
    del ref
    import gc

    gc.collect()
    _flush_refs()
    assert abs(ray_tpu_torch.get(out, timeout=30) - arr.sum()) < 1e-6


def test_nested_refs_pin_children(ray4):
    # A stored value embedding refs keeps the children alive even after
    # the driver drops them (borrowing: refs inside objects).
    inner = ray_tpu_torch.put(np.arange(BIG, dtype=np.float64))
    outer = ray_tpu_torch.put({"data": inner})
    _flush_refs()
    inner_oid = inner.id()
    del inner
    import gc

    gc.collect()
    _flush_refs()
    time.sleep(0.3)
    assert _global.node.gcs.objects.get(inner_oid.binary()) is not None
    got = ray_tpu_torch.get(outer, timeout=GET_TIMEOUT_S)
    inner_val = ray_tpu_torch.get(got["data"], timeout=GET_TIMEOUT_S)
    assert inner_val[BIG - 1] == BIG - 1
    # Dropping the outer (and the borrowed handle) releases the chain.
    del outer, got, inner_val
    gc.collect()
    _flush_refs()
    deadline = time.time() + 5
    while time.time() < deadline:
        if _global.node.gcs.objects.get(inner_oid.binary()) is None:
            break
        time.sleep(0.05)
    assert _global.node.gcs.objects.get(inner_oid.binary()) is None


def test_reconstruction_after_data_eviction(ray4):
    # Simulate memory-pressure eviction: the store's copy vanishes while
    # the directory still says READY; get() must resubmit the producing
    # task from lineage and return the value.
    @ray_tpu_torch.remote
    def produce(seed):
        return np.random.default_rng(seed).random(BIG)

    ref = produce.remote(42)
    first = ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S).copy()
    # Evict: drop the sealed bytes everywhere (directory entry kept).
    gcs = _global.node.gcs
    entry = _entry(ref)
    assert entry is not None and entry.segment is not None
    from ray_tpu_torch._private.ids import ObjectID

    gcs._store.delete(ref.id())
    client = global_client()
    client.store.delete(ref.id())
    assert not client.store.contains(ref.id())
    # Reconstruct through lineage.
    second = ray_tpu_torch.get(ref, timeout=60)
    assert np.allclose(second, first)


def test_reconstruction_when_node_dies_with_only_copy(daemon_shm):
    from ray_tpu_torch.cluster_utils import DaemonCluster

    cluster = DaemonCluster(head_node_args={"num_cpus": 2, "tcp_port": 0})
    try:
        # Two interchangeable daemons: the task can run on either, so
        # reconstruction has somewhere to go after one dies.
        proc_a = cluster.add_node(num_cpus=2, resources={"spot": 1.0}, label="a")
        proc_b = cluster.add_node(num_cpus=2, resources={"spot": 1.0}, label="b")

        @ray_tpu_torch.remote
        def produce(seed):
            return np.random.default_rng(seed).random(BIG)

        ref = produce.options(resources={"spot": 0.01}, max_retries=3).remote(7)
        expected = np.random.default_rng(7).random(BIG)
        # Seal on one daemon but do NOT pull it anywhere else yet.
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
        assert ready
        entry = _global.node.gcs.objects[ref.id().binary()]
        assert entry.segment is not None
        holder_label = {
            n["node_id"]: n["label"] for n in ray_tpu_torch.nodes()
        }[entry.node_id.binary()]
        victim = proc_a if holder_label == "a" else proc_b
        cluster.kill_node(victim)
        # Wait for the GCS to declare the node (and the object) lost.
        deadline = time.time() + 15
        while time.time() < deadline:
            if _global.node.gcs.objects[ref.id().binary()].status == "LOST":
                break
            time.sleep(0.2)
        # The only copy died with the node: get() must reconstruct by
        # re-running the producing task on the surviving daemon.
        got = ray_tpu_torch.get(ref, timeout=60)
        assert np.allclose(got, expected)
    finally:
        cluster.shutdown()


def test_fast_dropped_result_is_reclaimed(ray_start):
    """A task result whose ref lives for less than one ref-flush window
    must still be freed server-side (owner return-refs are advertised
    at submission, so the drop's remove always goes out)."""
    import time

    from ray_tpu_torch._private.worker import _global

    @ray_tpu_torch.remote
    def quick():
        return list(range(1000))

    oids = []
    for _ in range(5):
        ref = quick.remote()
        assert len(ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)) == 1000
        oids.append(ref.id().binary())
        del ref  # dropped well inside the 100ms flush window
    gcs = _global.node.gcs
    deadline = time.time() + 10
    while time.time() < deadline:
        live = [o for o in oids if gcs.objects.get(o) is not None]
        if not live:
            break
        time.sleep(0.2)
    assert not live, f"{len(live)} fast-dropped results leaked"


def test_drop_racing_delayed_task_done_is_reclaimed():
    """The owner's ref-drop can reach the directory BEFORE the worker's
    batched task_done creates the entry (leased path: return refs are
    advertised client-side only, and under load the 4ms done-batch can
    land after the 100ms ref flush). The early-drop ledger
    (gcs._early_drops) must reclaim the result at seal time — observed
    leaking 1-in-5 under a loaded full-suite run before the fix."""
    import time

    from ray_tpu_torch._private.worker import _global

    ray_tpu_torch.init(
        num_cpus=2,
        # Delay every done-batch 150ms at the GCS: the driver's ref
        # flush (100ms) now reliably wins the race the wild run hit
        # intermittently.
        _system_config={
            "testing_rpc_delay_us": "task_done_batch=150000:150000"
        },
    )
    try:
        @ray_tpu_torch.remote
        def quick():
            return list(range(500))

        # Warm a leased worker so subsequent calls ride the direct path.
        ray_tpu_torch.get(quick.remote(), timeout=GET_TIMEOUT_S)
        oids = []
        for _ in range(5):
            ref = quick.remote()
            assert len(ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)) == 500
            oids.append(ref.id().binary())
            del ref
        gcs = _global.node.gcs
        deadline = time.time() + 15
        while time.time() < deadline:
            live = [o for o in oids if gcs.objects.get(o) is not None]
            if not live:
                break
            time.sleep(0.2)
        assert not live, (
            f"{len(live)} results leaked past the early-drop ledger"
        )
    finally:
        ray_tpu_torch.shutdown()
