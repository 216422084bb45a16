"""The port's graceful node drain: tests/test_drain.py, case for case,
on the port's runtime and its `cluster_utils`; every test has a deadline
after which it fails instead of hanging, and every `get` a timeout.

The reference's docstring: graceful node drain (reference:
node_manager.h:551 HandleDrainRaylet, autoscaler DrainNode-before-
terminate). Drain semantics under test: no new placements on a draining
node, running work finishes before removal, the deadline forces removal,
and the autoscaler's idle scale-down path drains instead of yanking
nodes.
"""
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster

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
def two_nodes():
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, label="b")
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


@ray_tpu_torch.remote
def _hold(sec: float):
    time.sleep(sec)
    return "done"


def _node(label):
    return next(n for n in ray_tpu_torch.nodes() if n["label"] == label)


def _wait(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def test_drain_removes_quiet_node(two_nodes):
    b = _node("b")
    assert ray_tpu_torch.drain_node(b["node_id"], reason="test") is True
    # Quiet node: removed promptly by the health loop's drain tick.
    assert _wait(
        lambda: all(
            n["node_id"] != b["node_id"] or not n["alive"]
            for n in ray_tpu_torch.nodes()
        )
    ), "drained node was not removed"


def test_drain_waits_for_running_task(two_nodes):
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    b = _node("b")
    ref = _hold.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=b["node_id"], soft=False
        )
    ).remote(4.0)
    # Wait until the task holds b's CPU.
    assert _wait(
        lambda: _node("b")["available"].get("CPU", 2) < 2
    ), "task never started on b"
    t0 = time.time()
    assert ray_tpu_torch.drain_node(
        b["node_id"], reason="test", deadline_s=30.0
    )
    # The running task completes normally (not killed).
    assert ray_tpu_torch.get(ref, timeout=30) == "done"
    # ... and only then is the node removed.
    assert _wait(
        lambda: all(
            n["node_id"] != b["node_id"] or not n["alive"]
            for n in ray_tpu_torch.nodes()
        )
    )
    assert time.time() - t0 >= 2.0, "node removed before its task finished"


def test_drain_rejects_new_placements(two_nodes):
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    b = _node("b")
    ray_tpu_torch.drain_node(b["node_id"], reason="test", deadline_s=60.0)
    # Hard affinity to a draining node can never be satisfied.
    ref = _hold.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=b["node_id"], soft=False
        )
    ).remote(0.1)
    with pytest.raises(ray_tpu_torch.exceptions.TaskUnschedulableError):
        ray_tpu_torch.get(ref, timeout=15)


def test_drain_deadline_forces_removal(two_nodes):
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    b = _node("b")
    ref = _hold.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=b["node_id"], soft=False
        )
    ).remote(60.0)
    assert _wait(lambda: _node("b")["available"].get("CPU", 2) < 2)
    ray_tpu_torch.drain_node(b["node_id"], reason="preempt", deadline_s=1.0)
    assert _wait(
        lambda: all(
            n["node_id"] != b["node_id"] or not n["alive"]
            for n in ray_tpu_torch.nodes()
        ),
        timeout=20,
    ), "deadline did not force removal"
    # The interrupted task surfaces a worker-death error.
    with pytest.raises(
        (
            ray_tpu_torch.exceptions.WorkerCrashedError,
            ray_tpu_torch.exceptions.RayTaskError,
        )
    ):
        ray_tpu_torch.get(ref, timeout=20)


def test_autoscaler_drains_idle_nodes():
    from ray_tpu_torch.autoscaler import Autoscaler, FakeNodeProvider

    ray_tpu_torch.init(num_cpus=1, ignore_reinit_error=True)
    try:
        provider = FakeNodeProvider()
        asc = Autoscaler(
            {"cpu": {"resources": {"CPU": 2.0}, "max_workers": 2}},
            provider,
            idle_timeout_s=1.0,
        )
        # Force demand: a task shape the 1-CPU head can't take.
        ref = _hold.options(num_cpus=2).remote(2.0)
        deadline = time.time() + 20
        while time.time() < deadline and asc.num_launches == 0:
            asc.update()
            time.sleep(0.2)
        assert asc.num_launches >= 1
        assert ray_tpu_torch.get(ref, timeout=30) == "done"
        # Idle scale-down goes through drain, then releases the node.
        deadline = time.time() + 30
        while time.time() < deadline and asc.num_terminations == 0:
            asc.update()
            time.sleep(0.2)
        assert asc.num_terminations >= 1
        assert provider.non_terminated_nodes() == []
    finally:
        ray_tpu_torch.shutdown()
