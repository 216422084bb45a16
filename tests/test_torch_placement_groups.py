"""The port's placement groups and multi-node resource scheduling:
tests/test_placement_groups.py, case for case, on the port's runtime.
Every test has a deadline after which it fails instead of hanging, and
every `get` and `wait` a timeout.

The reference's docstring:

Placement groups + multi-node resource scheduling.

Models the reference's python/ray/tests/test_placement_group.py and the
Cluster-in-one-process harness (cluster_utils.py:135).
"""
import pytest
import signal

import ray_tpu_torch
from ray_tpu_torch.exceptions import PlacementGroupSchedulingError
from ray_tpu_torch.util import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)

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


def test_pg_create_ready(ray_start):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(10)
    assert pg.bundle_count == 2
    remove_placement_group(pg)


def test_pg_reserves_resources(ray_start):
    pg = placement_group([{"CPU": 3}], strategy="PACK")
    assert ray_tpu_torch.available_resources().get("CPU", 0) == 1.0
    remove_placement_group(pg)
    assert ray_tpu_torch.available_resources().get("CPU", 0) == 4.0


def test_pg_unschedulable(ray_start):
    with pytest.raises(PlacementGroupSchedulingError):
        placement_group([{"CPU": 100}], strategy="STRICT_PACK")


def test_task_in_pg(ray_start):
    pg = placement_group([{"CPU": 2}], strategy="PACK")

    @ray_tpu_torch.remote(num_cpus=2)
    def f():
        return "in-bundle"

    strategy = PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0
    )
    ref = f.options(scheduling_strategy=strategy).remote()
    assert ray_tpu_torch.get(ref, timeout=30) == "in-bundle"
    remove_placement_group(pg)


def test_actor_in_pg(ray_start):
    pg = placement_group([{"CPU": 1}], strategy="PACK")

    @ray_tpu_torch.remote(num_cpus=1)
    class A:
        def ping(self):
            return "pong"

    a = A.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        )
    ).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"


def test_pg_bundle_capacity_enforced(ray_start):
    pg = placement_group([{"CPU": 1}], strategy="PACK")

    @ray_tpu_torch.remote(num_cpus=1)
    def hold():
        import time

        time.sleep(0.5)
        return 1

    strategy = PlacementGroupSchedulingStrategy(placement_group=pg)
    # Two 1-CPU tasks against a 1-CPU bundle must serialize.
    import time

    r1 = hold.options(scheduling_strategy=strategy).remote()
    r2 = hold.options(scheduling_strategy=strategy).remote()
    start = time.monotonic()
    ray_tpu_torch.get([r1, r2], timeout=60)
    assert time.monotonic() - start >= 0.8


def test_strict_spread_fails_single_node(ray_start):
    # One node: STRICT_SPREAD of 2 bundles cannot be placed.
    with pytest.raises(PlacementGroupSchedulingError):
        placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
