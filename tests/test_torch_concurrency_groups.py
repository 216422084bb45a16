"""The port's actor concurrency groups: tests/test_concurrency_groups.py,
case for case, on the port's runtime. Every test has a deadline after
which it fails instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Actor concurrency groups (reference: concurrency_group_manager.h +
ray.method(concurrency_group=...) API).

Semantics under test: a group's limit bounds ONLY that group's methods;
other groups and the default group keep flowing (the point of groups:
an actor stuck in slow compute still answers health checks on its own
"io" lane).
"""
import signal
import time

import pytest

import ray_tpu_torch

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
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(concurrency_groups={"io": 4, "compute": 1})
class Grouped:
    def __init__(self):
        self.log = []

    @ray_tpu_torch.method(concurrency_group="compute")
    def slow_compute(self):
        time.sleep(1.5)
        return "compute-done"

    @ray_tpu_torch.method(concurrency_group="io")
    def ping(self):
        return time.time()

    def default_lane(self):
        return "default"


def test_io_group_unblocked_by_compute(cluster):
    a = Grouped.remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S)  # actor up
    t0 = time.time()
    slow = [a.slow_compute.remote() for _ in range(2)]  # compute limit 1
    time.sleep(0.2)  # let compute occupy its lane
    ping_t = ray_tpu_torch.get(a.ping.remote(), timeout=10)
    ping_latency = time.time() - t0
    # The ping answered while compute was busy — well before the ~3s
    # the two serialized compute calls need.
    assert ping_latency < 1.2, f"io lane blocked: {ping_latency:.2f}s"
    assert ray_tpu_torch.get(slow, timeout=30) == ["compute-done"] * 2
    assert ping_t <= time.time()


def test_group_limit_serializes_within_group(cluster):
    a = Grouped.remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S)
    t0 = time.time()
    refs = [a.slow_compute.remote() for _ in range(2)]
    ray_tpu_torch.get(refs, timeout=30)
    # limit 1 → the two 1.5s calls serialize (≥3s), unlike the io group.
    assert time.time() - t0 >= 2.8


def test_io_group_parallel(cluster):
    @ray_tpu_torch.remote(concurrency_groups={"io": 4})
    class P:
        @ray_tpu_torch.method(concurrency_group="io")
        def hold(self):
            time.sleep(1.0)
            return 1

    a = P.remote()
    ray_tpu_torch.get(a.hold.remote(), timeout=GET_TIMEOUT_S)
    t0 = time.time()
    assert ray_tpu_torch.get([a.hold.remote() for _ in range(4)], timeout=20) == [1] * 4
    # 4 parallel holds on a limit-4 group finish in ~1s, not 4s.
    assert time.time() - t0 < 3.0


def test_per_call_group_override(cluster):
    a = Grouped.remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S)
    slow = [a.slow_compute.remote() for _ in range(2)]
    time.sleep(0.2)
    # default_lane explicitly routed into the congested compute group →
    # it queues behind both slow calls.
    t0 = time.time()
    out = ray_tpu_torch.get(
        a.default_lane.options(concurrency_group="compute").remote(),
        timeout=30,
    )
    assert out == "default"
    assert time.time() - t0 >= 2.0, "override did not join the compute lane"
    ray_tpu_torch.get(slow, timeout=GET_TIMEOUT_S)


def test_undeclared_group_rejected(cluster):
    @ray_tpu_torch.remote(concurrency_groups={"io": 2})
    class Bad:
        @ray_tpu_torch.method(concurrency_group="nope")
        def f(self):
            return 1

    a = Bad.remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(a.f.remote(), timeout=15)


def test_async_actor_groups(cluster):
    import asyncio

    @ray_tpu_torch.remote(concurrency_groups={"limited": 1})
    class A:
        @ray_tpu_torch.method(concurrency_group="limited")
        async def slow(self):
            await asyncio.sleep(0.8)
            return "s"

        async def fast(self):
            return "f"

    a = A.remote()
    assert ray_tpu_torch.get(a.fast.remote(), timeout=15) == "f"
    t0 = time.time()
    refs = [a.slow.remote() for _ in range(2)]
    assert ray_tpu_torch.get(a.fast.remote(), timeout=10) == "f"
    assert time.time() - t0 < 0.8  # default lane unblocked
    assert ray_tpu_torch.get(refs, timeout=20) == ["s", "s"]
    assert time.time() - t0 >= 1.5  # semaphore serialized the group


def test_per_call_undeclared_group_errors(cluster):
    a = Grouped.remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S)
    with pytest.raises(Exception, match="concurrency group"):
        ray_tpu_torch.get(
            a.ping.options(concurrency_group="nope").remote(), timeout=15
        )
