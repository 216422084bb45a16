"""The port's push-based wait: tests/test_wait_push.py, case for case, on
the port's runtime. Every test has a deadline after which it fails
instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Push-based wait: drain-by-wait loops never poll the head.

Reference behavior: raylet/wait_manager.h — waits are registered once
and completed by callbacks. VERDICT r3 #2's done-criterion: steady-state
wait loops produce zero check_ready messages (asserted via the head's
per-type message counters, the same harness test_local_dispatch uses).
"""
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_client

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
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def tiny(x):
    return x * 2


@ray_tpu_torch.remote
def slow(x):
    time.sleep(0.05)
    return x


def _msg_counts():
    r = global_client().request({"type": "msg_counts"})
    return r["counts"]


def test_drain_by_wait_never_polls_head(cluster):
    refs = [tiny.remote(i) for i in range(200)]
    before = _msg_counts()
    not_ready = refs
    seen = 0
    while not_ready:
        ready, not_ready = ray_tpu_torch.wait(not_ready, num_returns=1, timeout=GET_TIMEOUT_S)
        seen += len(ready)
    after = _msg_counts()
    assert seen == 200
    assert after.get("check_ready", 0) == before.get("check_ready", 0)
    assert after.get("wait_any", 0) == before.get("wait_any", 0)
    # Leased-task results resolve on the direct socket: the whole drain
    # should not even need a subscription round-trip per call — at most
    # one batched wait_subscribe for stragglers.
    assert (
        after.get("wait_subscribe", 0) - before.get("wait_subscribe", 0) <= 2
    )


def test_wait_results_correct_under_timeout(cluster):
    refs = [slow.remote(i) for i in range(8)]
    ready, rest = ray_tpu_torch.wait(refs, num_returns=8, timeout=30)
    assert len(ready) == 8 and not rest
    assert sorted(ray_tpu_torch.get(ready, timeout=GET_TIMEOUT_S)) == list(range(8))


def test_wait_timeout_returns_partial(cluster):
    @ray_tpu_torch.remote
    def hang():
        time.sleep(60)

    r = hang.remote()
    t0 = time.monotonic()
    ready, rest = ray_tpu_torch.wait([r], num_returns=1, timeout=0.3)
    assert time.monotonic() - t0 < 5
    assert ready == [] and rest == [r]


def test_wait_gcs_routed_results_push(cluster):
    """Tasks with dependencies route via the GCS; their readiness must
    arrive as pushes on the one-shot subscription."""
    a = tiny.remote(1)
    b = tiny.remote(ray_tpu_torch.get(a, timeout=GET_TIMEOUT_S))  # plain value
    dep = tiny.remote(a)  # ref dependency -> GCS route
    ready, rest = ray_tpu_torch.wait([b, dep], num_returns=2, timeout=30)
    assert len(ready) == 2 and not rest
    assert ray_tpu_torch.get(dep, timeout=GET_TIMEOUT_S) == 4


def test_wait_mixed_put_and_task_refs(cluster):
    p = ray_tpu_torch.put(41)
    t = tiny.remote(5)
    ready, rest = ray_tpu_torch.wait([p, t], num_returns=2, timeout=30)
    assert len(ready) == 2
    assert ray_tpu_torch.get(p, timeout=GET_TIMEOUT_S) == 41 and ray_tpu_torch.get(t, timeout=GET_TIMEOUT_S) == 10


def test_repeated_wait_on_same_refs(cluster):
    refs = [tiny.remote(i) for i in range(5)]
    for _ in range(3):
        ready, rest = ray_tpu_torch.wait(refs, num_returns=5, timeout=30)
        assert len(ready) == 5 and not rest
