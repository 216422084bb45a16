"""The port's core API: tests/test_core_api.py, case for case, on the
port's runtime: tasks, put/get, refs as arguments, nested refs, errors,
`wait`, `free`, leases released when a client dies, and the direct
transport's retry. Every test has a deadline after which it fails
instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring: core API: tasks, objects, wait, errors.
Models the reference's python/ray/tests/test_basic.py coverage.
"""
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError, RayTaskError, WorkerCrashedError

DEADLINE_S = 90
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


@ray_tpu_torch.remote
def double(x):
    return 2 * x


def test_simple_task(ray_start):
    assert ray_tpu_torch.get(double.remote(21), timeout=GET_TIMEOUT_S) == 42


def test_many_tasks(ray_start):
    refs = [double.remote(i) for i in range(50)]
    assert ray_tpu_torch.get(refs, timeout=GET_TIMEOUT_S) == [2 * i for i in range(50)]


def test_put_get_roundtrip(ray_start):
    for value in [1, "x", {"a": [1, 2]}, None, (1, 2)]:
        assert ray_tpu_torch.get(ray_tpu_torch.put(value), timeout=GET_TIMEOUT_S) == value


def test_put_get_numpy_large(ray_start):
    arr = np.random.RandomState(0).rand(1 << 20)  # 8 MiB -> shm path
    out = ray_tpu_torch.get(ray_tpu_torch.put(arr), timeout=GET_TIMEOUT_S)
    np.testing.assert_array_equal(arr, out)


def test_object_ref_as_arg(ray_start):
    a = double.remote(1)
    b = double.remote(a)
    assert ray_tpu_torch.get(b, timeout=GET_TIMEOUT_S) == 4


def test_nested_ref_passthrough(ray_start):
    @ray_tpu_torch.remote
    def unwrap(container):
        # Nested refs are not auto-resolved (borrowing semantics).
        inner = container["ref"]
        return ray_tpu_torch.get(inner, timeout=GET_TIMEOUT_S)

    ref = ray_tpu_torch.put(123)
    assert ray_tpu_torch.get(unwrap.remote({"ref": ref}), timeout=GET_TIMEOUT_S) == 123


def test_multiple_returns(ray_start):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    r1, r2, r3 = three.remote()
    assert ray_tpu_torch.get([r1, r2, r3], timeout=GET_TIMEOUT_S) == [1, 2, 3]


def test_task_error_propagates(ray_start):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ValueError, match="kaboom"):
        ray_tpu_torch.get(boom.remote(), timeout=GET_TIMEOUT_S)


def test_error_is_ray_task_error(ray_start):
    @ray_tpu_torch.remote
    def boom():
        raise KeyError("k")

    with pytest.raises(RayTaskError):
        ray_tpu_torch.get(boom.remote(), timeout=GET_TIMEOUT_S)


def test_dependent_task_fails(ray_start):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("upstream")

    with pytest.raises(ValueError):
        ray_tpu_torch.get(double.remote(boom.remote()), timeout=GET_TIMEOUT_S)


def test_get_timeout(ray_start):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.2)


def test_wait_basic(ray_start):
    @ray_tpu_torch.remote
    def fast():
        return 1

    @ray_tpu_torch.remote
    def slow():
        time.sleep(20)

    ready, rest = ray_tpu_torch.wait([fast.remote(), slow.remote()], num_returns=1, timeout=10)
    assert len(ready) == 1 and len(rest) == 1
    assert ray_tpu_torch.get(ready[0], timeout=GET_TIMEOUT_S) == 1


def test_wait_timeout_returns_partial(ray_start):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(20)

    ready, rest = ray_tpu_torch.wait([slow.remote()], num_returns=1, timeout=0.2)
    assert ready == [] and len(rest) == 1


def test_nested_task_submission(ray_start):
    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(double.remote(x), timeout=GET_TIMEOUT_S) + 1

    assert ray_tpu_torch.get(outer.remote(10), timeout=GET_TIMEOUT_S) == 21


def test_options_override(ray_start):
    assert ray_tpu_torch.get(double.options(num_cpus=2).remote(5), timeout=GET_TIMEOUT_S) == 10


def test_cluster_resources(ray_start):
    assert ray_tpu_torch.cluster_resources()["CPU"] == 4.0


def test_worker_crash_surfaces(ray_start):
    @ray_tpu_torch.remote
    def die():
        import os

        os._exit(1)

    with pytest.raises(WorkerCrashedError):
        ray_tpu_torch.get(die.remote(), timeout=30)


def test_free_objects(ray_start):
    ref = ray_tpu_torch.put(np.zeros(1 << 20))
    assert ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S) is not None
    ray_tpu_torch.free([ref])
    # Freed objects are gone from the directory; a get would block, so just
    # confirm wait() no longer reports it ready.
    time.sleep(0.2)
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.5)
    assert ready == []


def test_python_objects_with_refs_inside_returns(ray_start):
    @ray_tpu_torch.remote
    def make_ref():
        return ray_tpu_torch.put("inner")

    outer_ref = make_ref.remote()
    inner_ref = ray_tpu_torch.get(outer_ref, timeout=GET_TIMEOUT_S)
    assert ray_tpu_torch.get(inner_ref, timeout=GET_TIMEOUT_S) == "inner"


def test_leases_released_when_client_dies(ray_start):
    # Nested clients (actors submitting tasks) lease workers for the
    # direct task transport; killing the client must give the leased
    # workers (and their resources) back (reference: leases are tied to
    # the lessee in direct_task_transport.cc).
    import time

    @ray_tpu_torch.remote
    def tiny():
        return 1

    @ray_tpu_torch.remote
    class Submitter:
        def drive(self, n):
            return sum(ray_tpu_torch.get([tiny.remote() for _ in range(n)], timeout=GET_TIMEOUT_S))

    total = ray_tpu_torch.cluster_resources().get("CPU", 0)
    s = Submitter.remote()
    assert ray_tpu_torch.get(s.drive.remote(20), timeout=GET_TIMEOUT_S) == 20
    ray_tpu_torch.kill(s)
    deadline = time.time() + 10
    while time.time() < deadline:
        if ray_tpu_torch.available_resources().get("CPU", 0) == total:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources().get("CPU", 0) == total


def test_direct_task_transport_error_and_retry(ray_start):
    # Errors propagate through the leased path; worker death mid-task
    # falls back to GCS rescheduling (system retries).
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("nope")

    # warm the function (first call registers blob via GCS) then leased
    with pytest.raises(ValueError):
        ray_tpu_torch.get(boom.remote(), timeout=GET_TIMEOUT_S)
    with pytest.raises(ValueError):
        ray_tpu_torch.get(boom.remote(), timeout=GET_TIMEOUT_S)

    @ray_tpu_torch.remote(max_retries=2)
    def die_once():
        import os
        import ray_tpu_torch as rt

        marker = b"died_once_marker"
        if not rt._private.worker.global_client().kv_get(marker):
            rt._private.worker.global_client().kv_put(marker, b"1")
            os._exit(1)
        return "recovered"

    assert ray_tpu_torch.get(die_once.remote(), timeout=60) == "recovered"
