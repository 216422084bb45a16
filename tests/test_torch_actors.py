"""The port's actors: tests/test_actors.py, case for case, on the port's
runtime: creation, ordering, named actors, failure semantics. Every test
has a deadline after which it fails instead of hanging, and every `get`
a timeout.

The reference's docstring: actors: creation, ordering, named actors, failure semantics.

Models the reference's python/ray/tests/test_actor.py coverage.
"""
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError

DEADLINE_S = 60
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
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, k=1):
        self.n += k
        return self.n

    def read(self):
        return self.n


def test_actor_basic(ray_start):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote(), timeout=GET_TIMEOUT_S) == 1
    assert ray_tpu_torch.get(c.incr.remote(10), timeout=GET_TIMEOUT_S) == 11


def test_actor_constructor_args(ray_start):
    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.read.remote(), timeout=GET_TIMEOUT_S) == 100


def test_actor_method_ordering(ray_start):
    c = Counter.remote()
    refs = [c.incr.remote() for _ in range(20)]
    assert ray_tpu_torch.get(refs, timeout=GET_TIMEOUT_S) == list(range(1, 21))


def test_actor_state_isolated(ray_start):
    a, b = Counter.remote(), Counter.remote()
    ray_tpu_torch.get(a.incr.remote(), timeout=GET_TIMEOUT_S)
    assert ray_tpu_torch.get(b.read.remote(), timeout=GET_TIMEOUT_S) == 0


def test_actor_handle_passing(ray_start):
    @ray_tpu_torch.remote
    def bump(counter):
        return ray_tpu_torch.get(counter.incr.remote(), timeout=GET_TIMEOUT_S)

    c = Counter.remote()
    assert ray_tpu_torch.get(bump.remote(c), timeout=GET_TIMEOUT_S) == 1
    assert ray_tpu_torch.get(c.read.remote(), timeout=GET_TIMEOUT_S) == 1


def test_named_actor(ray_start):
    Counter.options(name="global_counter").remote(5)
    time.sleep(0.1)
    h = ray_tpu_torch.get_actor("global_counter")
    assert ray_tpu_torch.get(h.read.remote(), timeout=GET_TIMEOUT_S) == 5


def test_named_actor_duplicate_fails(ray_start):
    Counter.options(name="dup").remote()
    with pytest.raises(ValueError, match="already taken"):
        Counter.options(name="dup").remote()


def test_get_if_exists(ray_start):
    a = Counter.options(name="gie", get_if_exists=True).remote(7)
    ray_tpu_torch.get(a.read.remote(), timeout=GET_TIMEOUT_S)  # ensure created
    b = Counter.options(name="gie", get_if_exists=True).remote(7)
    ray_tpu_torch.get(a.incr.remote(), timeout=GET_TIMEOUT_S)
    assert ray_tpu_torch.get(b.read.remote(), timeout=GET_TIMEOUT_S) == 8


def test_kill_actor(ray_start):
    c = Counter.remote()
    ray_tpu_torch.get(c.incr.remote(), timeout=GET_TIMEOUT_S)
    ray_tpu_torch.kill(c)
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(c.incr.remote(), timeout=10)


def test_actor_creation_failure(ray_start):
    @ray_tpu_torch.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("cannot construct")

        def ping(self):
            return "pong"

    b = Broken.remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(b.ping.remote(), timeout=10)


def test_actor_method_error(ray_start):
    @ray_tpu_torch.remote
    class Faulty:
        def bad(self):
            raise ValueError("method error")

        def good(self):
            return "ok"

    f = Faulty.remote()
    with pytest.raises(ValueError):
        ray_tpu_torch.get(f.bad.remote(), timeout=GET_TIMEOUT_S)
    # Actor survives method errors.
    assert ray_tpu_torch.get(f.good.remote(), timeout=GET_TIMEOUT_S) == "ok"


def test_async_actor(ray_start):
    @ray_tpu_torch.remote
    class AsyncActor:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x * 2

    a = AsyncActor.remote()
    assert ray_tpu_torch.get([a.work.remote(i) for i in range(5)], timeout=GET_TIMEOUT_S) == [0, 2, 4, 6, 8]


def test_max_concurrency_threaded(ray_start):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Slow:
        def work(self):
            time.sleep(0.3)
            return 1

    s = Slow.remote()
    ray_tpu_torch.get(s.work.remote(), timeout=GET_TIMEOUT_S)  # warm up: actor creation + worker spawn
    start = time.monotonic()
    ray_tpu_torch.get([s.work.remote() for _ in range(4)], timeout=GET_TIMEOUT_S)
    elapsed = time.monotonic() - start
    # 4 concurrent 0.3s calls should take well under 4*0.3s serial time.
    assert elapsed < 1.0


def test_actor_death_by_exit(ray_start):
    @ray_tpu_torch.remote
    class Dying:
        def die(self):
            import os

            os._exit(1)

        def ping(self):
            return "pong"

    d = Dying.remote()
    assert ray_tpu_torch.get(d.ping.remote(), timeout=GET_TIMEOUT_S) == "pong"
    d.die.remote()
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(d.ping.remote(), timeout=10)


def test_actors_dont_hold_cpus(ray_start):
    # Actors default to 0 CPUs for their lifetime, so many actors coexist
    # on few cores (reference: ray_option_utils defaults).
    counters = [Counter.remote() for _ in range(8)]
    assert ray_tpu_torch.get([c.incr.remote() for c in counters], timeout=GET_TIMEOUT_S) == [1] * 8
