"""The port's shared actor hosts: tests/test_actor_packing.py, case for
case, on the port's runtime. Every test has a deadline after which it
fails instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Shared actor hosts: sub-core actors pack many per worker process.

Declaring 0 < num_cpus < 1 opts an actor into co-hosting (the creation
routes to a shared host instead of booting a dedicated interpreter —
gcs._packable / _pick_worker). Reference contrast: the reference is
strictly process-per-actor (worker_pool.cc) and pays a process boot per
actor; sub-core packing is what makes many-tiny-coordinator patterns
(RL actors, serve replicas to one chip) cheap on small hosts.
"""
import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError

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


@ray_tpu_torch.remote(num_cpus=0.05)
class Tiny:
    def __init__(self, tag=0):
        self.tag = tag
        self.n = 0

    def pid(self):
        return os.getpid()

    def incr(self):
        self.n += 1
        return self.n

    def whoami(self):
        return (self.tag, self.n)


def test_subcore_actors_share_processes(cluster):
    actors = [Tiny.remote(i) for i in range(12)]
    pids = ray_tpu_torch.get([a.pid.remote() for a in actors], timeout=GET_TIMEOUT_S)
    # 12 sub-core actors must not boot 12 interpreters.
    assert len(set(pids)) < 6, f"expected packing, got {len(set(pids))} procs"
    # Each actor keeps its own isolated state.
    for _ in range(3):
        ray_tpu_torch.get([a.incr.remote() for a in actors], timeout=GET_TIMEOUT_S)
    for i, a in enumerate(actors):
        assert ray_tpu_torch.get(a.whoami.remote(), timeout=GET_TIMEOUT_S) == (i, 3)


def test_default_actors_keep_dedicated_processes(cluster):
    @ray_tpu_torch.remote
    class Plain:
        def pid(self):
            return os.getpid()

    plains = [Plain.remote() for _ in range(3)]
    pids = ray_tpu_torch.get([p.pid.remote() for p in plains], timeout=GET_TIMEOUT_S)
    assert len(set(pids)) == 3  # process-per-actor isolation preserved


def test_kill_packed_actor_spares_cohosted(cluster):
    actors = [Tiny.remote(i) for i in range(6)]
    pids = ray_tpu_torch.get([a.pid.remote() for a in actors], timeout=GET_TIMEOUT_S)
    assert len(set(pids)) < 6
    victim, survivors = actors[0], actors[1:]
    ray_tpu_torch.kill(victim)
    # kill is asynchronous (reference ray.kill semantics): a direct-route
    # call racing the terminate can still land; poll until death sticks.
    deadline = time.time() + 30
    while True:
        try:
            ray_tpu_torch.get(victim.incr.remote(), timeout=30)
        except RayActorError:
            break
        assert time.time() < deadline, "victim never died"
        time.sleep(0.1)
    # Same-process neighbors unaffected.
    assert ray_tpu_torch.get([s.incr.remote() for s in survivors], timeout=GET_TIMEOUT_S) == [1] * 5


def test_packed_actor_graceful_exit_keeps_host(cluster):
    actors = [Tiny.remote(i) for i in range(4)]
    ray_tpu_torch.get([a.pid.remote() for a in actors], timeout=GET_TIMEOUT_S)
    ray_tpu_torch.kill(actors[0], no_restart=True)
    time.sleep(0.2)
    # Host still serves the rest; a fresh packable actor reuses it.
    fresh = Tiny.remote(99)
    assert ray_tpu_torch.get(fresh.whoami.remote(), timeout=60) == (99, 0)
    assert ray_tpu_torch.get([a.incr.remote() for a in actors[1:]], timeout=GET_TIMEOUT_S) == [1, 1, 1]


def test_packed_creation_failure_spares_host(cluster):
    @ray_tpu_torch.remote(num_cpus=0.05)
    class Boom:
        def __init__(self):
            raise RuntimeError("bad init")

        def ping(self):
            return 1

    ok = [Tiny.remote(i) for i in range(3)]
    ray_tpu_torch.get([a.pid.remote() for a in ok], timeout=GET_TIMEOUT_S)
    b = Boom.remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(b.ping.remote(), timeout=60)
    # Co-hosted actors survived the failed construction.
    assert ray_tpu_torch.get([a.incr.remote() for a in ok], timeout=GET_TIMEOUT_S) == [1, 1, 1]


def test_packed_actor_creation_throughput(cluster):
    """The point of packing: creation rate no longer pays a process boot
    per actor. Very conservative floor (the 1-core CI host does ~300/s)."""
    warm = Tiny.remote()
    ray_tpu_torch.get(warm.pid.remote(), timeout=GET_TIMEOUT_S)
    n = 30
    t0 = time.perf_counter()
    actors = [Tiny.remote(i) for i in range(n)]
    ray_tpu_torch.get([a.pid.remote() for a in actors], timeout=300)
    rate = n / (time.perf_counter() - t0)
    assert rate > 25, f"packed creation rate {rate:.1f}/s"
