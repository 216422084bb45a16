"""The port's ecosystem adapters, tests/test_util_adapters.py case for
case: `ray_tpu_torch.util.multiprocessing.Pool`, the joblib backend
(registered as "ray_tpu_torch", beside the reference's "ray_tpu") and
`ray_tpu_torch.experimental.tqdm_ray`, whose worker lines carry the
port's own prefix (`__rtpt_tqdm__:`).

One module-scoped cluster; every test has a deadline after which it fails
instead of hanging, and every `get` a timeout.
"""
import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing import Pool

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


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_pool_map_and_star(cluster):
    with Pool(4) as p:
        assert p.map(_sq, range(20)) == [x * x for x in range(20)]
        assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        assert p.apply(_add, (5, 6)) == 11


def test_pool_async_and_imap(cluster):
    with Pool(3) as p:
        ar = p.map_async(_sq, range(10))
        assert ar.get(timeout=GET_TIMEOUT_S) == [x * x for x in range(10)]
        assert list(p.imap(_sq, range(8), chunksize=3)) == [x * x for x in range(8)]
        assert sorted(p.imap_unordered(_sq, range(8))) == sorted(x * x for x in range(8))


def test_pool_workers_share_processes(cluster):
    """Pool actors are sub-core: a wide pool must not boot one
    interpreter per slot (they pack onto shared hosts)."""
    with Pool(8) as p:
        pids = set(p.map(lambda _: os.getpid(), range(32)))
        assert len(pids) < 8


def test_pool_apply_async_callback(cluster):
    got = []
    with Pool(2) as p:
        ar = p.apply_async(_sq, (7,), callback=got.append)
        assert ar.get(timeout=GET_TIMEOUT_S) == 49
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            time.sleep(0.05)
        assert got == [49]


def test_pool_close_join_tears_down_actors(cluster):
    """close()+join() drains in-flight work and releases the actor
    fleet."""
    from ray_tpu_torch.util.state import list_actors

    p = Pool(3)
    ar = p.map_async(_sq, range(9))
    p.close()
    p.join()
    assert ar.get(timeout=GET_TIMEOUT_S) == [x * x for x in range(9)]
    deadline = time.time() + 30
    while time.time() < deadline:
        alive = [a for a in list_actors()
                 if a["class_name"].startswith("_PoolWorker") and a["state"] == "ALIVE"]
        if not alive:
            break
        time.sleep(0.2)
    assert not alive


def test_joblib_backend(cluster):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=3):
        out = joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]


def test_tqdm_ray_worker_bars_reach_driver(cluster):
    from ray_tpu_torch.experimental import tqdm_ray

    assert tqdm_ray.MAGIC == "__rtpt_tqdm__:"

    @ray_tpu_torch.remote
    def work(n):
        bar = tqdm_ray.tqdm(desc="crunch", total=n)
        for _ in range(n):
            bar.update(1)
        # leave the bar open so the driver registry retains it
        return n

    assert ray_tpu_torch.get(work.remote(5), timeout=GET_TIMEOUT_S) == 5
    deadline = time.time() + 30
    while time.time() < deadline:
        if any(b["desc"] == "crunch" and b["n"] == 5 for b in tqdm_ray.bars().values()):
            break
        time.sleep(0.2)
    else:
        raise AssertionError(f"driver never saw the bar: {tqdm_ray.bars()}")


def test_tqdm_ray_close_removes_bar(cluster):
    from ray_tpu_torch.experimental import tqdm_ray

    bar = tqdm_ray.tqdm(desc="local", total=3)
    bar.update(2)
    assert any(b["desc"] == "local" for b in tqdm_ray.bars().values())
    bar.close()
    assert not any(b["desc"] == "local" for b in tqdm_ray.bars().values())
