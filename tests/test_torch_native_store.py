"""The port's C++ pool object store (`ray_tpu_torch._private.native_store`):
allocator, refcounts, eviction, integration. tests/test_native_store.py,
case for case, on the port's copy; every test has a deadline after which
it fails instead of hanging, and every `get` a timeout.

Models the reference's plasma tests
(src/ray/object_manager/plasma/test/, python/ray/tests/test_plasma*).
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu_torch._private.native_store import PoolStore, native_available

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


pytestmark = pytest.mark.skipif(
    not native_available(), reason="native store did not build"
)


@pytest.fixture
def pool():
    name = f"/rtpt_t_{os.getpid()}"
    p = PoolStore(name, create=True, pool_bytes=16 << 20, max_objects=512,
                  evict=True)
    yield p
    p.destroy()


def _oid(i: int) -> bytes:
    return i.to_bytes(16, "little")


def test_create_seal_get_release_delete(pool):
    v = pool.create(_oid(1), 100)
    v[:5] = b"hello"
    del v
    assert not pool.contains(_oid(1))  # unsealed: not visible
    assert pool.seal(_oid(1))
    assert pool.contains(_oid(1))
    g = pool.get(_oid(1))
    assert bytes(g[:5]) == b"hello" and len(g) == 100
    del g
    pool.release(_oid(1))
    pool.delete(_oid(1))
    assert not pool.contains(_oid(1))


def test_duplicate_create_rejected(pool):
    v = pool.create(_oid(2), 10)
    del v
    assert pool.create(_oid(2), 10) is None


def test_allocator_reuses_freed_space(pool):
    # Fill ~3/4 of a 16MB pool, free, refill — the allocator must
    # coalesce and reuse, not leak.
    for round_ in range(5):
        ids = []
        for i in range(12):
            oid = _oid(1000 + round_ * 100 + i)
            v = pool.create(oid, 1 << 20)
            assert v is not None, f"round {round_}, obj {i}: allocator leaked"
            del v
            pool.seal(oid)
            ids.append(oid)
        for oid in ids:
            pool.delete(oid)
    assert pool.stats()["bytes_in_use"] == 0


def test_lru_eviction_under_pressure(pool):
    ids = [_oid(3000 + i) for i in range(30)]
    for oid in ids:
        v = pool.create(oid, 1 << 20)
        assert v is not None  # eviction makes room
        del v
        pool.seal(oid)
    st = pool.stats()
    assert st["num_evictions"] > 0
    assert pool.contains(ids[-1])
    assert not pool.contains(ids[0])  # oldest evicted


def test_referenced_objects_survive_eviction(pool):
    first = _oid(4000)
    v = pool.create(first, 1 << 20)
    v[:6] = b"pinned"  # payloads are malloc-style: not zeroed
    del v
    pool.seal(first)
    held = pool.get(first)  # refcount 1 — pin it
    for i in range(30):
        oid = _oid(4001 + i)
        w = pool.create(oid, 1 << 20)
        if w is None:
            break
        del w
        pool.seal(oid)
    assert pool.contains(first), "pinned object must not be evicted"
    assert bytes(held[:6]) == b"pinned", "pinned payload was clobbered"
    del held
    pool.release(first)


def test_cross_process_visibility(pool):
    v = pool.create(_oid(5), 8)
    v[:] = b"crosproc"
    del v
    pool.seal(_oid(5))
    code = f"""
from ray_tpu_torch._private.native_store import PoolStore
p = PoolStore({pool.name!r}, create=False)
v = p.get((5).to_bytes(16, "little"))
assert bytes(v) == b"crosproc", bytes(v)
del v
p.release((5).to_bytes(16, "little"))
p.close()
print("OK")
"""
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))},
    )
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-500:]


def test_default_pool_full_fails_create_no_eviction():
    """Session pools default to evict=False: a full pool rejects the
    create (callers fall back to per-object segments) rather than
    silently evicting objects live ObjectRefs may still name."""
    name = f"/rtpt_noevict_{os.getpid()}"
    p = PoolStore(name, create=True, pool_bytes=4 << 20, max_objects=64)
    try:
        created = 0
        for i in range(10):
            v = p.create(_oid(i), 1 << 20)
            if v is None:
                break
            del v
            p.seal(_oid(i))
            created += 1
        assert 0 < created < 10
        assert p.stats()["num_evictions"] == 0
        for i in range(created):  # everything created is still there
            assert p.contains(_oid(i))
    finally:
        p.destroy()


def test_public_api_via_pool():
    """End-to-end: ray_tpu_torch.put/get of a large array rides the pool."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    try:
        arr = np.random.rand(1024, 256)  # 2MB > inline threshold
        ref = ray_tpu_torch.put(arr)
        out = ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)
        assert np.array_equal(arr, out)

        @ray_tpu_torch.remote
        def consume(x):
            return float(x.sum())

        assert abs(ray_tpu_torch.get(consume.remote(ref), timeout=GET_TIMEOUT_S) - arr.sum()) < 1e-6
    finally:
        ray_tpu_torch.shutdown()


def test_deferred_delete_frees_on_last_release():
    # Delete-while-referenced must free the block when the last reader
    # releases, even with eviction disabled (the session-pool default) —
    # otherwise deleted-but-referenced objects leak arena space forever.
    name = f"/rtpt_dd_{os.getpid()}"
    pool = PoolStore(name, create=True, pool_bytes=4 << 20, max_objects=64,
                     evict=False)
    try:
        v = pool.create(_oid(7), 1 << 20)
        del v
        assert pool.seal(_oid(7))
        g = pool.get(_oid(7))  # rc = 1
        base = pool.stats()["bytes_in_use"]
        pool.delete(_oid(7))  # deferred: reader still holds a ref
        assert pool.stats()["bytes_in_use"] == base  # still pinned
        assert not pool.contains(_oid(7))  # but invisible to readers
        assert pool.get(_oid(7)) is None
        del g
        pool.release(_oid(7))  # last release frees, no eviction needed
        assert pool.stats()["bytes_in_use"] < base
        # The slot is reusable immediately.
        v2 = pool.create(_oid(7), 1 << 20)
        assert v2 is not None
        del v2
    finally:
        pool.destroy()
