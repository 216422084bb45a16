"""The port's shared-memory object plane: tests/test_shm_plane.py, case
for case, on the port's copy of the runtime (`/dev/shm/rtpt_*` pools,
`RAY_TPU_TORCH_POOL_NAME`); every test has a deadline after which it
fails instead of hanging.

What it holds: cross-process refcounts, the crash sweep and the
spill-ladder handoff. Models the reference's plasma crash tests: a SIGKILLed client must
never leak refcounts (its ledger is swept), a client killed mid-put
must never produce a sealed object (partials are freed), and a mapped
reader in ANOTHER process must pin an object against eviction until it
dies or releases.
"""
import hashlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.native_store import PoolStore, native_available
from ray_tpu_torch._private.object_store import ObjectStore

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


pytestmark = pytest.mark.skipif(
    not native_available(), reason="native store did not build"
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oid(i: int) -> bytes:
    return i.to_bytes(16, "little")


def _child(code: str):
    """Spawn a python child attached to the repo; returns the Popen."""
    return subprocess.Popen(
        [sys.executable, "-u", "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _REPO},
    )


def _wait_line(proc, token: str, timeout: float = 30.0) -> None:
    """Block until the child prints ``token`` on stdout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if token in line:
            return
        if proc.poll() is not None:
            raise AssertionError(
                f"child exited rc={proc.returncode}: {proc.stderr.read()[-800:]}"
            )
    raise AssertionError(f"child never printed {token!r}")


@pytest.fixture
def pool():
    name = f"/rtpt_shmp_{os.getpid()}"
    p = PoolStore(name, create=True, pool_bytes=16 << 20, max_objects=256,
                  evict=True)
    yield p
    p.destroy()


def test_multiprocess_put_get_bit_exact(pool):
    """Bytes written by one process read bit-exact by another, and vice
    versa — the same mapping, zero copies, arbitrary binary payloads."""
    rng = np.random.RandomState(7)
    blob = rng.bytes(1 << 20)
    v = pool.create(_oid(1), len(blob))
    v[:] = blob
    del v
    assert pool.seal(_oid(1))
    code = f"""
import hashlib
from ray_tpu_torch._private.native_store import PoolStore
p = PoolStore({pool.name!r}, create=False)
g = p.get((1).to_bytes(16, "little"))
print("HASH", hashlib.sha256(bytes(g)).hexdigest())
del g
p.release((1).to_bytes(16, "little"))
# Child-side put: parent must read it bit-exact too.
w = p.create((2).to_bytes(16, "little"), len(bytes(1)))
payload = hashlib.sha256(b"child-put").digest()[:1]
w[:] = payload
del w
p.seal((2).to_bytes(16, "little"))
print("PUT", payload.hex())
p.close()
"""
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert r.returncode == 0, r.stderr[-800:]
    lines = dict(l.split(" ", 1) for l in r.stdout.strip().splitlines())
    assert lines["HASH"] == hashlib.sha256(blob).hexdigest()
    g = pool.get(_oid(2))
    assert bytes(g).hex() == lines["PUT"].strip()
    del g
    pool.release(_oid(2))


def test_sigkill_client_refs_swept(pool):
    """A SIGKILLed reader's refcounts are reclaimed by sweep(): the
    object it pinned becomes evictable/deletable again."""
    v = pool.create(_oid(10), 1 << 20)
    del v
    pool.seal(_oid(10))
    proc = _child(f"""
import sys, time
from ray_tpu_torch._private.native_store import PoolStore
p = PoolStore({pool.name!r}, create=False)
g = p.get((10).to_bytes(16, "little"))  # rc -> 1, never released
print("PINNED", flush=True)
time.sleep(120)
""")
    _wait_line(proc, "PINNED")
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    swept = pool.sweep()
    assert swept["clients_swept"] >= 1, swept
    assert swept["refs_dropped"] >= 1, swept
    # The pin is gone: delete frees the block immediately.
    base = pool.stats()["bytes_in_use"]
    pool.delete(_oid(10))
    assert pool.stats()["bytes_in_use"] < base


def test_eviction_respects_cross_process_reader(pool):
    """An object mapped by a LIVE reader in another process must survive
    memory pressure; once the reader dies and is swept it may go."""
    v = pool.create(_oid(20), 1 << 20)
    v[:6] = b"pinned"
    del v
    pool.seal(_oid(20))
    proc = _child(f"""
import time
from ray_tpu_torch._private.native_store import PoolStore
p = PoolStore({pool.name!r}, create=False)
g = p.get((20).to_bytes(16, "little"))
print("PINNED", flush=True)
time.sleep(120)
""")
    _wait_line(proc, "PINNED")
    try:
        # Pressure: fill well past capacity; eviction must route around
        # the cross-process pin.
        for i in range(30):
            w = pool.create(_oid(21 + i), 1 << 20)
            if w is None:
                break
            del w
            pool.seal(_oid(21 + i))
        assert pool.contains(_oid(20)), "cross-process pin was evicted"
        g = pool.get(_oid(20))
        assert bytes(g[:6]) == b"pinned"
        del g
        pool.release(_oid(20))
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
    swept = pool.sweep()
    assert swept["clients_swept"] >= 1
    # Reader dead + our release done: the refcount is 0 again, so
    # delete frees the block immediately (a lingering pin would defer).
    base = pool.stats()["bytes_in_use"]
    pool.delete(_oid(20))
    assert pool.stats()["bytes_in_use"] < base, "dead reader still pins"


def test_kill_mid_put_partial_never_seals(pool):
    """Seeded crash between create and seal: the unsealed partial must
    be reclaimed by sweep and must NEVER become visible."""
    proc = _child(f"""
import time
from ray_tpu_torch._private.native_store import PoolStore
p = PoolStore({pool.name!r}, create=False)
w = p.create((30).to_bytes(16, "little"), 1 << 20)
w[:7] = b"partial"
print("MIDPUT", flush=True)   # crash point: created, not sealed
time.sleep(120)
""")
    _wait_line(proc, "MIDPUT")
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    assert not pool.contains(_oid(30))  # unsealed: invisible
    swept = pool.sweep()
    assert swept["clients_swept"] >= 1, swept
    assert swept["partials_reclaimed"] >= 1, swept
    assert not pool.contains(_oid(30)), "partial sealed after sweep"
    # The arena space is reusable: same id, fresh create succeeds.
    w = pool.create(_oid(30), 1 << 20)
    assert w is not None
    del w
    stats = pool.sweep_stats()
    assert stats["partials_reclaimed"] >= 1


def test_sweep_is_idempotent_and_self_preserving(pool):
    """sweep() from the owner never sweeps the live caller, and a
    second sweep with no new deaths is a no-op."""
    v = pool.create(_oid(40), 1024)
    del v
    pool.seal(_oid(40))
    g = pool.get(_oid(40))  # our own pin
    first = pool.sweep()
    assert first["clients_swept"] == 0
    assert pool.contains(_oid(40))
    del g
    pool.release(_oid(40))


def test_same_host_pull_rides_shm_not_socket(monkeypatch):
    """A pull between two node stores on one host maps the provider's
    pool and copies once — the chunked TCP path is never entered."""
    import secrets

    from ray_tpu_torch._private.object_transfer import (
        ObjectFetcher, ObjectTransferServer,
    )

    prov_name = f"/rtpt_prov_{os.getpid()}"
    cons_name = f"/rtpt_cons_{os.getpid()}"
    provider_pool = PoolStore(prov_name, create=True, pool_bytes=8 << 20)
    consumer_pool = PoolStore(cons_name, create=True, pool_bytes=8 << 20)
    authkey = secrets.token_bytes(8)
    server = fetcher = None
    try:
        monkeypatch.setenv("RAY_TPU_TORCH_POOL_NAME", prov_name)
        provider_store = ObjectStore()
        monkeypatch.setenv("RAY_TPU_TORCH_POOL_NAME", cons_name)
        consumer_store = ObjectStore()

        oid = ObjectID(_oid((os.getpid() << 16) + 77))
        arr = np.random.RandomState(3).rand(1 << 16)  # 512 KiB
        loc, _ = provider_store.put(oid, arr)
        assert loc == "pool"

        server = ObjectTransferServer(
            provider_store, "127.0.0.1:0", authkey
        )
        fetcher = ObjectFetcher(consumer_store, authkey)
        # Chunked path booby-trapped: the shm shortcut must satisfy the
        # pull before a single pull_chunk request is issued.
        def _no_tcp(*a, **k):
            raise AssertionError("same-host pull fell back to TCP chunks")
        monkeypatch.setattr(fetcher, "_pull_chunks", _no_tcp)
        assert fetcher.pull(oid, server.address, timeout=20.0)
        assert consumer_store.contains(oid)
        np.testing.assert_array_equal(consumer_store.get(oid), arr)
    finally:
        if fetcher is not None:
            fetcher.close()
        if server is not None:
            server.shutdown()
        provider_pool.destroy()
        consumer_pool.destroy()


def test_fenced_provider_segment_not_attachable(monkeypatch):
    """Membership fencing: once a raylet learns it
    was declared dead it fences its transfer server — shm_locate must
    stop naming the pool, so no NEW pull can map a segment the fleet
    already considers gone (the head may have freed the ids, and a
    fresh incarnation may recycle the pool). Pulls degrade to the
    chunked copy path — bytes, never the mapping — and complete."""
    import secrets

    from ray_tpu_torch._private.object_transfer import (
        ObjectFetcher, ObjectTransferServer,
    )

    prov_name = f"/rtpt_fprov_{os.getpid()}"
    cons_name = f"/rtpt_fcons_{os.getpid()}"
    provider_pool = PoolStore(prov_name, create=True, pool_bytes=8 << 20)
    consumer_pool = PoolStore(cons_name, create=True, pool_bytes=8 << 20)
    authkey = secrets.token_bytes(8)
    server = fetcher = None
    try:
        monkeypatch.setenv("RAY_TPU_TORCH_POOL_NAME", prov_name)
        provider_store = ObjectStore()
        monkeypatch.setenv("RAY_TPU_TORCH_POOL_NAME", cons_name)
        consumer_store = ObjectStore()

        oid = ObjectID(_oid((os.getpid() << 16) + 78))
        arr = np.random.RandomState(4).rand(1 << 16)  # 512 KiB
        loc, _ = provider_store.put(oid, arr)
        assert loc == "pool"

        server = ObjectTransferServer(
            provider_store, "127.0.0.1:0", authkey
        )
        server.fence_shm()
        fetcher = ObjectFetcher(consumer_store, authkey)
        # The boot-id handshake answers fenced — the provider's pool
        # name never crosses the wire, so there is nothing to attach.
        conn = fetcher._conn_for(server.address)
        reply = conn.request(
            {"type": "shm_locate", "object_id": oid.binary()},
            timeout=10.0,
        )
        assert reply.get("ok") is False and reply.get("fenced") is True
        assert "pool" not in reply, f"fenced locate leaked pool: {reply}"
        # A new pull still completes — over chunks, never the mapping.
        chunk_pulls = []
        real_chunks = fetcher._pull_chunks

        def _counted(*a, **k):
            chunk_pulls.append(1)
            return real_chunks(*a, **k)

        monkeypatch.setattr(fetcher, "_pull_chunks", _counted)
        assert fetcher.pull(oid, server.address, timeout=20.0)
        assert chunk_pulls, "pull bypassed the fence"
        np.testing.assert_array_equal(consumer_store.get(oid), arr)
    finally:
        if fetcher is not None:
            fetcher.close()
        if server is not None:
            server.shutdown()
        provider_pool.destroy()
        consumer_pool.destroy()


def test_pool_full_hands_off_to_segment_ladder(monkeypatch):
    """Pool exhaustion must degrade to per-object segments (the spill
    ladder's first rung), never fail the put."""
    name = f"/rtpt_ladder_{os.getpid()}"
    owner = PoolStore(name, create=True, pool_bytes=4 << 20, max_objects=64)
    monkeypatch.setenv("RAY_TPU_TORCH_POOL_NAME", name)
    monkeypatch.setattr(
        "ray_tpu_torch._private.config.RayConfig.put_backpressure_timeout_s", 0.5,
        raising=False,
    )
    store = ObjectStore()
    try:
        assert store.has_pool
        locs = []
        payloads = {}
        # pid-salted ids: per-object segment names derive from the oid
        # and outlive a crashed run — fixed ids would collide with a
        # leaked /dev/shm entry from a previous failure.
        salt = os.getpid() << 16
        for i in range(8):  # 8 x 1MB into a 4MB pool: must overflow
            oid = ObjectID(_oid(salt + i))
            arr = np.full(1 << 17, i, dtype=np.float64)  # 1MB
            loc, _size = store.put(oid, arr)
            locs.append(loc)
            payloads[oid] = arr
        assert "pool" in locs, locs
        assert any(l != "pool" for l in locs), (
            f"4MB pool absorbed 8MB without segment fallback: {locs}"
        )
        # Every object readable regardless of which rung holds it.
        for oid, arr in payloads.items():
            np.testing.assert_array_equal(store.get(oid), arr)
        for oid in payloads:
            store.delete(oid)
    finally:
        store.close()
        owner.destroy()
