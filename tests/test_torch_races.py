"""Races the port's runtime inherited from the reference, and their repairs.

- The GCS drops a corrupt spill file only after the object's entry has
  stopped naming it (the reference unlinks first, so a reader could find
  a path whose file was gone): tests/test_memory_pressure.py's truncated
  spill case on the port, the order itself, checked where the file leaves
  its path, and a new spill written at that path meanwhile, which stays.
- The native store guards its handle with one lock, so a call racing
  close() raises or answers "absent" where it used a freed store and
  crashed the process: a store closed under threads hammering it, in a
  subprocess so a crash fails the test instead of the run.
- A function's first call ships it with its submit through the head; a
  later call on a leased worker can ask the head for the function before
  the head has read that submit, and fails with "not found in GCS". The
  port registers a function with the head, and waits for the answer,
  before its first call is submitted.

Every test has a deadline after which it fails instead of hanging.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import ObjectLostError

DEADLINE_S = 120
SUBPROCESS_TIMEOUT_S = 100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def spilling(tmp_path):
    """The port's runtime on an 8 MiB pool that spills past 30%, as the
    reference's test runs its own."""
    from ray_tpu_torch._private.native_store import native_available

    if not native_available():
        pytest.skip("spilling manages the native pool arena; no native store here")
    spill_dir = str(tmp_path / "spill")
    ray_tpu_torch.init(
        num_cpus=2,
        ignore_reinit_error=True,
        _system_config={
            "object_store_memory_bytes": 8 << 20,
            "object_spilling_directory": spill_dir,
            "object_spilling_threshold": 0.3,
        },
    )
    try:
        yield spill_dir
    finally:
        ray_tpu_torch.shutdown()


def _spilled(refs):
    """The refs whose entries name a spill file, with the GCS and client."""
    from ray_tpu_torch._private.worker import _global, global_client

    client = global_client()
    gcs = _global.node.gcs
    client.request({"type": "spill_tick"})
    spilled = [r for r in refs
               if (e := gcs.objects.get(r.id().binary())) is not None
               and e.spilled_path is not None]
    assert spilled, "nothing spilled at 4x the threshold"
    return gcs, client, spilled


def _truncate(spill_dir, ref):
    from ray_tpu_torch._private.object_store import spill_path

    path = spill_path(spill_dir, ref.id())
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    return path


def test_truncated_spill_file_never_returns_garbage(spilling):
    """tests/test_memory_pressure.py's case on the port: a put object whose
    spill file was cut in half resolves ObjectLostError, and once the file
    is gone its entry names no file; a task's result reconstructs."""
    refs = [ray_tpu_torch.put(np.full(256 * 1024, i, dtype=np.int32)) for i in range(8)]
    gcs, client, spilled = _spilled(refs)
    victim = spilled[0]
    path = _truncate(spilling, victim)
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(victim, timeout=30)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and os.path.exists(path):
        time.sleep(0.05)
    assert not os.path.exists(path), "corrupt spill file not dropped"
    entry = gcs.objects.get(victim.id().binary())
    assert entry is None or entry.spilled_path is None
    for r in spilled[1:]:
        i = refs.index(r)
        arr = ray_tpu_torch.get(r, timeout=30)
        assert arr[0] == i and arr[-1] == i
    ray_tpu_torch.free(refs)

    @ray_tpu_torch.remote(max_retries=3)
    def make(i):
        return np.full(256 * 1024, i, dtype=np.int32)

    made = [make.remote(i) for i in range(6)]
    vals = ray_tpu_torch.get(made, timeout=60)
    assert all(int(v[0]) == i for i, v in enumerate(vals))
    del vals
    client.request({"type": "spill_tick"})
    spilled = [r for r in made
               if (e := gcs.objects.get(r.id().binary())) is not None
               and e.spilled_path is not None]
    if spilled:
        victim = spilled[0]
        i = made.index(victim)
        _truncate(spilling, victim)
        try:
            client.store.delete(victim.id())  # drop any local replica
        except Exception:  # noqa: BLE001
            pass
        arr = ray_tpu_torch.get(victim, timeout=60)
        assert arr[0] == i and arr[-1] == i, "reconstruction returned junk"


def test_a_corrupt_spill_file_goes_only_after_its_entry_stops_naming_it(spilling, monkeypatch):
    """The order itself, on the GCS's own validation of a report: when the
    corrupt file leaves its path (moved aside, then unlinked), the entry
    already names no file and is LOST. The other order (unlink, then
    clear the entry) fails here."""
    from ray_tpu_torch._private import gcs as gcs_module

    refs = [ray_tpu_torch.put(np.full(256 * 1024, i, dtype=np.int32)) for i in range(8)]
    gcs, _, spilled = _spilled(refs)
    victim = spilled[0]
    oid = victim.id().binary()
    path = _truncate(spilling, victim)
    seen = []
    unlink, rename = os.unlink, os.rename

    def watch(p):
        if p == path:
            entry = gcs.objects.get(oid)
            seen.append((entry.spilled_path, entry.status))

    def watched_unlink(p, *args, **kwargs):
        watch(p)
        return unlink(p, *args, **kwargs)

    def watched_rename(src, dst, *args, **kwargs):
        watch(src)
        return rename(src, dst, *args, **kwargs)

    monkeypatch.setattr(os, "unlink", watched_unlink)
    monkeypatch.setattr(os, "rename", watched_rename)
    gcs._validate_spill_report(oid, path)
    monkeypatch.setattr(os, "unlink", unlink)
    monkeypatch.setattr(os, "rename", rename)
    assert seen == [(None, gcs_module.LOST)]
    assert not os.path.exists(path)
    assert not [f for f in os.listdir(os.path.dirname(path)) if ".corrupt-" in f]
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(victim, timeout=30)


def test_a_spill_written_at_the_path_after_the_entry_was_cleared_stays(spilling, monkeypatch):
    """The window after the entry is cleared and before the corrupt file is
    unlinked: a new spill of the object (reconstructed meanwhile) writes
    the same path, which depends only on the object id. The corrupt file
    was moved aside under the lock, so only it goes and the new file
    stays; unlinking by the path would delete the new one."""
    refs = [ray_tpu_torch.put(np.full(256 * 1024, i, dtype=np.int32)) for i in range(8)]
    gcs, _, spilled = _spilled(refs)
    victim = spilled[0]
    oid = victim.id().binary()
    path = _truncate(spilling, victim)
    unlink = os.unlink

    def respill_then_unlink(p, *args, **kwargs):
        if str(p).startswith(path):
            with open(path, "wb") as f:
                f.write(b"the object's new spill")
        return unlink(p, *args, **kwargs)

    monkeypatch.setattr(os, "unlink", respill_then_unlink)
    gcs._validate_spill_report(oid, path)
    monkeypatch.setattr(os, "unlink", unlink)
    with open(path, "rb") as f:
        assert f.read() == b"the object's new spill"
    assert not [f for f in os.listdir(os.path.dirname(path)) if ".corrupt-" in f]
    unlink(path)


_HAMMER = textwrap.dedent("""
    import os, sys, threading
    from ray_tpu_torch._private.native_store import PoolStore, native_available

    if not native_available():
        print("no native store"); sys.exit(3)
    for it in range(ROUNDS):
        st = PoolStore(f"/rtpt_race_{os.getpid()}_{it}", create=True,
                       pool_bytes=8 << 20, max_objects=1024)
        ids = [bytes([k, it % 256]) * 10 for k in range(32)]
        for oid in ids:
            view = st.create(oid, 64)
            view[:] = b"x" * 64
            del view
            assert st.seal(oid)
        stop = threading.Event()
        absent = []

        def hammer():
            while not stop.is_set():
                for oid in ids:
                    view = st.get(oid)
                    if view is None:
                        absent.append(oid)
                    else:
                        del view
                        st.release(oid)
                    st.delete(oid)
                    st.contains(oid)
                    try:
                        st.stats()
                    except RuntimeError as e:
                        assert str(e) == "store closed", e

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        st.destroy()
        stop.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        # closed: every call answers "absent", does nothing or raises
        assert st.get(ids[0]) is None and st.create(b"z" * 20, 8) is None
        assert not st.seal(ids[0]) and not st.contains(ids[0])
        st.release(ids[0]); st.delete(ids[0])
        for call in (st.stats, st.sweep, st.sweep_stats):
            try:
                call()
                raise AssertionError(f"{call.__name__} ran on a closed store")
            except RuntimeError as e:
                assert str(e) == "store closed", e
    print("OK")
""")


def test_a_store_closed_under_hammering_threads_never_crashes():
    """Four threads get, release, delete, test and read the stats of a
    pool's objects while the pool is closed under them, 50 times over: no
    call crashes the process, and after close every call answers
    "absent", does nothing or raises RuntimeError("store closed"). The
    parent's store, which checked the handle without a lock, died of
    SIGSEGV or SIGABRT here."""
    out = subprocess.run(
        [sys.executable, "-c", _HAMMER.replace("ROUNDS", "50")],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    if out.returncode == 3:
        pytest.skip("no native store here")
    assert out.returncode == 0, (out.returncode, out.stdout, out.stderr[-2000:])
    assert out.stdout.strip() == "OK"


@pytest.fixture
def small_cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def test_a_leased_call_never_reaches_a_worker_before_the_head_knows_its_function(
    small_cluster, monkeypatch
):
    """The head reads submits late; a new function's calls all succeed, and
    the head knew the function when its first call returned."""
    from ray_tpu_torch._private.worker import _global

    gcs = _global.node.gcs

    @ray_tpu_torch.remote
    def warm(i):
        return i

    # Idle workers this process can lease, as after any burst.
    assert ray_tpu_torch.get([warm.remote(i) for i in range(8)], timeout=60) == list(range(8))
    slow_submit = gcs._h_submit_task

    def late(state, msg):
        time.sleep(0.5)
        slow_submit(state, msg)

    monkeypatch.setattr(gcs, "_h_submit_task", late)

    @ray_tpu_torch.remote
    def fresh(i):
        return i * 2

    first = fresh.remote(0)
    assert fresh._function_id in gcs.functions
    rest = [fresh.remote(i) for i in range(1, 4)]
    assert ray_tpu_torch.get([first] + rest, timeout=60) == [0, 2, 4, 6]
