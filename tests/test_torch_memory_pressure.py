"""The port's memory-pressure ladder: tests/test_memory_pressure.py, case
for case, on the port's runtime; every test has a deadline after which it
fails instead of hanging, and every `get` a timeout.

The reference's docstring: memory-pressure ladder: object spilling to
disk + OOM worker killing.

Reference behavior: src/ray/raylet/local_object_manager.h:41-110 (spill
under pressure, restore on get), src/ray/common/memory_monitor.h:52 and
worker_killing_policy_retriable_fifo.h (kill newest retriable task
first; non-retriable fail with OutOfMemoryError).
"""
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import OutOfMemoryError


DEADLINE_S = 150
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


def _native_pool_available() -> bool:
    from ray_tpu_torch._private.native_store import native_available

    return native_available()


@pytest.mark.skipif(
    not _native_pool_available(),
    reason="spilling manages the native pool arena; no native store here",
)
def test_spilling_keeps_live_objects_readable(tmp_path):
    """2x the pool size of live-ref'd objects: every get still returns
    (cold objects spill to disk and reads fall back to the file)."""
    pool_bytes = 32 << 20
    spill_dir = str(tmp_path / "spill")
    ray_tpu_torch.init(
        num_cpus=2,
        ignore_reinit_error=True,
        _system_config={
            "object_store_memory_bytes": pool_bytes,
            "object_spilling_directory": spill_dir,
            "object_spilling_threshold": 0.5,
        },
    )
    try:
        from ray_tpu_torch._private.worker import global_client

        client = global_client()
        each = 2 << 20  # 2 MiB per object
        n = (2 * pool_bytes) // each  # 2x pool size, all live refs
        refs = []
        for i in range(n):
            refs.append(ray_tpu_torch.put(np.full(each // 4, i, dtype=np.int32)))
            # Deterministic: drive the spill rung directly instead of
            # sleep-polling the 0.2s monitor cadence (the old
            # time.sleep(0.02) waits made this test a flake magnet).
            if i % 4 == 3:
                client.request({"type": "spill_tick"})
        client.request({"type": "spill_tick"})
        spilled = os.listdir(spill_dir) if os.path.isdir(spill_dir) else []
        assert spilled, "no objects were spilled at 2x pool occupancy"
        # Every object — spilled or resident — still reads correctly.
        for i, ref in enumerate(refs):
            arr = ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)
            assert arr[0] == i and arr[-1] == i
    finally:
        ray_tpu_torch.shutdown()


def test_oom_kills_nonretriable_with_oom_error(tmp_path):
    usage_file = tmp_path / "usage"
    usage_file.write_text("0.10")
    ray_tpu_torch.init(
        num_cpus=2,
        ignore_reinit_error=True,
        _system_config={
            "testing_memory_usage_file": str(usage_file),
            "memory_usage_threshold": 0.9,
            "memory_monitor_refresh_ms": 100,
        },
    )
    try:
        @ray_tpu_torch.remote(max_retries=0)
        def hog():
            time.sleep(60)
            return "survived"

        # A function's first-ever call ships its blob through the GCS
        # route, so the GCS schedules (and can OOM-target) the worker.
        ref = hog.remote()
        time.sleep(1.0)  # task running
        usage_file.write_text("0.97")  # breach the threshold
        with pytest.raises(OutOfMemoryError):
            ray_tpu_torch.get(ref, timeout=30)
        usage_file.write_text("0.10")
    finally:
        ray_tpu_torch.shutdown()


def test_oom_group_by_owner_fairness_two_jobs(tmp_path):
    """Kill-ladder fairness tier (reference:
    worker_killing_policy_group_by_owner.h): under memory pressure with
    job A running a 3-task burst (submitted from inside a worker — its
    own owner/client id) and job B running one task (the driver), the
    victim comes from job A's burst. Job B's single task must complete
    without ever being killed."""
    usage_file = tmp_path / "usage"
    usage_file.write_text("0.10")
    ray_tpu_torch.init(
        num_cpus=8,
        ignore_reinit_error=True,
        _system_config={
            "testing_memory_usage_file": str(usage_file),
            "memory_usage_threshold": 0.9,
            "memory_monitor_refresh_ms": 300,
        },
    )
    try:
        flag_a = str(tmp_path / "job_a_attempts")
        flag_b = str(tmp_path / "job_b_attempts")

        @ray_tpu_torch.remote(max_retries=3)
        def hog(path, dep, hold_s):
            with open(path, "a") as f:
                f.write("attempt\n")
            t0 = time.time()
            while time.time() - t0 < hold_s:
                time.sleep(0.05)
            return "done"

        @ray_tpu_torch.remote(max_retries=0)
        def spawner(path, dep):
            # Job A: this worker process is the submitting client for
            # three hogs (a dep ref keeps them on the GCS route, where
            # the monitor can see and target them).
            d2 = ray_tpu_torch.put(b"y")
            refs = [hog.remote(path, d2, 6.0) for _ in range(3)]
            return ray_tpu_torch.get(refs, timeout=90)

        dep = ray_tpu_torch.put(b"x")
        b_ref = hog.remote(flag_b, dep, 5.0)  # job B: one task
        s_ref = spawner.remote(flag_a, dep)
        # Wait until all four hogs are running.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            a_n = (
                len(open(flag_a).readlines())
                if os.path.exists(flag_a)
                else 0
            )
            b_n = (
                len(open(flag_b).readlines())
                if os.path.exists(flag_b)
                else 0
            )
            if a_n >= 3 and b_n >= 1:
                break
            time.sleep(0.1)
        assert a_n >= 3 and b_n >= 1, "hogs never started"
        time.sleep(0.3)
        usage_file.write_text("0.97")  # one-ish monitor tick of pressure
        time.sleep(0.45)
        usage_file.write_text("0.10")
        # Both jobs complete; the burst (job A) absorbed the kill(s).
        assert ray_tpu_torch.get(b_ref, timeout=60) == "done"
        assert ray_tpu_torch.get(s_ref, timeout=120) == ["done"] * 3
        with open(flag_a) as f:
            a_attempts = len(f.readlines())
        with open(flag_b) as f:
            b_attempts = len(f.readlines())
        assert b_attempts == 1, (
            f"job B's single task was killed ({b_attempts} attempts) "
            "while job A ran a 3-task burst"
        )
        assert a_attempts >= 4, (
            "no job-A task was killed — the pressure tick never fired?"
        )
    finally:
        ray_tpu_torch.shutdown()


def test_oom_prefers_retriable_and_resubmits(tmp_path):
    usage_file = tmp_path / "usage"
    usage_file.write_text("0.10")
    ray_tpu_torch.init(
        num_cpus=4,
        ignore_reinit_error=True,
        _system_config={
            "testing_memory_usage_file": str(usage_file),
            "memory_usage_threshold": 0.9,
            "memory_monitor_refresh_ms": 100,
        },
    )
    try:
        flag = str(tmp_path / "attempt")

        @ray_tpu_torch.remote(max_retries=2)
        def retriable(flag_path):
            # First attempt parks (gets OOM-killed); the resubmitted
            # attempt returns immediately.
            if not os.path.exists(flag_path):
                with open(flag_path, "w") as f:
                    f.write("1")
                time.sleep(60)
            return "second attempt"

        ref = retriable.remote(flag)
        deadline = time.monotonic() + 15
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(flag), "task never started"
        time.sleep(0.3)
        usage_file.write_text("0.97")
        time.sleep(0.5)
        usage_file.write_text("0.10")  # recover so the retry survives
        assert ray_tpu_torch.get(ref, timeout=30) == "second attempt"
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.skipif(
    not _native_pool_available(),
    reason="spilling manages the native pool arena; no native store here",
)
def test_truncated_spill_file_never_returns_garbage(tmp_path):
    """Regression: a hand-truncated spill file must NEVER
    restore as silently wrong bytes. A put object (no lineage) resolves
    ObjectLostError — the directory drops the bad file and answers LOST
    — while a task-produced object reconstructs through lineage on the
    next get (correct bytes, not an error)."""
    from ray_tpu_torch._private.object_store import spill_path
    from ray_tpu_torch._private.worker import _global, global_client
    from ray_tpu_torch.exceptions import ObjectLostError

    pool_bytes = 8 << 20
    spill_dir = str(tmp_path / "spill")
    ray_tpu_torch.init(
        num_cpus=2,
        ignore_reinit_error=True,
        _system_config={
            "object_store_memory_bytes": pool_bytes,
            "object_spilling_directory": spill_dir,
            "object_spilling_threshold": 0.3,
        },
    )
    try:
        client = global_client()
        gcs = _global.node.gcs

        def truncate(ref):
            path = spill_path(spill_dir, ref.id())
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
            return path

        def spilled_of(refs):
            return [
                r for r in refs
                if (e := gcs.objects.get(r.id().binary())) is not None
                and e.spilled_path is not None
            ]

        # -- put object (no lineage): corrupt spill resolves LOST.
        refs = [
            ray_tpu_torch.put(np.full(256 * 1024, i, dtype=np.int32))
            for i in range(8)
        ]
        client.request({"type": "spill_tick"})
        spilled = spilled_of(refs)
        assert spilled, "nothing spilled at 4x the threshold"
        victim = spilled[0]
        path = truncate(victim)
        # The driver holds no local copy (puts went straight to pool and
        # the pool copy was freed by the spill) — the get must detect
        # the corruption and fail LOST, never return truncated bytes.
        with pytest.raises(ObjectLostError):
            ray_tpu_torch.get(victim, timeout=30)
        # The head validates the report (and unlinks the bad file) on a
        # background thread — poll briefly for the drop to land.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and os.path.exists(path):
            time.sleep(0.05)
        assert not os.path.exists(path), "corrupt spill file not dropped"
        entry = gcs.objects.get(victim.id().binary())
        assert entry is None or entry.spilled_path is None
        # Untouched spilled objects still restore bit-exact.
        for r in spilled[1:]:
            i = refs.index(r)
            arr = ray_tpu_torch.get(r, timeout=30)
            assert arr[0] == i and arr[-1] == i
        ray_tpu_torch.free(refs)

        # -- task result (lineage): corrupt spill reconstructs.
        @ray_tpu_torch.remote(max_retries=3)
        def make(i):
            return np.full(256 * 1024, i, dtype=np.int32)

        made = [make.remote(i) for i in range(6)]
        vals = ray_tpu_torch.get(made, timeout=60)
        assert all(int(v[0]) == i for i, v in enumerate(vals))
        del vals
        client.request({"type": "spill_tick"})
        spilled = spilled_of(made)
        if spilled:
            victim = spilled[0]
            i = made.index(victim)
            truncate(victim)
            try:
                client.store.delete(victim.id())  # drop any local replica
            except Exception:  # noqa: BLE001
                pass
            arr = ray_tpu_torch.get(victim, timeout=60)
            assert arr[0] == i and arr[-1] == i, \
                "reconstruction returned junk"
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.skipif(
    not _native_pool_available(),
    reason="put backpressure gates on the native pool arena",
)
def test_put_backpressure_waits_for_spill(tmp_path):
    """A put against a full pool blocks (bounded) while the spill rung
    frees space, instead of immediately overflowing — and completes
    once the ladder has run."""
    import threading

    from ray_tpu_torch._private.worker import global_client

    pool_bytes = 16 << 20
    spill_dir = str(tmp_path / "spill")
    ray_tpu_torch.init(
        num_cpus=1,
        ignore_reinit_error=True,
        _system_config={
            "object_store_memory_bytes": pool_bytes,
            "object_spilling_directory": spill_dir,
            "object_spilling_threshold": 0.8,
            "put_backpressure_timeout_s": 8.0,
        },
    )
    try:
        client = global_client()
        # Fill the pool (threshold high so the monitor stays quiet).
        refs = [
            ray_tpu_torch.put(np.zeros(512 * 1024, dtype=np.int32))
            for i in range(7)
        ]
        # Spill ticks a moment later free space; the blocked put must
        # complete within the backpressure window (not fall to an
        # unbounded segment the instant the pool is full).
        ticker_stop = threading.Event()

        def tick():
            while not ticker_stop.wait(0.3):
                client.request({"type": "spill_tick"})

        t = threading.Thread(target=tick, daemon=True)
        t.start()
        try:
            late = ray_tpu_torch.put(np.full(512 * 1024, 7, dtype=np.int32))
            arr = ray_tpu_torch.get(late, timeout=30)
            assert arr[0] == 7 and arr[-1] == 7
        finally:
            ticker_stop.set()
            t.join(5)
        for r in refs:
            assert ray_tpu_torch.get(r, timeout=30)[0] == 0
    finally:
        ray_tpu_torch.shutdown()
