"""The port's lock witness: tests/test_lock_witness.py, case for case,
against the port's `_private/lock_witness.py` (armed by
`RAY_TPU_TORCH_lock_witness`, sidecar file
`RAY_TPU_TORCH_lock_witness_file`). Every test has a deadline after
which it fails instead of hanging.

The reference's docstring: LockWitness: the runtime lock-order race detector (TSan-lite).

Covers the acceptance triad: an intentionally inverted lock pair is
caught, a consistent ordering stays clean, and reentrant RLock
acquisition produces no false positive — plus the Condition/Event
integration the runtime leans on and the witnessed-under-load check.
"""
import os
import signal
import threading

import pytest

from ray_tpu_torch._private import lock_witness as lw

DEADLINE_S = 60


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
def witness(monkeypatch):
    """Fresh witness per test; uninstall + reset afterwards so other
    tests see pristine threading factories. The session sidecar file
    is detached for the duration — these tests trip inversions ON
    PURPOSE, and under the race run those must not land in the sidecar
    the race run scans."""
    monkeypatch.delenv(lw.FILE_ENV, raising=False)
    was_installed = lw.installed()
    lw.clear()
    lw.install()
    yield lw
    if not was_installed:
        lw.uninstall()
    lw.clear()


def _make_locks(witness):
    # Distinct creation lines => distinct witness sites.
    a = threading.Lock()
    b = threading.Lock()
    return a, b


def test_inverted_pair_detected(witness):
    a, b = _make_locks(witness)
    with a:
        with b:
            pass
    assert not witness.violations(), "consistent order must be clean"
    # Reverse order: the inversion fires at acquire time, in whatever
    # thread performs it (no deadlock needed — a IS free here).
    with b:
        with a:
            pass
    vs = witness.violations()
    assert len(vs) == 1
    v = vs[0]
    assert v.first != v.second
    assert "lock-order inversion" in v.render()
    assert "this acquisition" in v.render()
    with pytest.raises(AssertionError):
        witness.assert_clean()


def test_inverted_pair_across_threads(witness):
    a, b = _make_locks(witness)

    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    t = threading.Thread(target=order_ab)
    t.start()
    t.join()
    t = threading.Thread(target=order_ba)
    t.start()
    t.join()
    assert len(witness.violations()) == 1


def test_consistent_order_clean(witness):
    a, b = _make_locks(witness)
    for _ in range(50):
        with a:
            with b:
                pass
    witness.assert_clean()
    rep = witness.witness_report()
    assert rep["violations"] == 0
    assert rep["edges"] >= 1


def test_transitive_cycle_detected(witness):
    a = threading.Lock()
    b = threading.Lock()
    c = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    witness.assert_clean()
    with c:
        with a:  # closes a->b->c->a
            pass
    vs = witness.violations()
    assert len(vs) == 1
    assert len(vs[0].path) == 3  # c -> ... -> a chain witnessed


def test_reentrant_rlock_no_false_positive(witness):
    r = threading.RLock()
    other = threading.Lock()
    with r:
        with r:  # reentrant: no self-edge, no violation
            with other:
                pass
        with r:
            pass
    witness.assert_clean()


def test_rlock_inversion_still_detected(witness):
    r = threading.RLock()
    lk = threading.Lock()
    with r:
        with lk:
            pass
    with lk:
        with r:
            pass
    assert len(witness.violations()) == 1


def test_same_site_siblings_ignored(witness):
    # Per-shard pattern: N locks born on ONE line share a site; order
    # between siblings is not witnessable (documented limitation) and
    # must not self-cycle.
    locks = [threading.Lock() for _ in range(4)]
    with locks[0]:
        with locks[1]:
            pass
    with locks[2]:
        with locks[3]:
            pass
    with locks[3]:
        with locks[2]:
            pass
    witness.assert_clean()


def test_condition_and_event_integration(witness):
    """Condition(RLock) waits/notifies and Event set/wait work
    unchanged under the witness (the _release_save protocol)."""
    cond = threading.Condition(threading.RLock())
    evt = threading.Event()
    state = {"go": False, "seen": False}

    def waiter():
        with cond:
            while not state["go"]:
                cond.wait(timeout=5)
            state["seen"] = True
        evt.set()

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        state["go"] = True
        cond.notify_all()
    assert evt.wait(timeout=5)
    t.join(timeout=5)
    assert state["seen"]
    witness.assert_clean()


def test_nonblocking_acquire_failure_adds_nothing(witness):
    a = threading.Lock()
    b = threading.Lock()
    # Establish a -> b.
    with a:
        assert b.acquire(blocking=False)
        b.release()

    results = {}

    def try_inverted():
        # b held here; a is held by the main thread, so the
        # try-acquire FAILS — a failed acquire must record no b->a
        # edge (the inversion never happened).
        with b:
            results["got_a"] = a.acquire(blocking=False)

    with a:
        t = threading.Thread(target=try_inverted)
        t.start()
        t.join(timeout=5)
    assert results["got_a"] is False
    witness.assert_clean()


def test_violation_reported_once_per_pair(witness):
    a, b = _make_locks(witness)
    with a:
        with b:
            pass
    for _ in range(5):
        with b:
            with a:
                pass
    assert len(witness.violations()) == 1


def test_cross_thread_release_no_phantom(witness):
    """Lock handoff (acquired in one thread, released by another)
    must not leave a phantom entry on the acquirer's held stack —
    the phantom would seed false held-before edges from a lock the
    thread no longer holds and fail the race run on code with no real
    ordering bug."""
    h = threading.Lock()
    x = threading.Lock()
    y = threading.Lock()
    h.acquire()
    t = threading.Thread(target=h.release)  # handoff release
    t.start()
    t.join(timeout=5)
    # h is no longer held here: x-then-y must record x->y only, with
    # no h->x edge from the stale stack entry.
    with x:
        with y:
            pass

    def x_then_h():
        with x:
            with h:
                pass

    t = threading.Thread(target=x_then_h)
    t.start()
    t.join(timeout=5)
    # A phantom h would have made x->h close a fake h->x->h cycle.
    witness.assert_clean()


def test_same_basename_distinct_dirs_distinct_sites(witness, tmp_path):
    """Locks created in different files sharing a basename AND line
    number must be distinct graph nodes — merging them fabricates an
    inversion between locks that never interact (or masks a real
    one)."""
    import importlib.util

    src = "import threading\nL = threading.Lock()\n"
    mods = []
    for d in ("a", "b"):
        pkg = tmp_path / d
        pkg.mkdir()
        f = pkg / "samename.py"
        f.write_text(src)
        spec = importlib.util.spec_from_file_location(
            f"_lw_samename_{d}", f
        )
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        mods.append(m)
    la, lb = mods[0].L, mods[1].L
    assert la._site != lb._site
    q = threading.Lock()
    # q->la in one order, lb->q in the other: only a basename-keyed
    # witness would see these as one node and report a cycle.
    with q:
        with la:
            pass
    with lb:
        with q:
            pass
    witness.assert_clean()


def test_queue_under_witness(witness):
    """queue.Queue (Condition-heavy) round-trips across threads."""
    import queue

    q = queue.Queue()

    def produce():
        for i in range(100):
            q.put(i)

    t = threading.Thread(target=produce)
    t.start()
    got = [q.get(timeout=5) for _ in range(100)]
    t.join(timeout=5)
    assert got == list(range(100))
    witness.assert_clean()


def test_at_fork_reinit_clears_held_entry(witness):
    """CPython's at-fork hooks acquire module locks in the parent and
    _at_fork_reinit() them in the child instead of releasing — the
    witness must treat the reinit as the release, or the child keeps
    phantom held entries that fabricate inversions (seen live with
    logging._lock vs concurrent.futures' shutdown lock at exit)."""
    for make in (threading.Lock, threading.RLock):
        a = make()
        x = threading.Lock()
        a.acquire()
        a._at_fork_reinit()  # child-side stand-in for release()
        # a is no longer held: taking x must not record an a->x edge.
        with x:
            pass

        def x_then_a(a=a, x=x):
            with x:
                with a:  # only real edge; must not close a fake cycle
                    pass

        t = threading.Thread(target=x_then_a)
        t.start()
        t.join(timeout=5)
    witness.assert_clean()


def test_violation_written_to_sidecar_file(witness, tmp_path,
                                           monkeypatch):
    """With FILE_ENV set, a violation is appended to the sidecar —
    the channel that lets the race run fail on inversions
    witnessed in other processes."""
    side = tmp_path / "witness.log"
    monkeypatch.setenv(lw.FILE_ENV, str(side))
    a, b = _make_locks(witness)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    text = side.read_text()
    assert "lock-order inversion" in text
    assert f"[pid {os.getpid()}]" in text


def test_subprocess_violation_reaches_sidecar(tmp_path):
    """The daemon path end-to-end: a CHILD process self-installs off
    the inherited env, trips an inversion, and its finding lands in
    the shared sidecar file — this is what closes the 'inversion in a
    spawned head/raylet/worker passes CI' hole."""
    import subprocess
    import sys

    side = tmp_path / "witness.log"
    env = dict(os.environ)
    env[lw.ENV_VAR] = "1"
    env[lw.FILE_ENV] = str(side)
    code = (
        "from ray_tpu_torch._private import lock_witness as lw\n"
        "assert lw.maybe_install()\n"
        "import threading\n"
        "a = threading.Lock()\n"
        "b = threading.Lock()\n"
        "with a:\n"
        "    with b:\n"
        "        pass\n"
        "with b:\n"
        "    with a:\n"
        "        pass\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    text = side.read_text()
    assert "lock-order inversion" in text
    # The pid recorded is NOT ours: the finding crossed processes.
    assert f"[pid {os.getpid()}]" not in text


def test_uninstall_restores_factories():
    # Preserve the session's installed state: under the race run the
    # witness is armed session-wide and must STAY armed after this
    # test (a stray uninstall would silently disable the inversion
    # check for every suite that follows).
    was_installed = lw.installed()
    lw.clear()
    lw.install()
    try:
        assert threading.Lock is lw.WitnessLock
    finally:
        lw.uninstall()
    assert threading.Lock is lw._REAL_LOCK
    assert threading.RLock is lw._REAL_RLOCK
    lk = threading.Lock()
    assert not isinstance(lk, lw.WitnessLock)
    if was_installed:
        lw.install()


def test_witnessed_runtime_locks_smoke(witness):
    """The real object-plane structures run under the witness: a
    sharded directory + owner tracker exercise their lock stacks
    (shard locks, GCS-free callback, tracker lock) without a
    violation — the in-process slice of what the race run soaks."""

    class _Entry:
        def __init__(self):
            self.holders = set()
            self.status = "READY"
            self.waiters = []
            self.task_pins = 0
            self.child_pins = 0
            self.owner = None
            self.owner_released = False
            self.had_holder = False

    from ray_tpu_torch._private.object_plane.directory import (
        ShardedObjectDirectory,
    )

    freed = []
    d = ShardedObjectDirectory(
        _Entry, num_shards=4, free_callback=freed.extend
    )
    try:
        oids = [bytes([i]) * 8 for i in range(32)]
        for oid in oids:
            d[oid] = _Entry()
        d.enqueue([("badd", oid, b"client-1") for oid in oids])
        d.enqueue([("release", oid, b"owner-1") for oid in oids])
        d.enqueue([("bdel", oid, b"client-1") for oid in oids])
        assert d.flush(timeout=10)
        assert sorted(freed) == sorted(oids)
    finally:
        d.stop()
    witness.assert_clean()


# ------------------------------------------------------------ the port's own


def test_rlock_reports_its_recursion_count(witness):
    """A witnessed RLock answers `_recursion_count()` as CPython's does:
    the calling thread's depth, 0 in any other thread."""
    r = threading.RLock()
    assert r._recursion_count() == 0
    seen = {}
    with r:
        with r:
            assert r._recursion_count() == 2
            t = threading.Thread(target=lambda: seen.update(n=r._recursion_count()))
            t.start()
            t.join(timeout=5)
        assert r._recursion_count() == 1
    assert r._recursion_count() == 0 and seen == {"n": 0}


def test_shared_memory_segment_under_the_witness(tmp_path):
    """A process that arms the witness and then makes a shared-memory
    segment, as a worker's put does: multiprocessing's resource tracker
    reads its RLock's `_recursion_count()` on first use, which the
    witness's RLock lacked, so every put through a segment failed in a
    witnessed process (found by the race run, `python -m
    ray_tpu_torch._lint --race`, in the object-plane file's actor puts)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env[lw.ENV_VAR] = "1"
    env[lw.FILE_ENV] = str(tmp_path / "witness.log")
    code = (
        "import threading\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch._private import lock_witness as lw\n"
        "assert lw.installed() and threading.RLock is lw.WitnessRLock\n"
        "from multiprocessing import shared_memory\n"
        "shm = shared_memory.SharedMemory(create=True, size=4096)\n"
        "shm.buf[:5] = b'hello'\n"
        "assert bytes(shm.buf[:5]) == b'hello'\n"
        "shm.close()\n"
        "shm.unlink()\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
