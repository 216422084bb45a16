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
- A head killed after an actor's creation finished but before a persist
  tick wrote it ALIVE restores the actor PENDING. The reference queues
  its creation at once and refuses the surviving worker's claim, which
  drops the live instance: a second instance starts from scratch, or
  calls find the actor gone. The port holds such a creation for the
  recovery window and takes the claim, so the instance and its state
  survive: a head whose persist never records the creation's finish,
  killed under a connected driver and a node daemon.
- A session's GCS socket lay at `<temp_dir>/session_*/gcs.sock` however
  long the caller's temp dir was, so `init(_temp_dir=...)` with a long
  dir failed to bind (`AF_UNIX path too long`). The port binds such a
  session's socket under a short `/tmp/rtpt-<hash>.sock` and unlinks it
  on shutdown.
- An actor whose restart attempt died (the worker re-creating it was
  killed, or its node died, before the creation finished) stayed
  RESTARTING on no worker, its calls queued forever: the head skipped
  RESTARTING actors among a dying worker's actors. It is found by the
  partition soak (`ray_perf --only partition_soak --partition-smoke`),
  whose epoch actor wedged after its restart's node was declared dead.
  The port restarts such an actor again, from its restart budget.
- A put marked its object advertised only after its advert left: an
  advert sent on a head conn that had just died was lost, and a
  reconnect whose reconcile ran between the two never re-advertised the
  object, so a task depending on it waited at the restarted head forever
  (the partition soak's traffic wedge). The port marks it first.
- A raylet lease was returned over a connection looked up through
  `$RAY_TPU_TORCH_LOCAL_RAYLET` at return time: a process that had
  dropped the variable since (as the local-dispatch test's head-routed
  burst does, in a worker that still held warm raylet leases) lost the
  return, the raylet kept the worker leased, the head saw its CPU taken,
  and a head-routed task on that node never ran. The port returns a
  lease over the connection that holds it.
- A SIGKILLed worker left its direct-call socket `/tmp/rtpt-w-<id>.sock`
  behind (only a clean exit unlinks it). The head, for the workers it
  forks, and the node daemon, for its own, now remove it once the
  worker's process is gone.
- The head records a task RUNNING when it dispatches it. A call on a
  leased worker is never dispatched by the head, so it had no start, and
  the timeline, which pairs RUNNING with FINISHED, dropped its span
  (`test_timeline_export` lost its four spans whenever its calls found
  warm leases). A worker's batched completion of a direct or leased call
  now carries the call's start, which the head records as its RUNNING.
- A state read's barrier asked every worker to flush its batched
  completions and waited 0.25 s for their acks, then answered with what
  had arrived: on a loaded host a worker's batch could land later, and
  the listing missed calls its caller had already got back. The caller
  now names the workers and actors it pushed calls to since its last
  read, and the head waits for each of those acks while the worker
  lives (30 s at most, then an event says which it gave up on).
- A Serve handle's long-poll thread, and its router's metrics thread,
  outlived a runtime shut down without `serve.shutdown()` and submitted
  a controller call every 0.5 s into whatever session the process
  started next (the nine submits that failed
  `test_gpu_local_leases_sync_head_resource_view`, which counts the
  head's submits cluster-wide, when an earlier test file in its process
  had left a handle behind). Both end with the session they began in,
  and a later session's handle gets a router of its own.
- A driver with no node pool of its own (one attached to an external
  head) puts a small value inline through the head only. A head killed
  after acknowledging such a put and before persisting it came back
  without it; the owner's reconcile re-claimed it with no location and
  no bytes, and a task on it, resubmitted across the failover, pinned a
  PENDING entry forever (the partition soak's remaining traffic wedge).
  The owner now keeps such a put's bytes while it lives and sends them
  with its reconcile.
- A supervised head's port was picked by binding and closing a probe
  socket and bound later by the head's own process; on a busy host
  another process took it in between and the head died at startup
  (`Address already in use`). The head now binds a port of the kernel's
  choice on its first start, and the supervisor reads it back and keeps
  it for restarts.

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


# The restarted head's recovery window in the failover case below.
GRACE_S = 10.0
# Loaded by the first head of `test_an_actor_alive_after_the_last_persist_survives_a_head_failover`
# (and by nothing after it): its creation finishes never reach a persist tick.
_STALE_ACTORS_SITECUSTOMIZE = """
import os

_flag = os.environ.get("RTPT_TEST_STALE_ACTORS_FLAG")
if _flag and not os.path.exists(_flag):
    open(_flag, "w").close()
    from ray_tpu_torch._private import gcs as _gcs

    _tables = dict(_gcs.GcsServer._TABLES_OF_TYPE)
    for _mtype in ("task_done", "task_done_batch"):
        _tables[_mtype] = tuple(t for t in _tables[_mtype] if t != "actors")
    _gcs.GcsServer._TABLES_OF_TYPE = _tables
"""


def test_an_actor_alive_after_the_last_persist_survives_a_head_failover(tmp_path):
    from ray_tpu_torch.cluster_utils import DaemonCluster, SupervisedHead, _pinned_pythonpath

    inject = tmp_path / "inject"
    inject.mkdir()
    (inject / "sitecustomize.py").write_text(_STALE_ACTORS_SITECUSTOMIZE)
    flag, inits = tmp_path / "first-head", tmp_path / "inits"
    head = SupervisedHead(session_dir=str(tmp_path / "sess"), env={
        "RAY_TPU_TORCH_head_recovery_grace_s": str(GRACE_S),
        "RTPT_TEST_STALE_ACTORS_FLAG": str(flag),
        "PYTHONPATH": os.pathsep.join([str(inject), _pinned_pythonpath()]),
    })
    cluster = None
    try:
        ray_tpu_torch.init(address=head.address)
        cluster = DaemonCluster.attach(head.tcp_address, head.authkey)
        cluster.add_node(num_cpus=2)

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self, log):
                with open(log, "a") as f:
                    f.write(f"{os.getpid()}\n")
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        counter = Counter.remote(str(inits))
        assert ray_tpu_torch.get(counter.incr.remote(), timeout=60) == 1
        assert flag.exists()  # the first head ran with its creation finishes unpersisted
        time.sleep(1.0)  # persist ticks pass; none writes the actor ALIVE
        head.kill()
        assert head.wait_restarted(1, timeout=60), "head never came back"
        restarted = time.monotonic()
        value = None
        while value is None and time.monotonic() < restarted + 60:
            try:
                value = ray_tpu_torch.get(counter.incr.remote(), timeout=20)
            except Exception:  # noqa: BLE001 - mid-recovery
                time.sleep(0.5)
        # Past the recovery window, where an unclaimed creation would run.
        time.sleep(max(0.0, restarted + GRACE_S + 2 - time.monotonic()))
        # The same instance, its count kept, and no second one from scratch.
        assert value == 2, value
        assert len(inits.read_text().split()) == 1, inits.read_text()
        assert ray_tpu_torch.get(counter.incr.remote(), timeout=20) == 3
    finally:
        if cluster is not None:
            for p in list(cluster._daemons):
                try:
                    cluster.kill_node(p)
                except Exception:  # noqa: BLE001
                    pass
        try:
            ray_tpu_torch.shutdown()
        except Exception:  # noqa: BLE001
            pass
        head.stop()


def test_a_session_under_a_long_temp_dir_binds_a_short_socket(tmp_path):
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.config import temp_root

    base = os.path.join(temp_root(), f"long_{os.getpid()}_")
    long_dir = base + "d" * (90 - len(base))
    assert len(long_dir) == 90
    os.makedirs(long_dir, exist_ok=True)
    try:
        ray_tpu_torch.init(num_cpus=1, _temp_dir=long_dir)
        try:
            node = worker_mod._global.node
            address = node.address
            assert node.session_dir.startswith(long_dir)
            assert len(address) <= 100 and os.path.exists(address)
            assert address.startswith("/tmp/rtpt-")

            @ray_tpu_torch.remote
            def double(x):
                return 2 * x

            assert ray_tpu_torch.get(double.remote(21), timeout=60) == 42
        finally:
            ray_tpu_torch.shutdown()
        assert not os.path.exists(address)
    finally:
        import shutil

        shutil.rmtree(long_dir, ignore_errors=True)


def test_an_actor_whose_restart_attempt_dies_restarts_again(tmp_path):
    attempts = tmp_path / "attempts"
    attempts.mkdir()

    @ray_tpu_torch.remote(max_restarts=2)
    class Phoenix:
        def __init__(self, attempts):
            self.n = len(os.listdir(attempts))
            with open(os.path.join(attempts, str(self.n)), "w") as f:
                f.write(str(os.getpid()))
            if self.n == 1:
                time.sleep(SUBPROCESS_TIMEOUT_S)  # killed mid-creation

        def incarnation(self):
            return os.getpid(), self.n

    ray_tpu_torch.init(num_cpus=2)
    try:
        actor = Phoenix.remote(str(attempts))
        pid, n = ray_tpu_torch.get(actor.incarnation.remote(), timeout=60)
        assert n == 0
        os.kill(pid, signal.SIGKILL)
        restart = attempts / "1"
        deadline = time.monotonic() + 60
        while not (restart.exists() and restart.read_text()):
            assert time.monotonic() < deadline, "the actor's restart never began"
            time.sleep(0.05)
        os.kill(int(restart.read_text()), signal.SIGKILL)  # mid-creation
        pid2, n2 = ray_tpu_torch.get(actor.incarnation.remote(), timeout=60)
        assert n2 == 2 and pid2 not in (pid, int(restart.read_text()))
    finally:
        ray_tpu_torch.shutdown()


def test_a_put_is_marked_advertised_before_its_advert_leaves():
    from ray_tpu_torch._private.worker import global_client

    ray_tpu_torch.init(num_cpus=1)
    try:
        client = global_client()
        marked_at_send = []
        advert = client._advert_async

        def watched(msg):
            marked_at_send.append(msg["object_id"] in client._tracker._advertised)
            advert(msg)

        client._advert_async = watched
        try:
            refs = [ray_tpu_torch.put(np.ones(n)) for n in (10, 100_000)]
        finally:
            del client._advert_async
        assert marked_at_send == [True, True]
        assert [len(ray_tpu_torch.get(r, timeout=60)) for r in refs] == [10, 100_000]
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _worker_of_this_task():
    return os.getpid(), os.environ["RAY_TPU_TORCH_WORKER_ID"]


@pytest.mark.parametrize("where", ["head", "node daemon"])
def test_a_killed_workers_socket_is_removed_once_its_process_is_gone(where):
    from ray_tpu_torch.cluster_utils import DaemonCluster

    if where == "head":
        ray_tpu_torch.init(num_cpus=1)
        cluster = None
    else:
        cluster = DaemonCluster(head_node_args={"num_cpus": 0, "tcp_port": 0})
        cluster.add_node(num_cpus=1)
    try:
        pid, wid = ray_tpu_torch.get(_worker_of_this_task.remote(), timeout=60)
        path = f"/tmp/rtpt-w-{wid}.sock"
        assert os.path.exists(path)
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while os.path.exists(path):
            assert time.monotonic() < deadline, f"{path} outlived its worker"
            time.sleep(0.05)
        # The runtime goes on: a new worker takes the next task.
        assert ray_tpu_torch.get(_worker_of_this_task.remote(), timeout=60)[0] != pid
    finally:
        if cluster is None:
            ray_tpu_torch.shutdown()
        else:
            cluster.shutdown()


@ray_tpu_torch.remote
def _leaf(x):
    return x + 1


@ray_tpu_torch.remote
def _local_lease_then_the_heads_route():
    import os
    import time as _t

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_client

    rt.get(_leaf.remote(0), timeout=60)  # ships the function through the head
    rt.get(_leaf.remote(1), timeout=60)  # leased from this node's raylet
    client = global_client()
    with client._lease_lock:
        warm = [lease["raylet"] for pool in client._leases.values() for lease in pool]
    os.environ.pop("RAY_TPU_TORCH_LOCAL_RAYLET")
    _t.sleep(1.5)  # the idle lease goes home (idle 0.5 s, reaper every 0.1 s)
    return warm, rt.get(_leaf.remote(2), timeout=30)  # needs the CPU that lease held


def test_a_raylet_lease_goes_home_after_the_process_stops_leasing_locally():
    """A node of 2 CPUs: this task holds one, a warm raylet lease the
    other. Once the lease is back at the raylet, a task through the head
    runs on the freed CPU; a lost return left it waiting forever."""
    from ray_tpu_torch.cluster_utils import DaemonCluster

    cluster = DaemonCluster(head_node_args={"num_cpus": 0, "tcp_port": 0})
    try:
        cluster.add_node(num_cpus=2)
        warm, out = ray_tpu_torch.get(_local_lease_then_the_heads_route.remote(), timeout=120)
        assert warm == [True] and out == 3
    finally:
        cluster.shutdown()


def _head_submits():
    from ray_tpu_torch._private.worker import global_client

    return global_client().request({"type": "msg_counts"})["counts"].get("submit_task", 0)


def _gcs():
    from ray_tpu_torch._private.worker import _global

    return _global.node.gcs


def test_a_leased_calls_span_is_in_the_timeline(small_cluster):
    """Four calls of a function on warm leases, which the head never
    dispatches: each is a span of the timeline, at least half its sleep
    long. The head recorded no RUNNING for a leased call, and the
    timeline dropped its FINISHED for want of a start."""

    @ray_tpu_torch.remote
    def warm(i):
        return i

    @ray_tpu_torch.remote
    def slow():
        time.sleep(0.05)
        return 1

    # Idle workers, then leases of the class held by this process.
    ray_tpu_torch.get([warm.remote(i) for i in range(4)], timeout=60)
    time.sleep(1.0)
    ray_tpu_torch.get([warm.remote(i) for i in range(4)], timeout=60)
    ray_tpu_torch.get([slow.remote() for _ in range(4)], timeout=60)
    # The head never saw them submitted: they went to leases.
    assert not [e for e in _gcs().task_events if e[1] == "slow" and e[2] == "PENDING"]
    spans = [t for t in ray_tpu_torch.timeline() if t["name"] == "slow"]
    assert len(spans) == 4, spans
    assert all(t["ph"] == "X" and t["dur"] >= 50_000 * 0.5 for t in spans), spans


def test_a_state_read_sees_every_completion_its_caller_holds(small_cluster):
    """Leased calls' completions reach the head in batches; here each batch
    is held 0.6 s where the head reads it, as on a loaded host. A listing
    right after the caller's get holds every call it got back: the head
    waits for the workers the caller named. It waited 0.25 s for any
    worker and then answered without them."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.util.state import list_tasks

    @ray_tpu_torch.remote
    def g(x):
        return x

    ray_tpu_torch.get([g.remote(i) for i in range(2)], timeout=60)
    time.sleep(1.0)
    ray_tpu_torch.get([g.remote(i) for i in range(2)], timeout=60)
    before = len([t for t in list_tasks() if t["name"] == "g"])
    # The head shares this process: the rule delays its reads only.
    chaos.install("task_done_batch=delay:1:600000:600000")
    try:
        assert ray_tpu_torch.get([g.remote(i) for i in range(4)], timeout=60) == list(range(4))
        listed = len([t for t in list_tasks() if t["name"] == "g"])
    finally:
        chaos.install("")
    assert listed == before + 4, (before, listed)


def test_serves_pollers_end_with_the_session_they_began_in():
    """A Serve handle's long-poll and metrics threads, left running by a
    runtime shut down without `serve.shutdown()`, submitted a controller
    call every 0.5 s into whatever session this process started next
    (nine submits in the GPU local-lease case's window). They end with
    their session, and a handle made in the next session gets a router of
    its own."""
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=2)
    try:
        serve.start(proxy=False)

        @serve.deployment
        def double(x):
            return x * 2

        handle = serve.run(double.bind(), name="poller_app", route_prefix=None)
        assert handle.remote(21).result(timeout_s=30) == 42
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        before = _head_submits()
        time.sleep(3.0)
        assert _head_submits() - before == 0
        serve.start(proxy=False)
        handle = serve.run(double.bind(), name="poller_app", route_prefix=None)
        assert handle.remote(4).result(timeout_s=30) == 8
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()


# Loaded by the first head of `test_an_inline_put_the_head_never_persisted_survives_a_head_failover`
# (and by nothing after it): no put reaches a persist tick.
_UNPERSISTED_PUTS_SITECUSTOMIZE = """
import os

_flag = os.environ.get("RTPT_TEST_UNPERSISTED_PUTS_FLAG")
if _flag and not os.path.exists(_flag):
    open(_flag, "w").close()
    from ray_tpu_torch._private import gcs as _gcs

    _put_ids = set()
    _put, _snapshot = _gcs.GcsServer._h_put_object, _gcs.GcsServer._snapshot_table

    def _h_put_object(self, state, msg):
        _put_ids.add(msg["object_id"])
        return _put(self, state, msg)

    def _snapshot_table(self, table):
        snap = _snapshot(self, table)
        if table == "objects":
            snap = {oid: e for oid, e in snap.items() if oid not in _put_ids}
        return snap

    _gcs.GcsServer._h_put_object = _h_put_object
    _gcs.GcsServer._snapshot_table = _snapshot_table
"""


@ray_tpu_torch.remote
def _total(x):
    return float(np.sum(x))


def test_an_inline_put_the_head_never_persisted_survives_a_head_failover(tmp_path):
    """A driver with no node pool of its own puts a small value: the head
    holds its only copy. The head is killed before a persist tick records
    it; after the failover a task on it runs, and a get returns it. The
    reconcile re-claimed it without bytes, and the task pinning it waited
    at the new head forever (the partition soak's traffic wedge)."""
    from ray_tpu_torch.cluster_utils import DaemonCluster, SupervisedHead, _pinned_pythonpath

    inject = tmp_path / "inject"
    inject.mkdir()
    (inject / "sitecustomize.py").write_text(_UNPERSISTED_PUTS_SITECUSTOMIZE)
    flag = tmp_path / "first-head"
    head = SupervisedHead(session_dir=str(tmp_path / "sess"), env={
        "RAY_TPU_TORCH_head_recovery_grace_s": "5",
        "RTPT_TEST_UNPERSISTED_PUTS_FLAG": str(flag),
        "PYTHONPATH": os.pathsep.join([str(inject), _pinned_pythonpath()]),
    })
    cluster = None
    try:
        ray_tpu_torch.init(address=head.address)
        cluster = DaemonCluster.attach(head.tcp_address, head.authkey)
        cluster.add_node(num_cpus=2)
        assert ray_tpu_torch.get(_total.remote(np.ones(4)), timeout=60) == 4.0
        value = np.arange(1000, dtype=np.float64)  # 8 KB: inline, through the head only
        ref = ray_tpu_torch.put(value)
        assert flag.exists()  # the first head ran with its puts unpersisted
        time.sleep(1.0)  # persist ticks pass; none records the put
        head.kill()
        assert head.wait_restarted(1, timeout=60), "head never came back"
        deadline = time.monotonic() + 30
        while True:
            try:
                ray_tpu_torch.cluster_resources()
                break
            except Exception:  # noqa: BLE001 - mid-reconnect
                assert time.monotonic() < deadline, "the driver never reconnected"
                time.sleep(0.5)
        assert ray_tpu_torch.get(_total.remote(ref), timeout=30) == float(value.sum())
        np.testing.assert_array_equal(ray_tpu_torch.get(ref, timeout=30), value)
    finally:
        if cluster is not None:
            for p in list(cluster._daemons):
                try:
                    cluster.kill_node(p)
                except Exception:  # noqa: BLE001
                    pass
        try:
            ray_tpu_torch.shutdown()
        except Exception:  # noqa: BLE001
            pass
        head.stop()


class _PortProbes:
    """A `socket` module whose sockets all report one port as theirs."""

    def __init__(self, port):
        import socket

        class Probe(socket.socket):
            def getsockname(self):
                return ("127.0.0.1", port)

        self.socket = Probe


def test_a_supervised_heads_first_start_binds_a_port_no_one_holds(monkeypatch):
    """A supervised head's port was picked by binding and closing a probe
    socket, and bound later by the head's own process: on a busy host
    another process took it in between, and the head died at startup with
    `Address already in use` (it failed this file's inline-put failover
    case once on a loaded host). The head now binds a port of the
    kernel's choice and the supervisor reads it back. Here every probe
    reports a port this test holds."""
    import socket
    import tempfile

    from ray_tpu_torch import cluster_utils

    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        taken = held.getsockname()[1]
        monkeypatch.setattr(cluster_utils, "socket", _PortProbes(taken), raising=False)
        with tempfile.TemporaryDirectory() as d:
            head = cluster_utils.SupervisedHead(session_dir=os.path.join(d, "sess"))
            try:
                assert head.port not in (0, taken), head.port
                ray_tpu_torch.init(address=head.address)
                assert ray_tpu_torch.cluster_resources().get("CPU", 0.0) == 0.0
            finally:
                try:
                    ray_tpu_torch.shutdown()
                finally:
                    head.stop()
