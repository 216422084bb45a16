"""The port's owner-sharded object plane: tests/test_object_plane.py,
case for case, on the port's runtime. Under test are the port's
`_private/object_plane/directory.py` (sharded directory, flush queues),
`owner_refs.py` (the owner's tracker and its borrow edges) and
`pull_manager.py` (pull admission). Every test has a deadline after
which it fails instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring: owner-sharded object plane: tracker edges, sharded directory, and
the no-refcount-work-on-the-dispatch-loop acceptance criterion.

Reference behaviors modeled: reference_count.h (owner-side authority,
borrow edges, flap suppression), ownership_based_object_directory.h
(per-shard lock domains + flush queues).
"""
import gc
import signal
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError
from ray_tpu_torch._private.ids import WorkerID
from ray_tpu_torch._private.object_plane import directory as objdir
from ray_tpu_torch._private.object_plane.directory import ShardedObjectDirectory
from ray_tpu_torch._private.object_plane.owner_refs import OwnerRefTracker
from ray_tpu_torch._private.worker import _global, global_client

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


class _FakeConn:
    closed = False

    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


class _FakeClient:
    def __init__(self, wid=None):
        self.worker_id = wid or WorkerID.from_random()
        self.conn = _FakeConn()
        self._lineage = {}
        self.pruned = []

    def _wait_prune(self, oids):
        self.pruned.extend(oids)


OWNER = b"o" * 16
OTHER = b"b" * 16


# --------------------------------------------------------------- tracker


def test_flap_within_flush_window_sends_nothing():
    """1->0->1 within one flush window: the net state is unchanged, so
    the flush must emit no edge at all (owned, borrowed, or fallback)."""
    c = _FakeClient()
    t = OwnerRefTracker(c)
    self_id = c.worker_id.binary()
    for oid, owner in (
        (b"owned111", self_id), (b"borrowed", OWNER), (b"fallback", b"")
    ):
        t.incr(oid, owner)
        t.decr(oid)
        t.incr(oid, owner)
    t.flush(c)
    # owned: alive + owner-side -> nothing; borrowed/fallback: alive ->
    # one advertisement each, but NO retraction of any kind.
    for msg in c.conn.sent:
        assert not msg.get("release") and not msg.get("bdel"), msg
        assert not msg.get("remove"), msg


def test_drop_within_window_unadvertised_sends_nothing():
    """A ref held and dropped inside one window, never advertised,
    must send NOTHING — a bare retraction would race ahead of the
    still-batched advertisement and free a live object."""
    c = _FakeClient()
    t = OwnerRefTracker(c)
    for oid, owner in (
        (b"owned111", c.worker_id.binary()),
        (b"borrowed", OWNER),
        (b"fallback", b""),
    ):
        t.incr(oid, owner)
        t.decr(oid)
    t.flush(c)
    assert c.conn.sent == []


def test_owned_advertised_drop_sends_release():
    c = _FakeClient()
    t = OwnerRefTracker(c)
    oid = b"owned111"
    t.incr(oid, c.worker_id.binary())
    t.mark_advertised(oid)
    t.decr(oid)
    t.flush(c)
    (msg,) = c.conn.sent
    assert msg["type"] == "ref_flush"
    assert msg["release"] == [oid]
    # The release is an edge, not a level: flushing again sends nothing.
    c.conn.sent.clear()
    t.flush(c)
    assert c.conn.sent == []


def test_borrow_holds_release_until_borrowers_drain():
    c = _FakeClient()
    t = OwnerRefTracker(c)
    oid = b"owned111"
    t.incr(oid, c.worker_id.binary())
    t.mark_advertised(oid)
    t.apply_borrow_update(OTHER, [oid], [])
    t.decr(oid)
    t.flush(c)
    assert c.conn.sent == []  # borrower alive: no release
    t.apply_borrow_update(OTHER, [], [oid])
    t.flush(c)
    (msg,) = c.conn.sent
    assert msg["release"] == [oid]


def test_borrower_death_sweep_releases():
    c = _FakeClient()
    t = OwnerRefTracker(c)
    oid = b"owned111"
    t.incr(oid, c.worker_id.binary())
    t.mark_advertised(oid)
    t.apply_borrow_update(OTHER, [oid], [])
    t.decr(oid)
    t.flush(c)
    assert c.conn.sent == []
    t.sweep_borrower(OTHER)
    t.flush(c)
    assert c.conn.sent and c.conn.sent[0]["release"] == [oid]


def test_borrowed_refs_route_to_owner():
    """Borrowed instances send badd/bdel grouped with their owner —
    never a head holder add — and bdel only after its badd."""
    c = _FakeClient()
    t = OwnerRefTracker(c)
    oid = b"borrowed"
    t.incr(oid, OWNER)
    t.flush(c)
    (msg,) = c.conn.sent
    assert msg["badd"] == [(OWNER, oid)]
    assert "add" not in msg
    c.conn.sent.clear()
    t.decr(oid)
    t.flush(c)
    (msg,) = c.conn.sent
    assert msg["bdel"] == [(OWNER, oid)]


# ------------------------------------------------------------- directory


class _Entry:
    def __init__(self):
        self.status = "READY"
        self.waiters = []
        self.task_pins = 0
        self.child_pins = 0
        self.holders = set()
        self.had_holder = False
        self.owner = None
        self.owner_released = False


def test_sharded_directory_facade_and_apply():
    freed = []
    d = ShardedObjectDirectory(
        _Entry, num_shards=4, free_callback=freed.extend
    )
    oids = [bytes([i]) * 8 for i in range(32)]
    for oid in oids:
        e = d.setdefault(oid, _Entry())
        e.owner = OWNER
    assert len(d) == 32
    assert sorted(d.keys()) == sorted(oids)
    assert d.get(oids[0]) is d[oids[0]]
    # Ops spread across shards and apply off-thread.
    d.enqueue([("release", oid, OWNER) for oid in oids])
    assert d.flush(timeout=5)
    deadline = time.time() + 5
    while len(freed) < 32 and time.time() < deadline:
        time.sleep(0.01)
    assert sorted(freed) == sorted(oids)
    for oid in oids:
        assert d.get(oid).owner_released
    d.stop()


def test_directory_early_drop_ledger_sharded():
    d = ShardedObjectDirectory(_Entry, num_shards=4)
    oid = b"notyet11"
    d.enqueue([("release", oid, OWNER)])
    assert d.flush(timeout=5)
    assert d.take_early_drop(oid)
    assert not d.take_early_drop(oid)  # consumed
    # Bounded: overflow evicts oldest, never grows without limit.
    many = [i.to_bytes(8, "little") for i in range(objdir.EARLY_DROP_CAP * 8)]
    d.enqueue([("release", o, OWNER) for o in many])
    assert d.flush(timeout=30)
    per_shard = [len(s.early_drops) for s in d._shards]
    assert all(n <= objdir.EARLY_DROP_CAP for n in per_shard)
    d.stop()


def test_remove_before_add_suppressed_on_sharded_path():
    """A legacy remove for an entry the directory never saw lands in
    the early-drop ledger, not as a free of someone else's object."""
    d = ShardedObjectDirectory(_Entry, num_shards=2)
    freed = []
    d.free_callback = freed.extend
    e = d.setdefault(b"live1111", _Entry())
    e.owner = None
    e.had_holder = True
    e.holders.add(OTHER)
    d.enqueue([("remove", b"ghost111", OWNER)])
    assert d.flush(timeout=5)
    assert freed == []
    assert d.take_early_drop(b"ghost111")
    d.stop()


# ----------------------------------------------------- cluster behaviors


@pytest.fixture
def ray2():
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _flush_refs():
    client = global_client()
    client._tracker.flush(client)


def test_no_refcount_mutation_on_dispatch_loop():
    """Acceptance criterion: with the dispatch threads instrumented, a
    put/task/get/drop workload performs ZERO per-object holder-set
    mutations on the head dispatch loop — everything applies on the
    shard appliers or owner-side."""
    objdir.GUARD = True
    try:
        ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)

        @ray_tpu_torch.remote
        def produce(x):
            return [x] * 1000

        import numpy as np

        refs = [ray_tpu_torch.put(np.zeros(300_000)) for _ in range(8)]
        outs = [produce.remote(i) for i in range(16)]
        assert len(ray_tpu_torch.get(outs, timeout=GET_TIMEOUT_S)) == 16
        for r in refs:
            assert ray_tpu_torch.get(r, timeout=GET_TIMEOUT_S).shape == (300_000,)
        _flush_refs()
        del refs, outs
        gc.collect()
        _flush_refs()
        gcs = _global.node.gcs
        # The releases travel conn -> shard queue -> applier: poll.
        deadline = time.time() + 10
        while time.time() < deadline:
            if gcs.objects.stats["applied_ops"] > 0:
                break
            time.sleep(0.05)
        assert gcs.objects.flush(timeout=10)
        stats = gcs.objects.stats
        assert stats["applied_ops"] > 0  # the plane did real work
        assert stats["dispatch_mutations"] == 0, stats
    finally:
        objdir.GUARD = False
        ray_tpu_torch.shutdown()


def test_owned_object_refcounts_stay_off_the_wire(ray2):
    """Instance churn on owned objects sends nothing: only the final
    release edge reaches the head."""
    import numpy as np

    client = global_client()
    ref = ray_tpu_torch.put(np.zeros(300_000))
    _flush_refs()
    base = dict(client._tracker.stats)
    # Churn: many instance create/drop cycles while the object lives.
    for _ in range(50):
        r2 = ray_tpu_torch.ObjectRef(ref.id(), client.worker_id.binary())
        del r2
    gc.collect()
    _flush_refs()
    after = dict(client._tracker.stats)
    assert after["releases"] == base["releases"]
    assert after["fallback_adds"] == base["fallback_adds"]
    oid = ref.id()
    del ref
    gc.collect()
    _flush_refs()
    after2 = dict(client._tracker.stats)
    assert after2["releases"] == base["releases"] + 1
    gcs = _global.node.gcs
    deadline = time.time() + 5
    while time.time() < deadline:
        if gcs.objects.get(oid.binary()) is None:
            break
        time.sleep(0.05)
    assert gcs.objects.get(oid.binary()) is None


def test_task_retained_borrow_keeps_foreign_object_alive(ray2):
    """An actor that stores a ref nested in its args borrows it: the
    driver dropping its own handle must not free the object (the borrow
    edge relayed to the owner holds it)."""
    import numpy as np

    @ray_tpu_torch.remote
    class Keeper:
        def __init__(self):
            self.ref = None

        def keep(self, refs):
            self.ref = refs[0]  # nested ref: arrives as a ref
            return True

        def read(self):
            return float(ray_tpu_torch.get(self.ref, timeout=GET_TIMEOUT_S).sum())

    k = Keeper.remote()
    arr = np.ones(300_000)
    ref = ray_tpu_torch.put(arr)
    assert ray_tpu_torch.get(k.keep.remote([ref]), timeout=30)
    _flush_refs()
    # Give the worker's borrow flush + head relay a couple windows.
    time.sleep(0.4)
    oid = ref.id()
    del ref
    gc.collect()
    _flush_refs()
    time.sleep(0.5)
    gcs = _global.node.gcs
    assert gcs.objects.get(oid.binary()) is not None, (
        "borrowed object freed while the actor still holds it"
    )
    assert abs(ray_tpu_torch.get(k.read.remote(), timeout=30) - 300_000.0) < 1e-6
    ray_tpu_torch.kill(k)


def test_owner_death_promotes_to_head_fallback():
    """Owner dies -> its entries promote to head-fallback; unborrowed
    ones free, borrowed ones survive on the holder shadow."""
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    try:
        import numpy as np

        @ray_tpu_torch.remote
        class Owner:
            def make(self):
                # The ref is owned by THIS worker process.
                self.ref = ray_tpu_torch.put(np.zeros(300_000))
                return [self.ref]  # nested: returned as a ref

        o = Owner.remote()
        [ref] = ray_tpu_torch.get(o.make.remote(), timeout=30)
        oid = ref.id()
        assert ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S).shape == (300_000,)
        _flush_refs()
        gcs = _global.node.gcs
        entry = gcs.objects.get(oid.binary())
        assert entry is not None and entry.owner is not None
        ray_tpu_torch.kill(o)
        deadline = time.time() + 10
        while time.time() < deadline:
            e = gcs.objects.get(oid.binary())
            if e is not None and e.owner is None:
                break
            time.sleep(0.05)
        e = gcs.objects.get(oid.binary())
        # Promoted (owner None). The driver's borrow shadow may or may
        # not have registered before the owner died; if the entry
        # survived, it must still be readable from the local copy.
        if e is not None:
            assert e.owner is None
        del ref
        gc.collect()
        _flush_refs()
        deadline = time.time() + 10
        while time.time() < deadline:
            if gcs.objects.get(oid.binary()) is None:
                break
            time.sleep(0.05)
    finally:
        ray_tpu_torch.shutdown()


def test_drop_racing_delayed_task_done_reclaims_on_sharded_path():
    """Port of the early-drop-ledger regression to the object plane:
    the owner's release can reach the shard applier BEFORE the leased
    worker's batched task_done creates the entry; the per-shard ledger
    must reclaim the result at seal."""
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "testing_rpc_delay_us": "task_done_batch=150000:150000"
        },
    )
    try:
        @ray_tpu_torch.remote
        def quick():
            return list(range(500))

        ray_tpu_torch.get(quick.remote(), timeout=GET_TIMEOUT_S)  # warm a leased worker
        time.sleep(0.3)  # let the warmup's own ref flush drain
        oids = []
        for _ in range(5):
            ref = quick.remote()
            assert len(ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)) == 500
            oids.append(ref.id().binary())
            del ref
            gc.collect()
            # Flush NOW: the release reaches the shard applier while
            # the worker's task_done_batch is still stalled in the
            # injected 150ms dispatch delay — the ledger must catch it.
            _flush_refs()
        gcs = _global.node.gcs
        deadline = time.time() + 15
        live = oids
        while time.time() < deadline:
            live = [o for o in oids if gcs.objects.get(o) is not None]
            if not live:
                break
            time.sleep(0.2)
        assert not live, (
            f"{len(live)} results leaked past the sharded early-drop ledger"
        )
        assert gcs.objects.stats["early_drops"] > 0
    finally:
        ray_tpu_torch.shutdown()


def test_owner_death_with_unflushed_ref_flush_batch():
    """Owner-death edge (chaos engine, deterministic): the driver's
    badd for an actor-owned object is DROPPED at the head (first two
    ref_flush deliveries), the owner dies before the retransmit lands,
    and the promoted entry must survive on the owner-death grace window
    until the retransmitted borrow edge arrives — then free normally
    once the borrow drops. Without the grace + at-least-once flush the
    head frees a live borrowed object."""
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "chaos_spec": "ref_flush=drop:1.0@2",
            "chaos_seed": 33,
            "owner_death_grace_s": 6.0,
        },
    )
    try:
        import numpy as np

        @ray_tpu_torch.remote
        class Owner:
            def make(self):
                self.ref = ray_tpu_torch.put(np.zeros(300_000))
                return [self.ref]

        o = Owner.remote()
        [ref] = ray_tpu_torch.get(o.make.remote(), timeout=30)
        oid = ref.id()
        _flush_refs()  # the badd batch — dropped at the head
        ray_tpu_torch.kill(o)  # owner dies with the borrow edge un-landed
        gcs = _global.node.gcs
        deadline = time.time() + 10
        while time.time() < deadline:
            e = gcs.objects.get(oid.binary())
            if e is not None and e.owner is None:
                break
            time.sleep(0.05)
        e = gcs.objects.get(oid.binary())
        assert e is not None, (
            "promoted entry freed during the grace window with the "
            "borrow edge still in flight"
        )
        # The retransmitted badd lands within a couple of retransmit
        # periods — well inside the grace window — as a holder shadow.
        deadline = time.time() + 8
        while time.time() < deadline:
            e = gcs.objects.get(oid.binary())
            if e is not None and e.holders:
                break
            time.sleep(0.1)
        assert e is not None and e.holders, "borrow edge never landed"
        # Borrowed data still readable after the owner's death.
        assert ray_tpu_torch.get(ref, timeout=30).shape == (300_000,)
        del ref
        gc.collect()
        _flush_refs()
        deadline = time.time() + 15
        while time.time() < deadline:
            if gcs.objects.get(oid.binary()) is None:
                break
            time.sleep(0.1)
        assert gcs.objects.get(oid.binary()) is None, (
            "promoted entry leaked after its last borrow dropped"
        )
    finally:
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._private import chaos as _chaos

        _chaos.install("", 0)


def test_borrower_dies_during_head_owner_relay():
    """The head→owner borrow relay reordered past the borrower's death
    (chaos reorder rule at the owner's deliver side): the owner must
    ignore the stale add — a borrow edge for a dead process would hold
    the object forever."""
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "chaos_spec": "borrow_update=reorder:1.0@1?role=driver",
            "chaos_seed": 44,
        },
    )
    try:
        import numpy as np

        @ray_tpu_torch.remote
        class Keeper:
            def keep(self, refs):
                self.refs = refs
                return True

        k = Keeper.remote()
        ref = ray_tpu_torch.put(np.ones(300_000))  # driver owns X
        oid = ref.id()
        assert ray_tpu_torch.get(k.keep.remote([ref]), timeout=30)
        # The relay's add for this borrow is held in the reorder slot;
        # killing the borrower makes borrower_died overtake it.
        ray_tpu_torch.kill(k)
        time.sleep(1.0)  # let the sweep + (stale) relay both land
        del ref
        gc.collect()
        _flush_refs()
        gcs = _global.node.gcs
        deadline = time.time() + 15
        while time.time() < deadline:
            if gcs.objects.get(oid.binary()) is None:
                break
            time.sleep(0.1)
        client = global_client()
        assert gcs.objects.get(oid.binary()) is None, (
            "stale borrow edge for a dead borrower held the object",
            client._tracker.stats,
        )
    finally:
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._private import chaos as _chaos

        _chaos.install("", 0)


def test_flap_across_owner_restart(monkeypatch):
    """1→0→1 instance flap on a borrowed ref across its owner's death
    and restart, with the owner killed at a deterministic chaos kill
    point ('between SEAL and REF_FLUSH': right after reporting
    Owner.make done, before its ref flush). The flapped ref must stay
    readable on the promoted entry and free exactly once at the end."""
    # Worker kill points activate from the environment (spawned worker
    # processes read RAY_TPU_TORCH_chaos_* at import).
    monkeypatch.setenv(
        # Actor-method specs are named by bare method name.
        "RAY_TPU_TORCH_chaos_spec", "kill:worker.post_exec.make=1"
    )
    monkeypatch.setenv("RAY_TPU_TORCH_chaos_seed", "55")
    ray_tpu_torch.init(num_cpus=2)
    try:
        import numpy as np

        @ray_tpu_torch.remote(max_restarts=1)
        class Owner:
            def make(self):
                self.ref = ray_tpu_torch.put(np.zeros(300_000))
                return [self.ref]

            def ping(self):
                return "pong"

        o = Owner.remote()
        [ref] = ray_tpu_torch.get(o.make.remote(), timeout=60)
        oid = ref.id()
        owner_b = ref._owner
        gcs = _global.node.gcs
        # The chaos kill point took the owner down right after the
        # reply; wait for promotion (owner=None).
        deadline = time.time() + 20
        while time.time() < deadline:
            e = gcs.objects.get(oid.binary())
            if e is not None and e.owner is None:
                break
            time.sleep(0.1)
        e = gcs.objects.get(oid.binary())
        assert e is not None and e.owner is None, "owner never promoted"
        # Flap 1→0→1 within one flush window across the restart.
        del ref
        ref = ray_tpu_torch.ObjectRef(oid, owner_b)
        gc.collect()
        _flush_refs()
        time.sleep(0.3)
        assert gcs.objects.get(oid.binary()) is not None, (
            "flapped borrow freed a live promoted object"
        )
        assert ray_tpu_torch.get(ref, timeout=30).shape == (300_000,)
        # The actor itself restarted and is usable.
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                assert ray_tpu_torch.get(o.ping.remote(), timeout=10) == "pong"
                break
            except RayActorError:
                time.sleep(0.2)
        else:
            pytest.fail("owner actor did not restart")
        # Final drop frees exactly once.
        del ref
        gc.collect()
        _flush_refs()
        deadline = time.time() + 15
        while time.time() < deadline:
            if gcs.objects.get(oid.binary()) is None:
                break
            time.sleep(0.1)
        assert gcs.objects.get(oid.binary()) is None
    finally:
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._private import chaos as _chaos

        _chaos.install("", 0)


def test_stream_items_freed_after_consumption(ray2):
    """Stream items are OWNERLESS (sealed head-side, no lineage): their
    refs must ride the head-fallback holder path so dropping them frees
    the entries — owned-but-never-advertised classification would leak
    every consumed item."""

    @ray_tpu_torch.remote(num_returns="streaming")
    def gen():
        for i in range(5):
            yield [i] * 2000  # non-inline-trivial payloads

    oids = []
    for r in gen.remote():
        assert len(ray_tpu_torch.get(r, timeout=GET_TIMEOUT_S)) == 2000
        oids.append(r.id().binary())
        del r
    _flush_refs()
    gcs = _global.node.gcs
    deadline = time.time() + 10
    live = oids
    while time.time() < deadline:
        live = [o for o in oids if gcs.objects.get(o) is not None]
        if not live:
            break
        time.sleep(0.2)
    assert not live, f"{len(live)} consumed stream items leaked"


def test_ref_flush_emits_flight_recorder_events(ray2):
    """The plane's edges are visible to `ray_tpu_torch events` —
    refcount flush and shard enqueue/apply land in the aggregator."""
    import numpy as np

    ref = ray_tpu_torch.put(np.zeros(300_000))
    _flush_refs()
    del ref
    gc.collect()
    _flush_refs()
    from ray_tpu_torch.util.state import list_cluster_events

    want = {"REF_FLUSH", "SHARD_ENQUEUE", "SHARD_APPLY"}
    deadline = time.time() + 10
    kinds = set()
    while time.time() < deadline:
        # Query per event name: the global ring survives init/shutdown,
        # so a capped combined listing can be dominated by a previous
        # session's leftovers.
        kinds = {
            k
            for k in want
            if list_cluster_events(category="refs", event=k, limit=10)
        }
        if want <= kinds:
            break
        time.sleep(0.2)
    assert want <= kinds, (kinds, _global.node.gcs.objects.stats)


# ---------------------------------------------------- pull admission
# Reference: pull_manager.h — get > wait > task-args priority classes
# under a bounded in-flight byte budget; completed/failed/cancelled
# pulls release budget and activate the next queued request.


class _BlockingFetcher:
    """Stands in for ObjectFetcher: pulls park on an event so tests
    control exactly when budget releases."""

    def __init__(self):
        self.release = threading.Event()
        self.order = []
        self.fail = set()

    def pull(self, oid, address, timeout=None, resolve=None):
        self.order.append(oid.binary())
        self.release.wait(timeout)
        return oid.binary() not in self.fail


def _mk_oids(n):
    from ray_tpu_torch._private.ids import ObjectID

    return [ObjectID(bytes([i + 1]) * 16) for i in range(n)]


def _pull_in_thread(mgr, oid, size, prio, results, timeout=15):
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    def run():
        results[oid.binary()] = mgr.pull(
            oid, "addr", size=size, priority=prio, timeout=timeout
        )

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_pull_admission_get_beats_queued_task_args():
    """A queued get activates ahead of an earlier-queued task-arg pull
    when budget frees (priority order, FIFO only within a class)."""
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    f = _BlockingFetcher()
    mgr = pm.PullManager(f, budget_bytes=100)
    a, b, c = _mk_oids(3)
    results = {}
    threads = [_pull_in_thread(mgr, a, 100, pm.PULL_GET, results)]
    deadline = time.time() + 5
    while not f.order and time.time() < deadline:
        time.sleep(0.01)
    assert f.order == [a.binary()]
    # task-arg queues FIRST, then a get — each needs the whole budget.
    threads.append(_pull_in_thread(mgr, b, 100, pm.PULL_TASK_ARGS, results))
    time.sleep(0.05)
    threads.append(_pull_in_thread(mgr, c, 100, pm.PULL_GET, results))
    time.sleep(0.05)
    s = mgr.stats()
    assert s["queued_get"] == 1 and s["queued_task_args"] == 1
    assert s["in_flight_bytes"] == 100
    f.release.set()
    for t in threads:
        t.join(10)
    assert f.order[1] == c.binary(), "get did not activate before task-args"
    assert f.order[2] == b.binary()
    assert all(results.values())
    assert mgr.stats()["in_flight_bytes"] == 0


def test_pull_budget_released_on_failure():
    """A failed pull must release its budget share and activate the
    next queued request — a lost object must not brick the plane."""
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    f = _BlockingFetcher()
    mgr = pm.PullManager(f, budget_bytes=100)
    a, b = _mk_oids(2)
    f.fail.add(a.binary())
    results = {}
    t1 = _pull_in_thread(mgr, a, 100, pm.PULL_GET, results)
    time.sleep(0.05)
    t2 = _pull_in_thread(mgr, b, 100, pm.PULL_GET, results)
    time.sleep(0.05)
    assert len(f.order) == 1  # b is queued behind the full budget
    f.release.set()
    t1.join(10)
    t2.join(10)
    assert results[a.binary()] is False
    assert results[b.binary()] is True
    assert mgr.stats()["in_flight_bytes"] == 0


def test_pull_cancel_on_ref_drop_frees_budget():
    """Cancelling a queued pull (ref-drop) removes it from the queue
    without it ever fetching; its budget share never activates."""
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    f = _BlockingFetcher()
    mgr = pm.PullManager(f, budget_bytes=100)
    a, b = _mk_oids(2)
    results = {}
    t1 = _pull_in_thread(mgr, a, 100, pm.PULL_GET, results)
    time.sleep(0.05)
    t2 = _pull_in_thread(mgr, b, 80, pm.PULL_TASK_ARGS, results, timeout=30)
    time.sleep(0.05)
    assert mgr.stats()["queued_task_args"] == 1
    assert mgr.cancel(b.binary()) == 1
    t2.join(5)
    assert results[b.binary()] is False
    assert mgr.stats()["queued_task_args"] == 0
    f.release.set()
    t1.join(10)
    assert f.order == [a.binary()]  # b never fetched
    assert mgr.stats()["in_flight_bytes"] == 0


def test_pull_fifo_within_class_and_oversize_solo():
    """FIFO within one class; an object bigger than the whole budget
    still runs (alone) — liveness over strictness."""
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    f = _BlockingFetcher()
    f.release.set()  # no blocking: drain in admission order
    mgr = pm.PullManager(f, budget_bytes=100)
    big = _mk_oids(1)[0]
    assert mgr.pull(big, "addr", size=10_000, priority=pm.PULL_GET,
                    timeout=5)
    assert f.order == [big.binary()]
    assert mgr.stats()["in_flight_bytes"] == 0

    f2 = _BlockingFetcher()
    mgr2 = pm.PullManager(f2, budget_bytes=100)
    oids = _mk_oids(4)
    results = {}
    threads = [_pull_in_thread(mgr2, oids[0], 100, pm.PULL_GET, results)]
    time.sleep(0.05)
    for o in oids[1:]:
        threads.append(
            _pull_in_thread(mgr2, o, 100, pm.PULL_TASK_ARGS, results)
        )
        time.sleep(0.02)
    f2.release.set()
    for t in threads:
        t.join(10)
    assert f2.order[1:] == [o.binary() for o in oids[1:]], "FIFO violated"


def test_pull_dedup_follower_rides_leader():
    """Concurrent pulls of ONE object cross the wire once: the second
    request follows the active leader without charging budget."""
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    class _Store:
        def contains(self, oid):
            return True

    f = _BlockingFetcher()
    mgr = pm.PullManager(f, store=_Store(), budget_bytes=100)
    (a,) = _mk_oids(1)
    results = {}
    t1 = _pull_in_thread(mgr, a, 100, pm.PULL_GET, results)
    deadline = time.time() + 5
    while not f.order and time.time() < deadline:
        time.sleep(0.01)

    follower_done = []

    def follow():
        follower_done.append(
            mgr.pull(a, "addr", size=100, priority=pm.PULL_GET, timeout=10)
        )

    t2 = threading.Thread(target=follow, daemon=True)
    t2.start()
    time.sleep(0.1)
    assert mgr.stats()["in_flight_bytes"] == 100  # charged once
    f.release.set()
    t1.join(10)
    t2.join(10)
    assert f.order == [a.binary()]  # one wire fetch
    assert follower_done == [True]


def test_pull_task_arg_class_context():
    """The worker runtime scopes arg-resolution pulls to the task-args
    class via the thread-local context."""
    from ray_tpu_torch._private.object_plane import pull_manager as pm

    assert pm.current_pull_class() == pm.PULL_GET
    with pm.pull_class(pm.PULL_TASK_ARGS):
        assert pm.current_pull_class() == pm.PULL_TASK_ARGS
        with pm.pull_class(pm.PULL_WAIT):
            assert pm.current_pull_class() == pm.PULL_WAIT
        assert pm.current_pull_class() == pm.PULL_TASK_ARGS
    assert pm.current_pull_class() == pm.PULL_GET
