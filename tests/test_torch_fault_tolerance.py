"""The port's fault tolerance: tests/test_fault_tolerance.py, case for
case, on the port's runtime: task retry on a crash, actor restart and
its budget, incarnation fencing, a stale object advert, a zombie node,
and RPC delay injection. Every test has a deadline after which it fails
instead of hanging, and every `get` a timeout.

The reference's live head-failover case
(`test_actors_survive_live_head_failover`) has its port mirror in
tests/test_torch_cluster_tooling.py
(`test_actors_survive_live_head_failover_under_supervised_head`), and is
not repeated here.

The reference's docstring: task retries + actor restarts + chaos.

Reference semantics: max_retries re-submits on system failure
(task_manager.h:468); retry_exceptions opts app errors into retries;
max_restarts drives the GCS actor restart state machine
(gcs_actor_manager.h:278, actor_states.rst). Chaos model:
python/ray/tests/test_chaos.py.
"""
import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import temp_root
from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError

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
def ray_start():
    """A fresh local cluster of 4 CPUs per test (the reference's
    conftest `ray_start`)."""
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _shm_of(pid):
    """The `/dev/shm/rtpt_*` files process `pid` has mapped: a node
    daemon's pool and segments."""
    try:
        with open(f"/proc/{pid}/maps", encoding="utf-8") as f:
            return {line.split()[-1] for line in f
                    if line.rstrip().split()[-1].startswith("/dev/shm/rtpt_")}
    except OSError:
        return set()


@pytest.fixture
def daemon_shm(monkeypatch):
    """A node daemon SIGKILLed by `DaemonCluster.kill_node` leaves its
    shm pool behind: note what it had mapped before the kill, and unlink
    what is left of that after the test (only that daemon's files, so a
    test running beside this one keeps its own)."""
    from ray_tpu_torch.cluster_utils import DaemonCluster

    left = set()
    kill_node = DaemonCluster.kill_node

    def noting_kill_node(self, proc, graceful=False):
        left.update(_shm_of(proc.pid))
        return kill_node(self, proc, graceful)

    monkeypatch.setattr(DaemonCluster, "kill_node", noting_kill_node)
    yield left
    for path in left:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


def test_task_retry_on_crash(ray_start):
    marker = os.path.join(temp_root(), f"retry_{os.getpid()}")
    if os.path.exists(marker):
        os.unlink(marker)

    @ray_tpu_torch.remote(max_retries=2)
    def flaky(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)  # crash on first attempt
        return "recovered"

    assert ray_tpu_torch.get(flaky.remote(marker), timeout=60) == "recovered"
    os.unlink(marker)


def test_task_no_retry_by_default(ray_start):
    @ray_tpu_torch.remote
    def die():
        os._exit(1)

    with pytest.raises(WorkerCrashedError):
        ray_tpu_torch.get(die.remote(), timeout=30)


def test_app_error_retry_with_retry_exceptions(ray_start):
    marker = os.path.join(temp_root(), f"appretry_{os.getpid()}")
    if os.path.exists(marker):
        os.unlink(marker)

    @ray_tpu_torch.remote(max_retries=3, retry_exceptions=True)
    def flaky(path):
        if not os.path.exists(path):
            open(path, "w").close()
            raise RuntimeError("transient")
        return "ok"

    assert ray_tpu_torch.get(flaky.remote(marker), timeout=60) == "ok"
    os.unlink(marker)


def test_app_error_no_retry_without_flag(ray_start):
    @ray_tpu_torch.remote(max_retries=3)
    def always_raises():
        raise RuntimeError("app error")

    with pytest.raises(RuntimeError):
        ray_tpu_torch.get(always_raises.remote(), timeout=30)


def test_actor_restart(ray_start):
    @ray_tpu_torch.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def die(self):
            os._exit(1)

    p = Phoenix.remote()
    assert ray_tpu_torch.get(p.incr.remote(), timeout=GET_TIMEOUT_S) == 1
    p.die.remote()
    # After restart, state resets (fresh __init__) but the handle works.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            assert ray_tpu_torch.get(p.incr.remote(), timeout=10) == 1
            break
        except RayActorError:
            time.sleep(0.2)
    else:
        pytest.fail("actor did not come back after restart")


def test_actor_dies_after_restart_budget(ray_start):
    @ray_tpu_torch.remote(max_restarts=1)
    class Fragile:
        def die(self):
            os._exit(1)

        def ping(self):
            return "pong"

    f = Fragile.remote()
    assert ray_tpu_torch.get(f.ping.remote(), timeout=GET_TIMEOUT_S) == "pong"
    f.die.remote()  # restart 1
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get(f.ping.remote(), timeout=10)
            break
        except RayActorError:
            time.sleep(0.2)
    f.die.remote()  # exceeds budget
    time.sleep(0.5)
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(f.ping.remote(), timeout=10)


# ---------------------------------------- membership fencing


class _FencePeer:
    """Captures what a GCS handler sends/replies to a raylet conn."""

    def __init__(self):
        self.sent = []
        self.replies = []
        self.peer_role = None

    def send(self, msg):
        self.sent.append(msg)

    def reply(self, req_msg, **fields):
        self.replies.append(fields)


def test_monotonic_liveness_survives_wall_clock_jump():
    """The death sweeper diffs time.monotonic() readings —
    never the wall clock — so an NTP step / VM resume between two
    sweeps declares nothing dead."""
    from types import SimpleNamespace

    from ray_tpu_torch._private.gcs import stale_node_ids
    from ray_tpu_torch._private.ids import NodeID

    def node(last_hb, alive=True, conn=object()):
        return SimpleNamespace(
            node_id=NodeID.from_random(), alive=alive, conn=conn,
            last_heartbeat=last_hb,
        )

    now_mono = 1000.0
    fresh = node(now_mono - 1.0)
    quiet = node(now_mono - 60.0)
    # A +2h wall-clock jump happens between heartbeat and sweep. The
    # sweep never sees it: its inputs are monotonic readings only, so
    # the freshly-heartbeating node stays alive.
    assert stale_node_ids([fresh], now_mono, 1.0, 5) == []
    # The genuinely silent node IS declared dead by monotonic delta.
    assert stale_node_ids([quiet], now_mono, 1.0, 5) == [
        quiet.node_id.binary()
    ]
    # Dead / in-process (conn=None) / never-heartbeated nodes are out
    # of scope for the sweeper.
    assert stale_node_ids([node(now_mono - 60, alive=False)],
                          now_mono, 1.0, 5) == []
    assert stale_node_ids([node(now_mono - 60, conn=None)],
                          now_mono, 1.0, 5) == []
    assert stale_node_ids([node(0.0)], now_mono, 1.0, 5) == []


def test_stale_incarnation_heartbeat_fenced(ray_start):
    """A heartbeat carrying the wrong incarnation (or an unknown
    node_id) must not refresh liveness — the head answers with ONE
    fenced push per connection and ignores the beat."""
    from ray_tpu_torch._private.worker import _global

    gcs = _global.node.gcs
    peer = _FencePeer()
    state = {"peer": peer}
    gcs._h_register_node(
        state, {"resources": {"CPU": 1.0}, "label": "fence-unit"}
    )
    reply = peer.replies[-1]
    assert reply["ok"] and reply["incarnation"] >= 1
    nid, inc = reply["node_id"], reply["incarnation"]
    try:
        # Correct incarnation: liveness refreshes, no fence.
        gcs._h_node_heartbeat(state, {"node_id": nid, "incarnation": inc})
        assert peer.sent == []
        hb0 = gcs.nodes[nid].last_heartbeat
        # Stale incarnation: fenced push, liveness NOT refreshed.
        gcs._h_node_heartbeat(
            state, {"node_id": nid, "incarnation": inc + 1}
        )
        assert [m["type"] for m in peer.sent] == ["fenced"]
        assert gcs.nodes[nid].last_heartbeat == hb0
        # Repeat offender on the same conn: no push spam.
        gcs._h_node_heartbeat(
            state, {"node_id": nid, "incarnation": inc + 1}
        )
        assert len(peer.sent) == 1
        # Unknown node_id on a fresh conn: fenced too.
        p2 = _FencePeer()
        gcs._h_node_heartbeat({"peer": p2}, {"node_id": b"\x99" * 16})
        assert p2.sent and p2.sent[0]["type"] == "fenced"
    finally:
        gcs._handle_node_death(nid, "fence-unit cleanup")


def test_fenced_node_id_cannot_reregister(ray_start):
    """Declare-dead arms the fence: the dead node_id is rejected at
    re-registration (the zombie must rejoin as a fresh identity), and
    the fresh join is granted a strictly higher incarnation."""
    from ray_tpu_torch._private.worker import _global

    gcs = _global.node.gcs
    peer = _FencePeer()
    gcs._h_register_node(
        {"peer": peer}, {"resources": {"CPU": 1.0}, "label": "zombie"}
    )
    nid, inc = peer.replies[-1]["node_id"], peer.replies[-1]["incarnation"]
    gcs._handle_node_death(nid, "declared dead by test")
    # The zombie replays its registration with the fenced node_id.
    p2 = _FencePeer()
    gcs._h_register_node(
        {"peer": p2}, {"node_id": nid, "resources": {"CPU": 1.0}}
    )
    assert p2.replies[-1] == {"ok": False, "fenced": True}
    assert nid not in gcs.nodes or not gcs.nodes[nid].alive
    # The normal join path (no node_id) succeeds — new identity, higher
    # incarnation than anything the dead node ever held.
    p3 = _FencePeer()
    gcs._h_register_node({"peer": p3}, {"resources": {"CPU": 1.0}})
    fresh = p3.replies[-1]
    try:
        assert fresh["ok"] and fresh["node_id"] != nid
        assert fresh["incarnation"] > inc
    finally:
        gcs._handle_node_death(fresh["node_id"], "fence-unit cleanup")


def test_stale_object_advert_rejected_after_free(ray_start):
    """A zombie's put_object advert landing AFTER its death was
    processed (objects freed) must not resurrect the freed id as a
    ghost READY entry."""
    from ray_tpu_torch._private.gcs import W_DEAD, WorkerHandle
    from ray_tpu_torch._private.ids import WorkerID
    from ray_tpu_torch._private.worker import _global

    gcs = _global.node.gcs
    wid = WorkerID.from_random().binary()
    with gcs._lock:
        gcs.workers[wid] = WorkerHandle(
            worker_id=WorkerID(wid),
            node_id=gcs.head_node.node_id,
            state=W_DEAD,
        )
    oid = b"\xa5" * 16
    peer = _FencePeer()
    msg = {"type": "put_object", "object_id": oid, "inline": b"zombie",
           "size": 6, "req_id": 1}
    try:
        gcs._h_put_object({"peer": peer, "client_id": wid}, msg)
        assert peer.replies == [{"ok": False, "fenced": True}]
        assert oid not in gcs.objects, "freed id resurrected by zombie"
        # Same advert from a live (ownerless) path still lands.
        gcs._h_put_object({"peer": peer, "client_id": None}, dict(msg))
        assert peer.replies[-1] == {"ok": True}
        assert gcs.objects[oid].inline == b"zombie"
    finally:
        with gcs._lock:
            gcs.objects.pop(oid, None)
            gcs.workers.pop(wid, None)


def test_zombie_node_rejoins_with_new_incarnation(tmp_path, daemon_shm):
    """End to end: a raylet partitioned from the head past the death
    threshold — TCP stays ESTABLISHED, frames blackhole — is declared
    dead (incarnation bumped, node_id fenced). On heal its first
    heartbeat draws a fenced push; it self-fences and rejoins through
    the normal join path as a NEW node_id with a HIGHER incarnation,
    and a restartable actor that lived there answers exactly one
    incarnation's calls (fresh boot token, counter restarted at 1)."""
    import secrets

    from ray_tpu_torch.cluster_utils import DaemonCluster

    ray_tpu_torch.init(
        num_cpus=0,
        tcp_port=0,
        _system_config={
            "health_check_period_ms": 250,
            "health_check_failure_threshold": 4,
        },
    )
    cluster = DaemonCluster.attach()
    try:
        epoch = time.time()
        # Cut both directions of the raylet<->head link from t=+10s,
        # heal 6s later. Installed ONLY in the victim daemon's env: the
        # driver and the head never see the spec (gray failure).
        cluster.add_node(
            num_cpus=2,
            label="victim",
            env={
                "RAY_TPU_TORCH_chaos_spec": "partition:raylet<->head=10:6",
                "RAY_TPU_TORCH_chaos_seed": "7",
                "RAY_TPU_TORCH_chaos_epoch": str(epoch),
                # Beat at the head's sweep cadence: the default 1s
                # period would read as missed beats under the head's
                # tightened 250ms*4 threshold.
                "RAY_TPU_TORCH_health_check_period_ms": "250",
            },
        )
        victim = next(
            n for n in ray_tpu_torch.nodes() if n["label"] == "victim"
        )
        nid0, inc0 = victim["node_id"], victim["incarnation"]

        # num_cpus=1 pins the actor to the victim — the head node has
        # zero CPUs, so nothing else can host it (or its restart).
        @ray_tpu_torch.remote(max_restarts=4, num_cpus=1)
        class Tokened:
            def __init__(self):
                self.token = secrets.token_hex(4)
                self.n = 0

            def bump(self):
                self.n += 1
                return self.token, self.n

        a = Tokened.remote()
        tok_a, n1 = ray_tpu_torch.get(a.bump.remote(), timeout=60)
        assert n1 == 1

        # Phase 1: the partition outlasts the death threshold — the
        # victim disappears from the live membership view.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes()
                     if n["alive"] and n["node_id"] == nid0]
            if not alive:
                break
            time.sleep(0.25)
        else:
            pytest.fail("partitioned node never declared dead")

        # Phase 2: heal -> fenced heartbeat -> self-fence -> rejoin as
        # a fresh identity with a strictly higher incarnation.
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            back = [
                n for n in ray_tpu_torch.nodes()
                if n["alive"] and n["label"] == "victim"
                and n["node_id"] != nid0
                and n["incarnation"] > inc0
            ]
            if back:
                break
            time.sleep(0.25)
        else:
            pytest.fail("zombie never rejoined as a new incarnation")

        # Phase 3: the actor answers exactly one incarnation's calls —
        # a fresh boot token, counter restarted, strictly increasing,
        # never interleaved with the old token.
        deadline = time.monotonic() + 90
        tok_b = None
        while time.monotonic() < deadline:
            try:
                tok_b, m1 = ray_tpu_torch.get(a.bump.remote(), timeout=15)
                break
            except Exception:  # noqa: BLE001 - mid-restart
                time.sleep(0.5)
        assert tok_b is not None, "actor never answered after rejoin"
        assert tok_b != tok_a, "old incarnation answered after fencing"
        assert m1 == 1, "restarted actor kept stale state"
        for expect in (2, 3):
            tok, m = ray_tpu_torch.get(a.bump.remote(), timeout=30)
            assert (tok, m) == (tok_b, expect)
    finally:
        for p in list(cluster._daemons):
            try:
                cluster.kill_node(p)
            except Exception:  # noqa: BLE001
                pass
        ray_tpu_torch.shutdown()


def test_rpc_delay_injection():
    # Reference: RAY_testing_asio_delay_us (ray_config_def.h:832).
    # Pool disabled: a same-host put through the shm segment advertises
    # asynchronously and never blocks on put_object, so the delay rule
    # is only observable on the legacy synchronous path.
    os.environ["RAY_TPU_TORCH_NATIVE_STORE"] = "0"
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={"testing_rpc_delay_us": "put_object=30000:30000"},
    )
    try:
        start = time.monotonic()
        ray_tpu_torch.get(ray_tpu_torch.put(1), timeout=GET_TIMEOUT_S)
        assert time.monotonic() - start >= 0.03
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TORCH_NATIVE_STORE", None)
