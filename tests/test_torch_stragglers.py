"""The port's straggler tolerance: the health scorer's quarantine and
readmission, and the hedging rules: tests/test_stragglers.py, case for
case, on the port's runtime. Every test has a deadline after which it
fails instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Gray-failure tolerance: health-scorer hysteresis, hedged execution
adjudication, and quarantine scheduling semantics.

Policy-level checks borrow the scorer / hedge methods off GcsServer
without starting one (the test_scheduling_policy harness idiom), so
every state machine transition is asserted deterministically; one small
live-cluster test pins the end-to-end property that a quarantined node
takes no new leases and drains back into service on readmission. The
full under-chaos behaviour (slowexec + throttle, PULL_RELEAD, head-kill
composition) lives in ray_perf's straggler_soak / make straggler-smoke.
"""
import os
import signal
import threading
import time
from collections import deque

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.gcs import (
    GcsServer,
    NodeState,
    WorkerHandle,
    W_ACTOR,
    W_BUSY,
    W_IDLE,
    stale_node_ids,
)
from ray_tpu_torch._private.ids import ActorID, NodeID, TaskID, WorkerID
from ray_tpu_torch._private.task_spec import TaskSpec

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


@pytest.fixture(autouse=True)
def _default_config():
    # Harness tests read thresholds straight off RayConfig; make sure a
    # previous test's _system_config isn't still loaded.
    RayConfig.initialize()
    yield


# ----------------------------------------------------------- construction
def _mk_node(i, cpus=4.0):
    n = NodeState(
        node_id=NodeID(bytes([i]) * 16),
        total={"CPU": cpus},
        available={"CPU": cpus},
        conn=object(),  # only daemon nodes (with a control conn) score
    )
    n.last_heartbeat = time.monotonic()
    n.prev_heartbeat = n.last_heartbeat - 0.1
    return n


class _FakeConn:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


def _mk_spec(name="unit", **kw):
    defaults = dict(
        task_id=TaskID(os.urandom(16)),
        name=name,
        function_id=b"\x00" * 16,
        function_blob=None,
        args_blob=b"",
        resources={"CPU": 1.0},
    )
    defaults.update(kw)
    return TaskSpec(**defaults)


def _mk_worker(node, state=W_IDLE):
    return WorkerHandle(
        worker_id=WorkerID(os.urandom(16)),
        node_id=node.node_id,
        state=state,
        conn=_FakeConn(),
    )


# ------------------------------------------------------- scorer hysteresis
class _ScorerHarness:
    """Borrows the health scorer off GcsServer without starting one."""

    _score_nodes = GcsServer._score_nodes

    def __init__(self):
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self.nodes = {}
        self._quarantine_stats = {"quarantined": 0, "readmitted": 0}

    def _update_straggler_metrics(self):
        pass

    def add(self, node):
        self.nodes[node.node_id.binary()] = node
        return node

    def sweep(self, node, *bad):
        """One scoring sweep with the given bad signals set on `node`.

        Refreshes the heartbeat first so the only degradation measured
        is what the test injects (a stale monotonic heartbeat is itself
        a bad signal)."""
        node.last_heartbeat = time.monotonic()
        node.prev_heartbeat = node.last_heartbeat - 0.1
        for attr, val in bad:
            setattr(node, attr, val)
        self._score_nodes(1.0)


def test_single_slow_sweep_never_quarantines():
    h = _ScorerHarness()
    n = h.add(_mk_node(1))
    h.sweep(n, ("hb_gap_max", 100.0))
    # One blip: EWMA moves to 1 - alpha/2, nowhere near any threshold.
    assert n.health_score == pytest.approx(0.875)
    assert not n.suspect and not n.quarantined
    for _ in range(30):
        h.sweep(n)
    assert n.health_score > 0.99
    assert not n.quarantined
    assert h._quarantine_stats["quarantined"] == 0


def test_sustained_degradation_suspects_then_quarantines():
    h = _ScorerHarness()
    n = h.add(_mk_node(1))
    # Two signals per sweep (jitter + pull re-leads) -> sample 0.0:
    # 1.0 -> .75 -> .5625 (suspect) -> .4219 -> .3164 (quarantine).
    for i in range(1, 5):
        h.sweep(n, ("hb_gap_max", 100.0), ("releads", 1))
        if i < 4:
            assert not n.quarantined, f"quarantined too early (sweep {i})"
    assert n.suspect
    assert n.quarantined
    assert n.health_score < RayConfig.health_quarantine_score
    assert h._quarantine_stats["quarantined"] == 1
    # Staying degraded doesn't re-count the transition.
    h.sweep(n, ("hb_gap_max", 100.0), ("releads", 1))
    assert h._quarantine_stats["quarantined"] == 1


def test_readmission_needs_consecutive_healthy_windows():
    h = _ScorerHarness()
    n = h.add(_mk_node(1))
    n.quarantined = True
    n.health_score = 0.9
    h.sweep(n)
    h.sweep(n)
    assert n.quarantined and n.healthy_windows == 2
    # One relapse resets the consecutive-window counter.
    h.sweep(n, ("hb_gap_max", 100.0))
    assert n.quarantined and n.healthy_windows == 0
    h.sweep(n)
    h.sweep(n)
    assert n.quarantined  # only 2 consecutive so far
    h.sweep(n)
    assert not n.quarantined and not n.suspect
    assert h._quarantine_stats["readmitted"] == 1


def test_quarantined_silent_node_still_fences():
    # Quarantine is probation, NOT the fence path: a quarantined node
    # that goes truly silent must still reach the heartbeat-timeout
    # sweep (the PR 13 incarnation fence).
    n = _mk_node(3)
    n.quarantined = True
    n.last_heartbeat = 100.0
    assert stale_node_ids(
        [n], now_mono=160.0, period_s=1.0, threshold=5
    ) == [n.node_id.binary()]


def test_connless_nodes_never_scored():
    # The head's own node and virtual/driver nodes have no heartbeat
    # stream; whatever garbage sits in their counters must not decay
    # their score.
    h = _ScorerHarness()
    n = h.add(_mk_node(1))
    n.conn = None
    h.sweep(n, ("hb_gap_max", 100.0), ("releads", 5))
    assert n.health_score == 1.0 and not n.suspect


# --------------------------------------------------------- hedge launcher
class _HedgeHarness:
    """Borrows the hedge launcher + adjudicator off GcsServer."""

    _launch_hedges = GcsServer._launch_hedges
    _dispatch_hedge = GcsServer._dispatch_hedge
    _hedge_adjudicate = GcsServer._hedge_adjudicate
    _hedge_drop_reporter = GcsServer._hedge_drop_reporter
    _task_resources = GcsServer._task_resources
    _release_task_resources = GcsServer._release_task_resources
    _node_util = GcsServer._node_util
    _pick_worker = GcsServer._pick_worker
    _packable = staticmethod(GcsServer._packable)

    def __init__(self):
        self._lock = threading.RLock()
        self.nodes = {}
        self.workers = {}
        self.placement_groups = {}
        self._hedges = {}
        self._hedge_stats = {"launched": 0, "won": 0, "cancelled": 0}
        self._exec_durations = {}

    def overrunning_primary(self, spec, node):
        w = _mk_worker(node, state=W_BUSY)
        w.current_task = spec
        w.task_started_at = time.time() - 60.0
        node.available["CPU"] -= spec.resources.get("CPU", 0)
        self.workers[w.worker_id.binary()] = w
        self._exec_durations.setdefault(spec.name, deque([0.05] * 16))
        return w

    def idle_twin(self, node):
        w = _mk_worker(node, state=W_IDLE)
        node.pool.add(w.worker_id.binary())
        self.workers[w.worker_id.binary()] = w
        return w


def _two_node_harness(suspect_primary=True):
    h = _HedgeHarness()
    na, nb = _mk_node(1), _mk_node(2)
    na.suspect = suspect_primary
    h.nodes = {na.node_id.binary(): na, nb.node_id.binary(): nb}
    return h, na, nb


def test_overrun_on_suspect_node_hedges_to_healthy_node():
    h, na, nb = _two_node_harness()
    spec = _mk_spec()
    primary = h.overrunning_primary(spec, na)
    twin = h.idle_twin(nb)
    h._launch_hedges()
    assert h._hedge_stats["launched"] == 1
    assert twin.state == W_BUSY and twin.current_task is spec
    [msg] = twin.conn.sent
    assert msg["type"] == "execute_task" and msg["hedge_seq"] == 1
    assert nb.available["CPU"] == 3.0  # duplicate lease charged
    hedge = h._hedges[spec.task_id.binary()]
    assert hedge["seqs"] == {
        primary.worker_id.binary(): None,  # pre-hedge dispatch: no echo
        twin.worker_id.binary(): 1,
    }
    assert na.overruns == 1  # scorer signal recorded too


@pytest.mark.parametrize(
    "kw",
    [
        {"actor_id": ActorID(b"\x07" * 16)},
        {"actor_creation": True},
        {"num_returns": -1},
        {"scheduling_strategy": "SPREAD"},
    ],
)
def test_pinned_and_actor_tasks_never_hedge(kw):
    h, na, nb = _two_node_harness()
    spec = _mk_spec(**kw)
    h.overrunning_primary(spec, na)
    h.idle_twin(nb)
    h._launch_hedges()
    assert not h._hedges and h._hedge_stats["launched"] == 0
    # Skipped before the overrun bump: an actor running long is not a
    # gray-failure signal (its state can't be duplicated anyway).
    assert na.overruns == 0


def test_overrun_on_healthy_node_signals_but_never_dispatches():
    h, na, nb = _two_node_harness(suspect_primary=False)
    h.overrunning_primary(_mk_spec(), na)
    h.idle_twin(nb)
    h._launch_hedges()
    assert na.overruns == 1  # bootstrap: this is how slowness surfaces
    assert not h._hedges and h._hedge_stats["launched"] == 0
    assert nb.available["CPU"] == 4.0


def test_hedge_needs_recorded_percentiles():
    h, na, nb = _two_node_harness()
    spec = _mk_spec()
    h.overrunning_primary(spec, na)
    h.idle_twin(nb)
    h._exec_durations[spec.name] = deque([0.05] * 4)  # < hedge_min_samples
    h._launch_hedges()
    assert not h._hedges and na.overruns == 0


def test_hedges_never_spawn_cold_workers():
    h, na, nb = _two_node_harness()
    h.overrunning_primary(_mk_spec(), na)  # nb has NO idle worker
    h._launch_hedges()
    assert not h._hedges
    assert nb.available["CPU"] == 4.0  # no lease charged on failure


# ----------------------------------------------------------- adjudication
def _hedged_pair(h=None):
    h = h or _HedgeHarness()
    na, nb = _mk_node(1), _mk_node(2)
    h.nodes = {na.node_id.binary(): na, nb.node_id.binary(): nb}
    spec = _mk_spec()
    primary, twin = _mk_worker(na, W_BUSY), _mk_worker(nb, W_BUSY)
    for w, node in ((primary, na), (twin, nb)):
        w.current_task = spec
        node.available["CPU"] -= 1.0
        h.workers[w.worker_id.binary()] = w
    tid = spec.task_id.binary()
    h._hedges[tid] = {
        "seqs": {primary.worker_id.binary(): None,
                 twin.worker_id.binary(): 1},
        "winner": None,
        "pending": {primary.worker_id.binary(), twin.worker_id.binary()},
    }
    return h, tid, primary, twin, na, nb


def test_first_done_wins_loser_lease_comes_home():
    h, tid, primary, twin, na, nb = _hedged_pair()
    won = h._hedge_adjudicate(tid, primary.worker_id.binary(), primary, {})
    assert won
    # Winner chosen -> the still-running twin is told to cancel.
    assert {"type": "cancel_task", "task_id": tid} in twin.conn.sent
    lost = h._hedge_adjudicate(
        tid, twin.worker_id.binary(), twin, {"hedge_seq": 1}
    )
    assert not lost
    # Exactly one side's record seals; the loser's lease is returned
    # exactly once and its worker goes back to the pool.
    assert twin.state == W_IDLE and twin.current_task is None
    assert nb.available["CPU"] == 4.0
    assert na.available["CPU"] == 3.0  # winner's lease: normal done path
    assert h._hedge_stats == {"launched": 0, "won": 1, "cancelled": 1}
    assert na.hedges_won == 1 and nb.hedges_lost == 1
    assert tid not in h._hedges  # both twins reported: entry dropped


def test_twin_beats_slow_primary():
    h, tid, primary, twin, na, nb = _hedged_pair()
    assert h._hedge_adjudicate(
        tid, twin.worker_id.binary(), twin, {"hedge_seq": 1}
    )
    assert {"type": "cancel_task", "task_id": tid} in primary.conn.sent
    assert not h._hedge_adjudicate(
        tid, primary.worker_id.binary(), primary, {}
    )
    assert primary.state == W_IDLE
    assert na.available["CPU"] == 4.0 and nb.available["CPU"] == 3.0


def test_stale_echo_fences_even_when_first_to_arrive():
    h, tid, primary, twin, na, nb = _hedged_pair()
    # A done from a worker the head never granted this task to (e.g. a
    # fenced former incarnation) can never seal, even with no winner yet.
    ghost = os.urandom(16)
    assert not h._hedge_adjudicate(tid, ghost, None, {"hedge_seq": 1})
    assert h._hedges[tid]["winner"] is None
    # A known twin echoing the wrong seq fences the same way.
    assert not h._hedge_adjudicate(
        tid, twin.worker_id.binary(), twin, {"hedge_seq": 7}
    )
    assert h._hedges[tid]["winner"] is None
    # The authentic record still wins afterwards.
    assert h._hedge_adjudicate(tid, primary.worker_id.binary(), primary, {})


def test_losing_actor_host_restores_to_actor_state():
    # A hedge twin placed on a shared actor host must hand the process
    # back to its actors, not to the fungible pool.
    h, tid, primary, twin, na, nb = _hedged_pair()
    twin.packed[b"\x07" * 16] = _mk_spec(actor_creation=True)
    h._hedge_adjudicate(tid, primary.worker_id.binary(), primary, {})
    assert not h._hedge_adjudicate(
        tid, twin.worker_id.binary(), twin, {"hedge_seq": 1}
    )
    assert twin.state == W_ACTOR
    assert nb.available["CPU"] == 4.0


def test_drop_reporter_holds_entry_until_all_twins_report():
    h, tid, primary, twin, na, nb = _hedged_pair()
    h._hedge_drop_reporter(tid, primary.worker_id.binary())
    assert tid in h._hedges  # twin still owes a report (or a death)
    h._hedge_drop_reporter(tid, twin.worker_id.binary())
    assert tid not in h._hedges


# ------------------------------------------------------------ live cluster
def test_quarantined_node_takes_no_new_leases():
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        cluster.add_node(num_cpus=2, label="b")
        from ray_tpu_torch._private.worker import _global

        gcs = _global.node.gcs
        with gcs._lock:
            b = next(
                n for n in gcs.nodes.values() if n.label == "b"
            )
            b.quarantined = True
            # Score 0.0 keeps the live scorer from readmitting it for
            # ~10 sweeps — far longer than the observation window.
            b.health_score = 0.0

        @ray_tpu_torch.remote(num_cpus=1)
        def busy():
            time.sleep(0.8)
            return 1

        refs = [busy.remote() for _ in range(4)]
        # While the first wave runs on the head, b must stay fully idle.
        deadline = time.time() + 0.9
        while time.time() < deadline:
            with gcs._lock:
                assert b.available.get("CPU") == b.total.get("CPU")
            time.sleep(0.05)
        # list_cluster_nodes surface carries the straggler columns.
        row = next(
            r for r in ray_tpu_torch.nodes() if r.get("label") == "b"
        )
        assert row["quarantined"] is True
        assert row["health_score"] == pytest.approx(0.0)
        assert {"hedges_won", "hedges_lost"} <= set(row)
        # Readmit: the parked half of the wave drains onto b.
        with gcs._lock:
            b.quarantined = False
            b.health_score = 1.0
            gcs._work.notify_all()
        assert ray_tpu_torch.get(refs, timeout=30) == [1, 1, 1, 1]
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
