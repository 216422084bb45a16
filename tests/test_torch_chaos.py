"""The port's chaos engine and resilience primitives: tests/test_chaos.py,
case for case, on the port's `_private/chaos.py`: the seeded
`FaultSchedule`, `install`, `kill_point` and `InOrderSequencer`, the
shared `Backoff`/`retry_call`, the ref_flush and task_done batchers'
at-least-once delivery, partitions, the storage fault points, and the
spill, OOM-victim and done-batcher cases that reach into the port's
`gcs`, `object_store` and `worker_main`. Every test has a deadline after
which it fails instead of hanging, and every `get` a timeout.

The reference's docstring: chaos engine + resilience primitives.

Reference model: python/ray/tests/test_chaos.py (resource killers over
nodes/workers) + RAY_testing_asio_delay_us (ray_config_def.h:832),
generalized here into the seeded FaultSchedule (_private/chaos.py)
woven into the transport boundary and named process kill points, plus
the shared Backoff/retry and in-order ref_flush sequencing the
hardened failure paths ride.
"""
import gc
import os
import random
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.chaos import (
    Backoff,
    FaultSchedule,
    InOrderSequencer,
    retry_call,
)

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


class _Holder:
    """Stands in for a PeerConn as the reorder hold slot."""


# ------------------------------------------------------------ determinism


def _decision_trace(schedule: FaultSchedule, mtype: str, n: int):
    return [schedule.decide(mtype) for _ in range(n)]


def test_same_seed_same_injection_sequence():
    """Acceptance: every fault rule is deterministic under a fixed
    seed — the nth decision for a message type is a pure function of
    (seed, rule, n)."""
    spec = "ref_flush=drop:0.3,pull_chunk=delay:0.5:1000:9000,x=dup:0.2"
    a = _decision_trace(FaultSchedule(spec, seed=42), "ref_flush", 200)
    b = _decision_trace(FaultSchedule(spec, seed=42), "ref_flush", 200)
    assert a == b
    assert any(d is not None for d in a)  # p=0.3 over 200 draws fires
    c = _decision_trace(FaultSchedule(spec, seed=43), "ref_flush", 200)
    assert a != c  # a different seed is a different schedule
    # Delay magnitudes are part of the deterministic stream too.
    d1 = _decision_trace(FaultSchedule(spec, seed=7), "pull_chunk", 50)
    d2 = _decision_trace(FaultSchedule(spec, seed=7), "pull_chunk", 50)
    assert d1 == d2


def test_rule_limit_and_unknown_types():
    s = FaultSchedule("a=drop:1.0@2", seed=1)
    assert [s.decide("a") is not None for _ in range(4)] == [
        True, True, False, False,
    ]
    assert s.decide("never-mentioned") is None
    with pytest.raises(ValueError):
        FaultSchedule("a=explode:1.0", seed=1)


def test_intercept_actions():
    s = FaultSchedule(
        "d=drop:1.0,u=dup:1.0,r=reorder:1.0@1,n=delay:1.0:1:1", seed=5
    )
    h = _Holder()
    assert s.intercept(h, "d", {"type": "d"}) == []
    assert s.intercept(h, "u", {"type": "u"}) == [
        {"type": "u"}, {"type": "u"},
    ]
    # Reorder: held until the NEXT message on the conn, then delivered
    # right after it (a one-slot swap).
    assert s.intercept(h, "r", {"type": "r", "i": 1}) == []
    out = s.intercept(h, "x", {"type": "x"})
    assert out == [{"type": "x"}, {"type": "r", "i": 1}]
    # A close drains anything still held — never a silent drop.
    assert s.intercept(h, "r", {"type": "r", "i": 2}) == [
        {"type": "r", "i": 2}
    ]  # @1 limit: second reorder rule application doesn't fire
    s2 = FaultSchedule("r=reorder:1.0", seed=5)
    h2 = _Holder()
    assert s2.intercept(h2, "r", {"i": 1}) == []
    assert s2.drain_held(h2) == [{"i": 1}]
    assert s2.drain_held(h2) == []


def test_kill_rule_fires_on_nth_hit(monkeypatch):
    s = FaultSchedule("kill:owner.pre_ref_flush=3", seed=9)
    killed = []
    monkeypatch.setattr(
        FaultSchedule, "_kill", lambda self: killed.append(True)
    )
    for _ in range(5):
        s.maybe_kill("owner.pre_ref_flush")
    assert len(killed) == 1  # exactly the 3rd hit
    s.maybe_kill("some.other.point")
    assert len(killed) == 1


def test_role_scoped_rules(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_CHAOS_ROLE", "raylet")
    s = FaultSchedule("a=drop:1.0?role=worker,b=drop:1.0?role=raylet",
                      seed=2)
    assert s.decide("a") is None  # scoped to workers; we are a raylet
    assert s.decide("b") is not None


def test_legacy_delay_spec_translation():
    s = FaultSchedule("", seed=0,
                      legacy_delay_spec="put_object=5000:5000")
    d = s.decide("put_object")
    assert d is not None and d[0] == "delay"
    assert abs(d[1] - 0.005) < 1e-9


# --------------------------------------------------------------- backoff


def test_backoff_growth_jitter_and_budget():
    bo = Backoff(base_s=0.1, cap_s=1.0, rng=random.Random(3))
    delays = [bo.next_delay() for _ in range(20)]
    assert all(d <= 1.0 for d in delays)
    assert all(d >= 0.025 for d in delays)  # base/4 floor
    # Deterministic under a seeded rng.
    bo2 = Backoff(base_s=0.1, cap_s=1.0, rng=random.Random(3))
    assert delays == [bo2.next_delay() for _ in range(20)]
    # Budget bounds total sleep.
    bo3 = Backoff(base_s=10.0, cap_s=10.0, budget_s=0.01,
                  rng=random.Random(1))
    assert bo3.next_delay() <= 0.01
    assert bo3.exhausted()
    bo3.reset()
    assert not bo3.exhausted()


def test_retry_call_retries_then_raises():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    bo = Backoff(base_s=0.001, cap_s=0.002, rng=random.Random(0))
    assert retry_call(flaky, backoff=bo) == "ok"
    assert len(calls) == 3

    def always():
        raise OSError("nope")

    with pytest.raises(OSError):
        retry_call(
            always,
            backoff=Backoff(base_s=0.001, cap_s=0.002, budget_s=0.01),
        )


# -------------------------------------------------------------- sequencer


def test_sequencer_orders_dedups_and_skips_gaps():
    sq = InOrderSequencer(gap_timeout_s=10.0)
    assert sq.offer(1, "a", now=0.0) == ["a"]
    assert sq.offer(3, "c", now=0.0) == []          # gap: buffered
    assert sq.offer(2, "b", now=0.0) == ["b", "c"]  # fills in order
    assert sq.offer(2, "b", now=0.0) == []          # duplicate
    assert sq.duplicates == 1
    # A gap that never fills is skipped after the timeout — flushed in
    # order, counted.
    assert sq.offer(6, "f", now=1.0) == []
    assert sq.offer(7, "g", now=20.0) == ["f", "g"]
    assert sq.skipped_gaps == 1
    assert sq.offer(8, "h", now=21.0) == ["h"]


def test_sequencer_baseline_is_first_seen():
    sq = InOrderSequencer()
    # Without start_seq (mid-stream attach): first seq seen is the
    # baseline, not 1.
    assert sq.offer(40, "x") == ["x"]
    assert sq.offer(41, "y") == ["y"]


def test_sequencer_start_seq_accepts_retransmitted_first_batch():
    """Regression: the FIRST batch dropped in transit must read as a
    gap awaiting its retransmit — with a first-seen baseline the later
    seq=1 retransmit would be discarded as a 'duplicate' (and its
    edges silently lost, despite having been acked)."""
    sq = InOrderSequencer(gap_timeout_s=10.0, start_seq=1)
    assert sq.offer(2, "b", now=0.0) == []   # seq 1 was dropped: gap
    assert sq.offer(1, "a", now=1.0) == ["a", "b"]  # retransmit lands
    assert sq.duplicates == 0


# ------------------------------------------------- ref_flush at-least-once


class _FakeConn:
    closed = False

    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


class _FakeClient:
    def __init__(self):
        from ray_tpu_torch._private.ids import WorkerID

        self.worker_id = WorkerID.from_random()
        self.conn = _FakeConn()
        self._lineage = {}

    def _wait_prune(self, oids):
        pass


def test_ref_flush_carries_seq_and_retransmits_until_acked():
    from ray_tpu_torch._private.object_plane import owner_refs
    from ray_tpu_torch._private.object_plane.owner_refs import OwnerRefTracker

    c = _FakeClient()
    t = OwnerRefTracker(c)
    oid = b"owned111"
    t.incr(oid, c.worker_id.binary())
    t.mark_advertised(oid)
    t.decr(oid)
    t.flush(c)
    (msg,) = c.conn.sent
    assert msg["seq"] == 1 and msg["release"] == [oid]
    # Unacked: ages past RETRANSMIT_S -> the next flush resends the
    # SAME batch (same seq — the head sequencer dedups).
    with t._lock:
        t._unacked[1][1] -= owner_refs.RETRANSMIT_S + 1
    t.flush(c)
    assert len(c.conn.sent) == 2 and c.conn.sent[1]["seq"] == 1
    assert t.stats["retransmits"] == 1
    # Ack clears it: no further resends.
    t.ack(1)
    with t._lock:
        assert not t._unacked
    t.flush(c)
    assert len(c.conn.sent) == 2
    t.stop()


def test_ref_flush_lost_batch_counted_after_max_attempts():
    from ray_tpu_torch._private.object_plane import owner_refs
    from ray_tpu_torch._private.object_plane.owner_refs import OwnerRefTracker

    c = _FakeClient()
    t = OwnerRefTracker(c)
    t.incr(b"borrowed", b"o" * 16)
    t.flush(c)
    with t._lock:
        t._unacked[1][2] = owner_refs.RETRANSMIT_MAX  # attempts spent
        t._unacked[1][1] -= owner_refs.RETRANSMIT_S + 1
    t.flush(c)
    with t._lock:
        assert not t._unacked
    assert t.stats["lost_batches"] == 1
    t.stop()


def test_done_batcher_retransmits_and_renumbers_on_reconnect():
    """Head failover, worker half: task_done batches are at-least-once
    (seq + ack + retransmit), and a reconnect renumbers the unacked
    tail from 1 — the restarted head's per-conn sequencer starts over,
    so the old numbering would read as a permanent gap."""
    from ray_tpu_torch._private.worker_main import _DoneBatcher

    class _Client:
        def __init__(self):
            from ray_tpu_torch._private.ids import WorkerID

            self.worker_id = WorkerID.from_random()
            self.conn = _FakeConn()
            self.sent = []
            self.done_ack = None
            self._conn_gen = 0

        def send(self, msg):
            self.sent.append(msg)

        def conn_failover_pending(self):
            return True

    c = _Client()
    b = _DoneBatcher(c)
    b._thread = object()  # keep the background flush loop out of this test
    assert c.done_ack == b.ack  # ack push wired at construction

    def _batches():
        return [m for m in c.sent if m.get("items")]

    b.add({"task_id": b"t1", "name": "x", "results": [], "error": None})
    b.flush()
    assert [m["seq"] for m in _batches()] == [1]
    # Unacked past the retransmit age: the next flush resends the SAME
    # batch (same seq — the head sequencer dedups), WITHOUT the
    # flight-recorder piggyback (no double ingest).
    with b._lock:
        b._unacked[1][1] -= _DoneBatcher._RETRANSMIT_S + 1
        assert "events" not in b._unacked[1][0]
    b.flush()
    assert [m["seq"] for m in _batches()] == [1, 1]
    # Second batch, first acked: a reconnect renumbers the unacked
    # tail from 1 (order preserved) and retransmits immediately.
    b.add({"task_id": b"t2", "name": "y", "results": [], "error": None})
    b.flush()
    b.ack(1)
    c.sent = []
    c._conn_gen = 1  # the client swapped to a fresh connection
    b.on_reconnect()
    resent = _batches()
    assert [m["seq"] for m in resent] == [1]
    assert resent[0]["items"][0]["task_id"] == b"t2"
    b.ack(1)
    with b._lock:
        assert not b._unacked


def test_owner_tracker_reconnect_renumbers_and_readvertises():
    """Head failover, owner half: on_reconnect renumbers unacked
    ref_flush batches, re-dirties borrowed/fallback refs so their
    edges re-send, and returns the owned-object reconcile payload
    (oid -> live borrowers) for the recovery window."""
    from ray_tpu_torch._private.object_plane.owner_refs import OwnerRefTracker

    c = _FakeClient()
    t = OwnerRefTracker(c)
    me = c.worker_id.binary()
    owned, borrowed, other = b"o" * 16, b"b" * 16, b"x" * 16
    t.incr(owned, me)
    t.mark_advertised(owned)
    t.apply_borrow_update(b"peer1", [owned], None)  # live borrow edge
    t.incr(borrowed, other)
    t.flush(c)  # advertises `borrowed` via badd, seq 1 (never acked)
    assert [m["seq"] for m in c.conn.sent] == [1]

    c._conn_gen = 1  # the client swapped to a fresh connection
    recon = t.on_reconnect()
    assert recon == {owned: [b"peer1"]}
    with t._lock:
        assert list(t._unacked) == [1]
        assert t._unacked[1][1] == 0.0  # due immediately
        assert borrowed in t._dirty  # re-advertises on next flush
    c.conn.sent = []
    t.flush(c)
    # New batch carries the re-advertised borrow edge; the renumbered
    # unacked batch retransmits alongside it.
    new = [m for m in c.conn.sent if (other, borrowed) in m.get("badd", [])]
    assert new, f"borrow edge not re-advertised: {c.conn.sent}"
    assert any(m["seq"] == 1 for m in c.conn.sent if m is not new[0])
    t.stop()


def test_dead_borrower_late_add_ignored():
    """borrower_died sweep racing a delayed/reordered head→owner relay:
    the late add must not resurrect a borrow edge nothing will ever
    retract."""
    from ray_tpu_torch._private.object_plane.owner_refs import OwnerRefTracker

    c = _FakeClient()
    t = OwnerRefTracker(c)
    oid = b"owned111"
    t.incr(oid, c.worker_id.binary())
    t.mark_advertised(oid)
    t.sweep_borrower(b"b" * 16)
    t.apply_borrow_update(b"b" * 16, [oid], [])  # the late relay
    assert t.stats["stale_borrow_adds"] == 1
    t.decr(oid)
    t.flush(c)
    # The release still goes out — the stale edge held nothing.
    assert any(m.get("release") == [oid] for m in c.conn.sent)
    t.stop()


# ----------------------------------------------------------- end to end


def test_chaos_delay_rule_via_system_config():
    """The chaos engine subsumes testing_rpc_delay_us: a delay rule on
    put_object visibly stretches the put round-trip. Pool disabled:
    the shm segment's put advert is async by design and never blocks,
    so the rule is only observable on the legacy synchronous path."""
    os.environ["RAY_TPU_TORCH_NATIVE_STORE"] = "0"
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "chaos_spec": "put_object=delay:1.0:30000:30000",
            "chaos_seed": 11,
        },
    )
    try:
        start = time.monotonic()
        ray_tpu_torch.get(ray_tpu_torch.put(1), timeout=GET_TIMEOUT_S)
        assert time.monotonic() - start >= 0.03
        assert chaos.active() is not None
        assert chaos.active().stats.get("delay:put_object", 0) >= 1
    finally:
        ray_tpu_torch.shutdown()
        chaos.install("", 0)
        os.environ.pop("RAY_TPU_TORCH_NATIVE_STORE", None)


def test_dropped_ref_flush_batches_still_release(monkeypatch):
    """At-least-once flush end to end: with the first TWO ref_flush
    deliveries deterministically dropped at the head's transport
    boundary, retransmission still lands the release and the entry
    frees — and the injected faults surface as CHAOS events."""
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={
            "chaos_spec": "ref_flush=drop:1.0@2",
            "chaos_seed": 21,
        },
    )
    try:
        from ray_tpu_torch._private.worker import _global, global_client

        import numpy as np

        client = global_client()
        ref = ray_tpu_torch.put(np.zeros(300_000))
        oid = ref.id().binary()
        client._tracker.flush(client)
        del ref
        gc.collect()
        client._tracker.flush(client)
        gcs = _global.node.gcs
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if gcs.objects.get(oid) is None:
                break
            time.sleep(0.1)
        assert gcs.objects.get(oid) is None, (
            "release lost to dropped ref_flush batches",
            client._tracker.stats,
        )
        from ray_tpu_torch.util.state import list_cluster_events

        drops = list_cluster_events(category="chaos", event="DROP",
                                    limit=10)
        assert drops, "injected drops not visible as CHAOS events"
    finally:
        ray_tpu_torch.shutdown()
        chaos.install("", 0)


def test_oom_victim_ordering_groups_by_owner():
    """The kill ladder's group-by-owner fairness tier — the
    job with the burst pays, not the job with one task; retriability
    and newest-first break ties inside the group."""
    from types import SimpleNamespace

    from ray_tpu_torch._private.gcs import W_BUSY, W_LEASED, sort_oom_victims

    def w(owner, started, retries=1, state=W_BUSY):
        return SimpleNamespace(
            state=state,
            task_started_at=started,
            current_task=SimpleNamespace(
                max_retries=retries, owner_client=owner, name="t",
            ),
        )

    job_a = b"a" * 16
    job_b = b"b" * 16
    burst = [w(job_a, 10.0), w(job_a, 20.0), w(job_a, 30.0)]
    single = [w(job_b, 40.0)]
    order = sort_oom_victims(single + burst)
    # All of job A's burst dies before job B's single task is touched.
    assert [getattr(v.current_task, "owner_client") for v in order[:3]] \
        == [job_a] * 3
    assert order[0].task_started_at == 30.0  # newest in the big group
    assert order[-1].current_task.owner_client == job_b
    # Within one group, retriable ranks before non-retriable.
    mixed = [w(job_a, 10.0, retries=0), w(job_a, 5.0, retries=2)]
    order2 = sort_oom_victims(mixed)
    assert order2[0].current_task.max_retries == 2
    # Leased workers (no visible task) rank between the two.
    leased = SimpleNamespace(
        state=W_LEASED, task_started_at=50.0, current_task=None
    )
    order3 = sort_oom_victims(
        [w(job_a, 1.0, retries=0), leased]
    )
    assert order3[0].state == W_LEASED


# ------------------------------------------------------------ partitions


def test_partition_rule_grammar():
    """partition:<roleA><-><roleB>=<start>[:<heal_after>][?dir=...] —
    pair split, heal term as start+delta, and dir validation."""
    s = FaultSchedule("partition:raylet<->head=2:5?dir=a2b", seed=0)
    (rule,) = s._partition_rules
    assert (rule.role_a, rule.role_b) == ("raylet", "head")
    assert rule.start_s == 2.0
    assert rule.heal_s == 7.0  # heal_after is RELATIVE to start
    assert rule.direction == "a2b"
    # No heal term: the cut is permanent.
    s2 = FaultSchedule("partition:worker<->head=0", seed=0)
    assert s2._partition_rules[0].heal_s is None
    with pytest.raises(ValueError):
        FaultSchedule("partition:raylet=1", seed=0)  # no '<->' pair
    with pytest.raises(ValueError):
        FaultSchedule("partition:a<->b=1?dir=sideways", seed=0)


def test_partition_blocks_windows_and_direction(monkeypatch):
    """Windows are pure functions of the shared epoch env — no
    per-message RNG — so every process in the fleet agrees on when the
    cut begins and heals."""
    # Anchor the epoch 10s in the past: "now" inside the schedule ≈ 10.
    monkeypatch.setenv("RAY_TPU_TORCH_chaos_epoch", str(time.time() - 10.0))
    # Active window (start 5, heal 5+100): both directions cut.
    s = FaultSchedule("partition:raylet<->head=5:100", seed=0)
    assert s.partition_blocks("raylet", "head")
    assert s.partition_blocks("head", "raylet")
    assert not s.partition_blocks("worker", "head")  # uncovered pair
    assert s.stats.get("partition:0:partition:raylet<->head=5:100") == 2
    # Not yet started (start 60): no block.
    pre = FaultSchedule("partition:raylet<->head=60", seed=0)
    assert not pre.partition_blocks("raylet", "head")
    # Already healed (start 1, heal 1+2=3 < now=10): no block, and the
    # heal edge only fires if the cut was ever observed to begin.
    healed = FaultSchedule("partition:raylet<->head=1:2", seed=0)
    assert not healed.partition_blocks("raylet", "head")
    assert "partition_heal:0:partition:raylet<->head=1:2" not in healed.stats
    # Asymmetric: a2b cuts raylet→head only; replies still flow.
    a2b = FaultSchedule("partition:raylet<->head=0?dir=a2b", seed=0)
    assert a2b.partition_blocks("raylet", "head")
    assert not a2b.partition_blocks("head", "raylet")
    b2a = FaultSchedule("partition:raylet<->head=0?dir=b2a", seed=0)
    assert not b2a.partition_blocks("raylet", "head")
    assert b2a.partition_blocks("head", "raylet")


def test_partition_begin_heal_edges_recorded(monkeypatch):
    """Transition edges surface exactly one PARTITION_BEGIN and one
    PARTITION_HEAL flight-recorder event each (plus stats), however
    many messages the window swallows."""
    from ray_tpu_torch._private import events as _events

    monkeypatch.setenv("RAY_TPU_TORCH_chaos_epoch", str(time.time() - 10.0))
    s = FaultSchedule("partition:raylet<->head=5:3", seed=0)
    rec = _events.get_recorder()
    rec.drain()
    # Force the rule through its begin edge before the heal: observe
    # the active window first by rewinding the epoch-relative clock.
    s._epoch = time.time() - 6.0  # now=6 ∈ [5, 8): active
    assert s.partition_blocks("raylet", "head")
    assert s.partition_blocks("raylet", "head")  # no second begin edge
    s._epoch = time.time() - 20.0  # now=20 ≥ 8: healed
    assert not s.partition_blocks("raylet", "head")
    assert not s.partition_blocks("raylet", "head")  # no second heal edge
    items, _ = rec.drain()
    names = [i[4] for i in items if i[2] == _events.CHAOS]
    assert names.count("PARTITION_BEGIN") == 1
    assert names.count("PARTITION_HEAL") == 1
    assert s.stats.get("partition_heal:0:partition:raylet<->head=5:3") == 1


def test_partition_blocks_module_hook(monkeypatch):
    """chaos.partition_blocks consults the installed schedule; with
    chaos off it never blocks."""
    monkeypatch.setenv("RAY_TPU_TORCH_chaos_epoch", str(time.time() - 10.0))
    monkeypatch.setenv("RAY_TPU_TORCH_CHAOS_ROLE", "raylet")
    chaos.install("partition:raylet<->head=0", seed=1)
    try:
        assert chaos.partition_blocks("raylet", "head")
        assert chaos.partition_blocks("head", "raylet")
        assert not chaos.partition_blocks("driver", "head")
    finally:
        chaos.install("", 0)
    assert not chaos.partition_blocks("raylet", "head")


# ------------------------------------------------- storage fault points


def test_fault_point_rules_parse_and_fire_deterministically():
    """Storage-plane fault rules (io_error:/disk_full:/truncate:) share
    the kill-rule grammar — nth-hit and probabilistic — and the same
    seeded determinism."""
    s = FaultSchedule("io_error:spill_write=2", seed=5)
    assert [s.maybe_fault("io_error:spill_write") for _ in range(4)] == [
        False, True, False, False,
    ]
    assert not s.maybe_fault("disk_full:spill")  # no rule installed
    p1 = FaultSchedule("truncate:spill_file=p:0.4", seed=11)
    p2 = FaultSchedule("truncate:spill_file=p:0.4", seed=11)
    t1 = [p1.maybe_fault("truncate:spill_file") for _ in range(100)]
    t2 = [p2.maybe_fault("truncate:spill_file") for _ in range(100)]
    assert t1 == t2 and any(t1) and not all(t1)
    p3 = FaultSchedule("truncate:spill_file=p:0.4", seed=12)
    assert t1 != [p3.maybe_fault("truncate:spill_file") for _ in range(100)]


def test_fault_point_module_hook_and_chaos_event():
    """chaos.fault_point consults the installed schedule and records a
    CHAOS FAULT flight-recorder event per injection."""
    from ray_tpu_torch._private import events as _events

    chaos.install("disk_full:spill=1", seed=3)
    try:
        rec = _events.get_recorder()
        rec.drain()
        assert chaos.fault_point("disk_full:spill") is True
        assert chaos.fault_point("disk_full:spill") is False  # nth=1 only
        assert chaos.fault_point("io_error:spill_write") is False
        items, _ = rec.drain()
        faults = [i for i in items if i[2] == _events.CHAOS
                  and i[4] == "FAULT"]
        assert len(faults) == 1 and faults[0][3] == "disk_full:spill"
    finally:
        chaos.install("", 0)
    # chaos off: one global read, never fires.
    assert chaos.fault_point("disk_full:spill") is False


def test_spill_write_fault_points_injected(tmp_path, monkeypatch):
    """write_spill_file honors all three storage fault points: EIO,
    ENOSPC, and a post-rename truncation that read_spill_file detects
    — garbage can never restore."""
    import errno

    import numpy as np

    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import (
        SpillCorruptionError, read_spill_file, write_spill_file,
    )

    oid = ObjectID(b"s" * 16)
    payload = np.arange(1024, dtype=np.int64).tobytes()

    chaos.install("io_error:spill_write=1", seed=1)
    with pytest.raises(OSError) as ei:
        write_spill_file(str(tmp_path), oid, payload)
    assert ei.value.errno == errno.EIO

    chaos.install("disk_full:spill=1", seed=1)
    with pytest.raises(OSError) as ei:
        write_spill_file(str(tmp_path), oid, payload)
    assert ei.value.errno == errno.ENOSPC

    chaos.install("truncate:spill_file=1", seed=1)
    path = write_spill_file(str(tmp_path), oid, payload)
    with pytest.raises(SpillCorruptionError):
        read_spill_file(path)

    chaos.install("", 0)
    path = write_spill_file(str(tmp_path), oid, payload)
    assert read_spill_file(path) == payload
