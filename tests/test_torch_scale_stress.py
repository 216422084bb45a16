"""The port's scale stress: many virtual nodes, deep task queues and actor
fans: tests/test_scale_stress.py, case for case, on the port's runtime.
Every test has a deadline after which it fails instead of hanging, and
every `get` and `wait` a timeout.

The reference's docstring:

Scale-envelope stress: many nodes / many actors / deep task queues.

Reference envelope: release/benchmarks/README.md:9-31 — 2,000 nodes,
1M queued tasks, 10k+ concurrent actors/tasks (many_nodes 588 tasks/s,
many_actors 604 actors/s). This host has one core, so the CI-budget
versions here run at reduced-but-representative scale and assert
correctness under load; ray_perf --only scale records the throughput
numbers into PERF.json at full stress scale.

What each test is designed to crack:
- virtual-node churn: the head's node table, scheduler scan, and PG
  2PC accounting at 120+ nodes
- deep queues: the pending-task queue's dequeue path at 20k backlog
  (an O(queue) rescan per grant would time out here)
- actor fan: actor state machine + worker pool under dozens of
  concurrent creations, then a broadcast call storm
"""
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)

DEADLINE_S = 180
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
def head():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_many_virtual_nodes_register_and_list(head):
    cluster = Cluster(initialize_head=False)
    t0 = time.monotonic()
    for i in range(120):
        cluster.add_node(num_cpus=4, label=f"n{i}")
    dt = time.monotonic() - t0
    nodes = ray_tpu_torch.nodes()
    assert len(nodes) >= 121  # head + 120
    # Registration must stay sub-linear-ish: > 30/s even on this host.
    assert dt < 4.0, f"120 node registrations took {dt:.1f}s"


def test_1k_nodes_deep_queue_stays_responsive(head):
    """The head envelope at reference shape (release/benchmarks/
    README.md: 2k nodes / 1M queued): 1,000 registered nodes must not
    slow the dispatch path. Nodes carry capacity no {CPU: 1} task can
    use, so every queued task scans past them — the per-scheduling-
    class pending queues make that one probe per class per pass
    (gcs._PendingQueue), not one per task."""
    cluster = Cluster(initialize_head=False)
    t0 = time.monotonic()
    for i in range(1000):
        cluster.add_node(resources={"CPU": 0.001}, label=f"v{i}")
    reg_dt = time.monotonic() - t0
    assert len(ray_tpu_torch.nodes()) >= 1001
    assert reg_dt < 30.0, f"1k registrations took {reg_dt:.1f}s"

    @ray_tpu_torch.remote(num_cpus=1)
    def unit(i):
        return i

    n = 10_000
    t0 = time.monotonic()
    refs = [unit.remote(i) for i in range(n)]
    out = ray_tpu_torch.get(refs, timeout=600)
    rate = n / (time.monotonic() - t0)
    assert len(out) == n and out[-1] == n - 1
    # Must stay in the same envelope as the 120-node drain (was ~6k/s
    # before per-class queues O(queue x nodes) would collapse this).
    assert rate > 300, f"drained at {rate:.0f}/s with 1k nodes registered"


def test_class_queues_stay_fair_under_saturation(head):
    """Two resource classes contending for the same saturated CPUs:
    the per-class pending queues rotate (gcs._schedule_once
    move_to_end), so neither class starves while the other streams
    (the old global FIFO's arrival-order property, class-granular)."""
    @ray_tpu_torch.remote(num_cpus=1)
    def big(i):
        time.sleep(0.01)
        return ("big", i)

    @ray_tpu_torch.remote(num_cpus=0.5)
    def small(i):
        time.sleep(0.01)
        return ("small", i)

    # Saturate 2 CPUs with 80 queued tasks across two classes and watch
    # completion order: the first finishers must include BOTH classes
    # (a starved class would finish strictly after the other drained).
    done_kinds = []
    pending = [big.remote(i) for i in range(40)] + [
        small.remote(i) for i in range(40)
    ]
    while pending and len(done_kinds) < 40:
        ready, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=120)
        done_kinds.extend(kind for kind, _ in ray_tpu_torch.get(ready, timeout=GET_TIMEOUT_S))
    assert {"big", "small"} <= set(done_kinds), (
        f"one class starved: first finishers {done_kinds[:10]}"
    )


def test_pg_churn_across_many_nodes(head):
    """PG create/remove across a wide cluster: bundle reservation is a
    per-node 2PC against the resource ledger; churn must not leak."""
    cluster = Cluster(initialize_head=False)
    for i in range(100):
        cluster.add_node(num_cpus=2, label=f"n{i}")
    before = ray_tpu_torch.available_resources()
    for round_ in range(5):
        pgs = [
            placement_group([{"CPU": 1}] * 4, strategy="SPREAD")
            for _ in range(25)
        ]
        for pg in pgs:
            assert pg.wait(timeout_seconds=30)
        for pg in pgs:
            remove_placement_group(pg)
    # Every bundle released: the ledger returns to its starting state.
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if ray_tpu_torch.available_resources() == before:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources() == before


def test_deep_task_queue_drains(head):
    """20k tasks against 2 CPU slots: the backlog must drain without
    the dequeue path collapsing (reference: many_tasks queues 1M)."""

    @ray_tpu_torch.remote(num_cpus=1)
    def unit(i):
        return i

    n = 20_000
    t0 = time.monotonic()
    refs = [unit.remote(i) for i in range(n)]
    t_submit = time.monotonic() - t0
    out = ray_tpu_torch.get(refs, timeout=600)
    t_total = time.monotonic() - t0
    assert out[0] == 0 and out[-1] == n - 1 and len(out) == n
    rate = n / t_total
    # Well over the reference's 588/s envelope even while queued deep.
    assert rate > 300, f"drained at {rate:.0f}/s (submit {t_submit:.1f}s)"


def test_many_actor_fan(head):
    """Dozens of concurrent actor creations + a call storm: the actor
    state machine, worker pool, and direct transport under fan-out."""

    @ray_tpu_torch.remote(num_cpus=0.01)
    class Cell:
        def __init__(self, i):
            self.i = i
            self.calls = 0

        def bump(self):
            self.calls += 1
            return (self.i, self.calls)

    n_actors = 100
    t0 = time.monotonic()
    actors = [Cell.remote(i) for i in range(n_actors)]
    ray_tpu_torch.get([a.bump.remote() for a in actors], timeout=300)
    create_rate = n_actors / (time.monotonic() - t0)
    # Zygote fork-spawn keeps creation out of interpreter-cold-start
    # territory even on one core (was 1.6/s before the fork server).
    assert create_rate > 3, f"actor creation at {create_rate:.1f}/s"
    # 19 more calls each, all in flight together: ~2k concurrent results.
    refs = [a.bump.remote() for _ in range(19) for a in actors]
    out = ray_tpu_torch.get(refs, timeout=300)
    assert len(out) == n_actors * 19
    per = {}
    for i, c in out:
        per[i] = max(per.get(i, 0), c)
    assert all(per[i] == 20 for i in range(n_actors))
    for a in actors:
        ray_tpu_torch.kill(a)


def test_forked_workers_mint_unique_ids(head):
    """Zygote-forked workers MUST re-seed their id generators: two forks
    sharing the parent's prefix+counter would mint colliding task ids
    (ids.py _reseed_after_fork)."""

    @ray_tpu_torch.remote(num_cpus=0.01)
    class G:
        def ids(self, n):
            from ray_tpu_torch._private.ids import fast_unique_bytes

            return [fast_unique_bytes() for _ in range(n)]

    gens = [G.remote() for _ in range(8)]
    batches = ray_tpu_torch.get([g.ids.remote(200) for g in gens], timeout=120)
    all_ids = [i for b in batches for i in b]
    assert len(set(all_ids)) == len(all_ids), "forked workers minted duplicate ids"
    for g in gens:
        ray_tpu_torch.kill(g)


def test_queue_survives_node_removal(head):
    """Queued work bound for a node that dies must not wedge the queue:
    remaining capacity keeps draining (reference: cluster_task_manager
    spillback + lineage)."""
    cluster = Cluster(initialize_head=False)
    node = cluster.add_node(num_cpus=2, label="doomed")

    @ray_tpu_torch.remote(num_cpus=1)
    def unit(i):
        return i

    refs = [unit.remote(i) for i in range(200)]
    time.sleep(0.2)
    cluster.remove_node(node)
    out = ray_tpu_torch.get(refs, timeout=300)
    assert len(out) == 200 and out[99] == 99
