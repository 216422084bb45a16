"""The port's scheduling policies: the hybrid default, SPREAD and node
affinity: tests/test_scheduling_policy.py, case for case, on the port's
runtime. Every test has a deadline after which it fails instead of
hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Scheduling policies: hybrid binpack/spread default, task-level
SPREAD, NodeAffinity hard/soft.

Models the reference's scheduling policy unit tests
(src/ray/raylet/scheduling/policy/ tests): policy-level checks on a
synthetic node view plus end-to-end placement assertions on a virtual
multi-node cluster (placement observed through the per-node resource
view, since virtual nodes share one host).
"""
import os
import signal
import tempfile
import time
import uuid

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

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
def three_nodes():
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    cluster.add_node(num_cpus=4, label="b")
    cluster.add_node(num_cpus=4, label="c")
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


# ------------------------------------------------------- policy unit level
def _mk_nodes(avails, totals=None):
    from ray_tpu_torch._private.gcs import NodeState
    from ray_tpu_torch._private.ids import NodeID

    nodes = []
    for i, avail in enumerate(avails):
        total = (totals or avails)[i]
        nodes.append(
            NodeState(
                node_id=NodeID(bytes([i]) * 16),
                total=dict(total),
                available=dict(avail),
            )
        )
    return nodes


class _PolicyHarness:
    """Borrows the policy methods off GCSServer without starting one."""

    from ray_tpu_torch._private.gcs import GcsServer as _G

    _node_util = _G._node_util
    _hybrid_pick = _G._hybrid_pick

    def __init__(self, seed=0):
        import random

        self._sched_rng = random.Random(seed)


def test_node_util_is_critical_resource_fraction():
    h = _PolicyHarness()
    (n,) = _mk_nodes(
        [{"CPU": 2.0, "mem": 8.0}], totals=[{"CPU": 4.0, "mem": 8.0}]
    )
    # Placing 1 CPU → 3/4 used on CPU, 0 on mem → critical = 0.75.
    assert h._node_util(n, {"CPU": 1.0}) == pytest.approx(0.75)


def test_hybrid_packs_below_threshold():
    """Nodes under the spread threshold score equal → stable id order →
    successive picks PACK onto the first node instead of scattering."""
    h = _PolicyHarness()
    nodes = _mk_nodes([{"CPU": 8.0}, {"CPU": 8.0}, {"CPU": 8.0}])
    picks = set()
    for _ in range(8):
        n = h._hybrid_pick(nodes, {"CPU": 1.0})
        picks.add(n.node_id.binary())
    assert len(picks) == 1  # all 8 picks pack (top-k of 3 nodes = 1)


def test_hybrid_spreads_when_saturated():
    """Past the threshold the policy goes least-utilized-first."""
    h = _PolicyHarness()
    full, emptier = _mk_nodes(
        [{"CPU": 1.0}, {"CPU": 4.0}],
        totals=[{"CPU": 8.0}, {"CPU": 8.0}],
    )
    # Both nodes land above 0.5 after placement → less-utilized wins.
    n = h._hybrid_pick([full, emptier], {"CPU": 1.0})
    assert n is emptier


# ------------------------------------------------------------- end to end
def _block_marker(cluster_nodes_before):
    """Node-availability snapshot diff: which nodes lost CPU."""
    after = {n["label"]: n["available"].get("CPU", 0) for n in ray_tpu_torch.nodes()}
    return {
        lbl: cluster_nodes_before[lbl] - after.get(lbl, 0)
        for lbl in cluster_nodes_before
    }


def _avail_by_label():
    return {n["label"]: n["available"].get("CPU", 0) for n in ray_tpu_torch.nodes()}


@ray_tpu_torch.remote
def _hold(sec: float):
    time.sleep(sec)
    return "ok"


@ray_tpu_torch.remote
def _hold_until(path: str):
    """Holds its CPU until the release file appears."""
    while not os.path.exists(path):
        time.sleep(0.05)
    return "ok"


def test_spread_strategy_spreads_tasks(three_nodes):
    before = _avail_by_label()
    # Flag-gated holds: placement sticks only once a worker exists, and
    # worker cold-start under a loaded host can take >10s per node — the
    # holds must outlive the slowest spawn so all 6 placements overlap
    # observably, then release instantly once asserted.
    flag = os.path.join(
        tempfile.gettempdir(), f"spread-release-{uuid.uuid4().hex}"
    )
    refs = [
        _hold_until.options(scheduling_strategy="SPREAD").remote(flag)
        for _ in range(6)
    ]
    try:
        deadline = time.time() + 60
        used = {}
        while time.time() < deadline:
            used = _block_marker(before)
            if sum(used.values()) >= 6:
                break
            time.sleep(0.1)
        # SPREAD: 6 tasks over 3 four-CPU nodes → every node took two.
        assert all(v == 2 for v in used.values()), used
    finally:
        with open(flag, "w") as f:
            f.write("go")
        try:
            ray_tpu_torch.get(refs, timeout=30)
        finally:
            os.unlink(flag)


def test_default_hybrid_packs_first_node(three_nodes):
    before = _avail_by_label()
    refs = [_hold.remote(3.0) for _ in range(2)]
    deadline = time.time() + 10
    while time.time() < deadline:
        used = _block_marker(before)
        if sum(used.values()) >= 2:
            break
        time.sleep(0.1)
    used = _block_marker(before)
    # 2 one-CPU tasks on an empty 3x4-CPU cluster stay under the 0.5
    # threshold on one node → both pack together.
    assert sorted(used.values()) == [0, 0, 2], used
    ray_tpu_torch.get(refs, timeout=GET_TIMEOUT_S)


def test_node_affinity_hard_pins(three_nodes):
    target = next(n for n in ray_tpu_torch.nodes() if n["label"] == "c")
    before = _avail_by_label()
    refs = [
        _hold.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=target["node_id"], soft=False
            )
        ).remote(2.0)
        for _ in range(3)
    ]
    deadline = time.time() + 10
    while time.time() < deadline:
        used = _block_marker(before)
        if used.get("c", 0) >= 3:
            break
        time.sleep(0.1)
    used = _block_marker(before)
    assert used.get("c") == 3 and sum(used.values()) == 3, used
    ray_tpu_torch.get(refs, timeout=GET_TIMEOUT_S)


def test_node_affinity_hard_to_missing_node_fails(three_nodes):
    ref = _hold.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=b"\xff" * 16, soft=False
        )
    ).remote(0.1)
    with pytest.raises(ray_tpu_torch.exceptions.TaskUnschedulableError):
        ray_tpu_torch.get(ref, timeout=10)


def test_node_affinity_soft_falls_back(three_nodes):
    """Soft affinity to a gone node still schedules somewhere."""
    ref = _hold.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=b"\xee" * 16, soft=True
        )
    ).remote(0.1)
    assert ray_tpu_torch.get(ref, timeout=15) == "ok"
