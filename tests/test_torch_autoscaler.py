"""The port's autoscaler: tests/test_autoscaler_v2.py,
tests/test_tpu_slice_provider.py and tests/test_gce_provider.py, case
for case, on the port, then the reference and the port side by side.

- autoscaler v2 (instance-manager lifecycle, a reconciler over real
  node-daemon processes): the reference's 4 cases as they are;
- the TPU-slice provider's 3 cases on `GpuHostProvider`: a group of GPU
  hosts is as atomic as a slice (created, rolled back and terminated
  whole), its host 0 carries `GPU-h100-80gb-head` where a slice's carries
  `TPU-v5e-8-head`;
- the GCE provider's 9 cases against recorded response shapes
  (tests/fixtures/gce/responses.json and the A3 shapes here; no network
  call), with an A3 group (one
  `instances.bulkInsert` of a3-highgpu-8g VMs, `minCount` equal to
  `count`) where the reference creates a TPU node;
- the reference's and the port's `Reconciler._scale_up` launch the same
  node types for the same demand, node view and node types;
- pinned divergences: a node holding a live object's primary copy is
  not idle on the port (the reference scales it down under its owner),
  and a quiet node daemon's drain ends as soon as its heartbeat shows no
  local lease held (the reference waits out every daemon node's
  deadline).

Every test has a deadline after which it fails instead of hanging, every
`get` a timeout.
"""
import importlib
import json
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.autoscaler.gce import (
    ALREADY_EXISTS,
    GROUP_LABEL,
    GceApiError,
    GceCompute,
    GceNodeProvider,
    NOT_FOUND,
    QUOTA_EXCEEDED,
    STOCKOUT,
)
from ray_tpu_torch.autoscaler.gpu_hosts import (
    GpuHostProvider,
    HostGroupType,
    MockGpuHostApi,
    PartialGroupError,
)
from ray_tpu_torch.autoscaler.v2 import (
    ALLOCATED,
    ALLOCATION_FAILED,
    QUEUED,
    RAY_RUNNING,
    REQUESTED,
    TERMINATED,
    CloudProvider,
    Instance,
    InstanceManager,
    ProcessCloudProvider,
    Reconciler,
)

DEADLINE_S = 150
GET_TIMEOUT_S = 60
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
NAMES = sorted(RUNTIMES)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "gce")


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# ------------------------------------------- tests/test_autoscaler_v2.py


def test_instance_lifecycle_transitions():
    im = InstanceManager()
    inst = im.create("cpu", {"CPU": 2.0})
    assert inst.status == QUEUED
    im.transition(inst, REQUESTED)
    im.transition(inst, ALLOCATED)
    im.transition(inst, RAY_RUNNING)
    assert inst.history == [QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING]
    with pytest.raises(ValueError):
        im.transition(inst, ALLOCATED)  # backwards


def test_allocation_failure_retries_then_terminates():
    im = InstanceManager()
    inst = im.create("cpu", {"CPU": 1.0})
    im.transition(inst, REQUESTED)
    im.transition(inst, ALLOCATION_FAILED)
    im.transition(inst, QUEUED)  # retry path
    im.transition(inst, REQUESTED)
    im.transition(inst, ALLOCATION_FAILED)
    im.transition(inst, TERMINATED)  # give up
    assert inst.status == TERMINATED


class _FlakyProvider(CloudProvider):
    """Fails the first launch; succeeds after."""

    def __init__(self):
        self.calls = 0
        self._live = {}

    def launch(self, instance: Instance) -> str:
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("quota")
        cid = f"cloud-{self.calls}"
        self._live[cid] = {}
        return cid

    def terminate(self, cloud_instance_id: str) -> None:
        self._live.pop(cloud_instance_id, None)

    def running_instances(self):
        return dict(self._live)


@ray_tpu_torch.remote(num_cpus=2)
def _need_two_cpus():
    time.sleep(1.0)
    return "ran"


def test_reconciler_retries_failed_launches():
    ray_tpu_torch.init(num_cpus=1, ignore_reinit_error=True)
    try:
        provider = _FlakyProvider()
        rec = Reconciler(
            {"cpu": {"resources": {"CPU": 2.0}, "max_workers": 1}},
            provider,
        )
        ref = _need_two_cpus.remote()
        deadline = time.time() + 20
        while time.time() < deadline and not rec.im.instances(REQUESTED):
            rec.step()
            time.sleep(0.2)
        # First launch failed, retry succeeded; exactly one live record.
        assert provider.calls >= 2
        assert len(rec.im.instances(REQUESTED, ALLOCATED)) == 1
        del ref
    finally:
        ray_tpu_torch.shutdown()


def test_v2_end_to_end_scale_up_run_scale_down():
    """Full loop against a REAL daemon subprocess: unplaceable task ->
    launch -> daemon joins over TCP -> task completes -> idle ->
    drained -> process terminated."""
    ray_tpu_torch.init(num_cpus=1, tcp_port=0, ignore_reinit_error=True)
    try:
        from ray_tpu_torch._private.worker import _global

        provider = ProcessCloudProvider(
            _global.node.tcp_address, _global.node.authkey
        )
        rec = Reconciler(
            {"cpu": {"resources": {"CPU": 2.0}, "max_workers": 2}},
            provider,
            idle_timeout_s=1.0,
            drain_deadline_s=15.0,
        )
        ref = _need_two_cpus.remote()
        deadline = time.time() + 60
        while time.time() < deadline and not rec.im.instances(RAY_RUNNING):
            rec.step()
            time.sleep(0.3)
        assert rec.im.instances(RAY_RUNNING), rec.summary()
        assert ray_tpu_torch.get(ref, timeout=60) == "ran"
        # Idle -> drain -> EVERY instance terminated, processes reaped.
        deadline = time.time() + 90
        while time.time() < deadline and (
            provider.running_instances()
            or not rec.im.instances(TERMINATED)
        ):
            rec.step()
            time.sleep(0.3)
        assert rec.im.instances(TERMINATED), rec.summary()
        assert provider.running_instances() == {}
    finally:
        ray_tpu_torch.shutdown()


# --------------------------- tests/test_tpu_slice_provider.py on GPU hosts

H100X2 = HostGroupType(
    accelerator="h100-80gb",
    hosts=2,
    host_resources={"CPU": 2.0, "GPU": 8.0},
    max_groups=2,
)


@pytest.fixture()
def head(tmp_path):
    ray_tpu_torch.init(num_cpus=1, tcp_port=0, ignore_reinit_error=True)
    api = MockGpuHostApi(log_dir=str(tmp_path))
    # The head address and key default to the connected head's.
    provider = GpuHostProvider(api, {"gpu-h100x2": H100X2})
    try:
        yield api, provider
    finally:
        api.shutdown()
        ray_tpu_torch.shutdown()


def test_partial_creation_rolls_back_whole_group(head):
    api, provider = head
    api.fail_next.append([1])  # host 1 of the first create fails
    inst = Instance(
        instance_id="abc123",
        node_type="gpu-h100x2",
        resources=dict(H100X2.host_resources),
        hosts=2,
    )
    with pytest.raises(PartialGroupError):
        provider.launch(inst)
    # Atomicity: the surviving host was deleted with the group — no
    # leaked quota, nothing reported running.
    assert "group-abc123" in api.deleted
    assert api.list_groups() == {}


def test_pg_demand_drives_group_scale_up_with_retry(head):
    """A placement group demanding the 2-host H100 gang (head resource +
    per-host GPU bundles) makes the reconciler launch ONE whole group;
    a partial creation on the first attempt rolls back and retries."""
    api, provider = head
    rec = Reconciler(
        provider.node_types(),
        provider,
        idle_timeout_s=300.0,  # no scale-down during the test
    )
    rec.step()  # autoscaler running => GCS queues over-capacity PGs
    api.fail_next.append([0])  # first group creation partially fails

    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    pg = placement_group(
        [
            {"GPU-h100-80gb-head": 1.0, "GPU": 8.0},
            {"GPU": 8.0},
        ],
        strategy="STRICT_SPREAD",
    )
    deadline = time.time() + 90
    while time.time() < deadline and not rec.im.instances(RAY_RUNNING):
        rec.step()
        time.sleep(0.3)
    assert rec.im.instances(RAY_RUNNING), rec.summary()
    # Retry happened: one failed creation (rolled back), one success —
    # and only ONE live group serves both bundles (gang, not 2 groups).
    assert api.create_calls == 2
    assert rec.im.instances(ALLOCATION_FAILED) == []
    assert len(api.list_groups()) == 1
    assert all(m["hosts"] == 2 for m in api.list_groups().values())
    # Each host's console is kept: the failed create's surviving host's
    # and the live group's two.
    (name,) = api.list_groups()
    for i in (0, 1):
        with open(os.path.join(api.log_dir, f"{name}-h{i}.log")) as f:
            assert "node daemon up" in f.read()
    # The gang actually becomes placeable: the PG reservation completes.
    assert pg.wait(timeout_seconds=60), "placement group never became ready"
    gpus = sorted(n["total"].get("GPU", 0) for n in ray_tpu_torch.nodes()
                  if n["alive"] and n["label"].startswith("v2:"))
    assert gpus == [8.0, 8.0]
    remove_placement_group(pg)


def test_host_loss_kills_whole_group(head):
    api, provider = head
    rec = Reconciler(
        provider.node_types(),
        provider,
        idle_timeout_s=300.0,
    )
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    rec.step()  # autoscaler running => GCS queues over-capacity PGs
    pg = placement_group([{"GPU": 8.0}, {"GPU": 8.0}], strategy="STRICT_SPREAD")
    deadline = time.time() + 90
    while time.time() < deadline and not rec.im.instances(RAY_RUNNING):
        rec.step()
        time.sleep(0.3)
    assert rec.im.instances(RAY_RUNNING), rec.summary()
    remove_placement_group(pg)

    # Kill ONE host VM: the group is no longer whole — the reconciler
    # must terminate the ENTIRE group (atomic), not limp on one host.
    (name, procs), = api._groups.items()
    procs[0].kill()
    deadline = time.time() + 60
    while time.time() < deadline and not rec.im.instances(TERMINATED):
        rec.step()
        time.sleep(0.3)
    assert rec.im.instances(TERMINATED), rec.summary()
    assert api.list_groups() == {}


# ------------------------------- tests/test_gce_provider.py with A3 groups

with open(os.path.join(FIXTURE_DIR, "responses.json")) as _f:
    FIXTURES = json.load(_f)
# The recorded shapes of a bulkInsert operation and of a running A3 VM
# (a3-highgpu-8g: 8 nvidia-h100-80gb), beside the reference's shapes.
FIXTURES.update({
    "operation_bulk_insert_pending": {
        "kind": "compute#operation",
        "name": "operation-{opname}",
        "operationType": "bulkInsert",
        "targetLink": "https://www.googleapis.com/compute/v1/projects/p/zones/{zone}",
        "status": "PENDING",
        "progress": 0,
        "insertTime": "2026-07-30T10:00:00.000-07:00",
        "selfLink": "https://www.googleapis.com/compute/v1/projects/p/zones/{zone}/operations/operation-{opname}"
    },
    "instance_running_a3": {
        "kind": "compute#instance",
        "id": "6543210987654321098",
        "name": "{name}",
        "status": "RUNNING",
        "machineType": "https://www.googleapis.com/compute/v1/projects/p/zones/{zone}/machineTypes/a3-highgpu-8g",
        "zone": "https://www.googleapis.com/compute/v1/projects/p/zones/{zone}",
        "guestAccelerators": [
            {
                "acceleratorType": "https://www.googleapis.com/compute/v1/projects/p/zones/{zone}/acceleratorTypes/nvidia-h100-80gb",
                "acceleratorCount": 8
            }
        ],
        "scheduling": {
            "onHostMaintenance": "TERMINATE",
            "automaticRestart": True
        },
        "labels": {
            "ray-cluster-name": "{cluster}",
            "ray-node-type": "{node_type}",
            "ray-host-group": "{group}"
        },
        "networkInterfaces": [
            {
                "networkIP": "10.128.0.31"
            }
        ]
    }
})


def fx(key: str, **subs) -> dict:
    """Instantiate a recorded response with concrete names."""
    blob = json.dumps(FIXTURES[key])
    for k, v in subs.items():
        blob = blob.replace("{%s}" % k, str(v))
    return json.loads(blob)


def _api_error(key: str, **subs) -> GceApiError:
    body = fx(key, **subs)["error"]
    return GceApiError(
        body["code"], body["errors"][0]["reason"], body["message"]
    )


class FixtureGce(GceCompute):
    """Replays recorded responses. Mutations create pending operations
    that advance PENDING -> RUNNING -> DONE across get_operation polls
    (GCE mutations are async); tests inject error fixtures per call."""

    def __init__(self, cluster="c1", zone="us-central1-b"):
        self.cluster = cluster
        self.zone = zone
        self.vms: dict = {}
        self.ops: dict = {}
        self.calls: list = []
        self.bodies: list = []
        self.inject: dict = {}  # method name -> GceApiError (once)

    def _maybe_fail(self, method: str):
        err = self.inject.pop(method, None)
        if err is not None:
            raise err

    def _new_op(self, name: str, on_done, error_fixture=None,
                key="operation_pending") -> dict:
        op = fx(key, opname=name, zone=self.zone, name=name)
        self.ops[op["name"]] = {
            "polls": 0, "on_done": on_done, "error_fixture": error_fixture,
        }
        return op

    def insert_instance(self, zone, body):
        self.calls.append(("insert_instance", body["name"]))
        self._maybe_fail("insert_instance")
        name = body["name"]
        return self._new_op(
            name, lambda: self.vms.__setitem__(name, body)
        )

    def bulk_insert_instances(self, zone, body):
        names = sorted(body["perInstanceProperties"])
        self.calls.append(("bulk_insert_instances", names[0].rsplit("-h", 1)[0]))
        self.bodies.append(body)
        self._maybe_fail("bulk_insert_instances")
        err_fx = self.inject.pop("bulk_operation_error", None)
        # A VM that a failed operation left behind (the rollback's case).
        left = self.inject.pop("bulk_left_behind", None)
        props = body["instanceProperties"]

        def create(only=None):
            for n in names if only is None else [only]:
                self.vms[n] = {"name": n, "labels": dict(props["labels"])}

        if err_fx and left:
            create(left)
        return self._new_op(
            names[0], create, error_fixture=err_fx,
            key="operation_bulk_insert_pending",
        )

    def delete_instance(self, zone, name):
        self.calls.append(("delete_instance", name))
        self._maybe_fail("delete_instance")
        if name not in self.vms:
            raise _api_error("error_not_found", zone=zone, name=name)
        return self._new_op(f"del-{name}", lambda: self.vms.pop(name, None))

    def list_instances(self, zone, label_filter):
        out = []
        for name, body in self.vms.items():
            labels = body["labels"]
            subs = dict(name=name, zone=zone,
                        cluster=labels["ray-cluster-name"],
                        node_type=labels["ray-node-type"])
            if GROUP_LABEL in labels:
                vm = fx("instance_running_a3", group=labels[GROUP_LABEL], **subs)
            else:
                vm = fx("instance_running", **subs)
            if all(vm["labels"].get(k) == v for k, v in label_filter.items()):
                out.append(vm)
        return out

    def get_operation(self, zone, op_name):
        st = self.ops[op_name]
        st["polls"] += 1
        if st["polls"] == 1:
            out = fx("operation_running")
        elif st["error_fixture"]:
            out = fx(st["error_fixture"], zone=zone)
        else:
            st["on_done"]()
            out = fx("operation_done")
        out["name"] = op_name
        return out


TEMPLATES = {
    "cpu8": {"machine_type": "n2-standard-8"},
    "a3-16": {"accelerator_type": "nvidia-h100-80gb", "hosts": 2},
}


def _provider(api=None):
    api = api or FixtureGce()
    return api, GceNodeProvider(
        api,
        cluster_name=api.cluster,
        zone=api.zone,
        node_type_templates=TEMPLATES,
    )


def _inst(node_type="cpu8", iid="i-0001", hosts=1) -> Instance:
    return Instance(
        instance_id=iid, node_type=node_type, resources={"CPU": 8},
        hosts=hosts,
    )


def test_launch_polls_operation_to_done_and_lists_running():
    api, p = _provider()
    cloud_id = p.launch(_inst())
    assert cloud_id == "ray-c1-i-0001"
    # The mutation was async: at least one RUNNING poll happened.
    assert any(st["polls"] >= 2 for st in api.ops.values())
    running = p.running_instances()
    assert cloud_id in running
    assert running[cloud_id]["node_type"] == "cpu8"


def test_quota_error_is_typed_and_retryable():
    api, p = _provider()
    api.inject["insert_instance"] = _api_error(
        "error_quota", zone=api.zone, name="x"
    )
    with pytest.raises(GceApiError) as ei:
        p.launch(_inst())
    assert ei.value.reason == QUOTA_EXCEEDED
    assert ei.value.retryable


def test_rate_limit_is_retryable_bad_request_is_not():
    assert _api_error("error_rate_limited", zone="z", name="n").retryable
    assert not GceApiError(400, "invalid", "bad template").retryable


def test_already_exists_adopts_instance():
    """A retried launch whose first insert succeeded (lost response)
    adopts the live VM instead of failing — names are deterministic."""
    api, p = _provider()
    p.launch(_inst())
    api.inject["insert_instance"] = _api_error(
        "error_already_exists", zone=api.zone, name="ray-c1-i-0001"
    )
    assert p.launch(_inst()) == "ray-c1-i-0001"


def test_terminate_is_idempotent_on_404():
    api, p = _provider()
    cid = p.launch(_inst())
    p.terminate(cid)
    assert cid not in api.vms
    p.terminate(cid)  # second delete hits 404: swallowed


def test_a3_group_stockout_rolls_back_whole_group():
    """Stockouts surface on the DONE bulkInsert operation, not the call;
    every named VM must be deleted before the error propagates (atomic
    groups never leak quota), whether or not it was made."""
    api, p = _provider()
    api.inject["bulk_operation_error"] = "operation_done_stockout"
    api.inject["bulk_left_behind"] = "ray-c1-i-a3g1-h0"
    with pytest.raises(GceApiError) as ei:
        p.launch(_inst("a3-16", iid="i-a3g1", hosts=2))
    assert ei.value.reason == STOCKOUT
    assert ei.value.retryable
    body, = api.bodies
    assert body["count"] == body["minCount"] == 2
    assert body["instanceProperties"]["machineType"] == "a3-highgpu-8g"
    assert body["instanceProperties"]["scheduling"]["onHostMaintenance"] == "TERMINATE"
    assert sorted(body["perInstanceProperties"]) == ["ray-c1-i-a3g1-h0", "ray-c1-i-a3g1-h1"]
    assert ("delete_instance", "ray-c1-i-a3g1-h0") in api.calls
    assert ("delete_instance", "ray-c1-i-a3g1-h1") in api.calls  # 404: swallowed
    assert api.vms == {}


def test_a3_group_launch_and_list():
    api, p = _provider()
    cid = p.launch(_inst("a3-16", iid="i-a3g2", hosts=2))
    assert ("bulk_insert_instances", cid) in api.calls
    running = p.running_instances()
    assert running[cid] == {
        "kind": "gpu_group", "node_type": "a3-16", "hosts": 2,
    }
    vm = api.list_instances(api.zone, {GROUP_LABEL: cid})[0]
    assert vm["guestAccelerators"][0]["acceleratorCount"] == 8
    p.terminate(cid)
    assert api.vms == {}
    p.terminate(cid)  # gone: idempotent


def test_listing_filters_foreign_clusters():
    api, p = _provider()
    p.launch(_inst())
    # A VM belonging to another ray cluster in the same zone/project.
    api.vms["ray-other-i-9"] = {
        "name": "ray-other-i-9",
        "labels": {"ray-cluster-name": "other", "ray-node-type": "cpu8"},
    }
    assert set(p.running_instances()) == {"ray-c1-i-0001"}


def test_reconciler_retries_provider_failure_with_budget():
    """The v2 reconciler's contract on a raising provider: REQUESTED ->
    ALLOCATION_FAILED, re-QUEUED up to max_launch_attempts, then
    TERMINATED (reference: instance_manager retry budget)."""
    api, p = _provider()
    r = Reconciler(
        {"cpu8": {"resources": {"CPU": 8}}}, p, max_launch_attempts=2
    )
    inst = r.im.create("cpu8", {"CPU": 8})
    api.inject["insert_instance"] = _api_error(
        "error_quota", zone=api.zone, name="x"
    )
    r._launch(inst)
    assert inst.status == ALLOCATION_FAILED
    r._sync_cloud({}, now=0.0)
    assert inst.status == QUEUED
    api.inject["insert_instance"] = _api_error(
        "error_quota", zone=api.zone, name="x"
    )
    r._launch(inst)
    assert inst.status == ALLOCATION_FAILED
    r._sync_cloud({}, now=0.0)
    assert inst.status == TERMINATED  # budget exhausted

    # And a clean retry path: fresh instance launches on attempt 2.
    inst2 = r.im.create("cpu8", {"CPU": 8})
    api.inject["insert_instance"] = _api_error(
        "error_rate_limited", zone=api.zone, name="x"
    )
    r._launch(inst2)
    r._sync_cloud({}, now=0.0)
    assert inst2.status == QUEUED
    r._launch(inst2)
    assert inst2.status == REQUESTED
    assert inst2.cloud_instance_id in p.running_instances()


# ------------------------------------------------- against the reference


class _Recording:
    """A provider that launches nothing and records what it was asked."""

    def __init__(self):
        self.launched = []

    def launch(self, instance):
        self.launched.append((instance.node_type, instance.hosts))
        return f"rec-{len(self.launched)}"


GANG = {"resources": {"CPU": 2.0, "GPU": 8.0}, "hosts": 2,
        "head_resource": "GPU-h100-80gb-head", "max_workers": 2}
SCALE_UP_CASES = {
    # A 2-host gang and a task that fits beside it: one group, the head
    # bundle placed first.
    "gang": (
        {"g": GANG},
        [],
        {"task_demands": [{"CPU": 1.0}],
         "pg_demands": [[{"GPU": 8.0}, {"GPU-h100-80gb-head": 1.0, "GPU": 8.0}]]},
    ),
    # Two node types: CPU shapes pack onto the CPU type, GPU shapes
    # open the GPU type, and the cap holds.
    "mixed": (
        {"cpu": {"resources": {"CPU": 4.0}, "max_workers": 3},
         "gpu": {"resources": {"CPU": 8.0, "GPU": 1.0}, "max_workers": 1}},
        [],
        {"task_demands": [{"CPU": 2.0}] * 5 + [{"GPU": 1.0}] * 3,
         "pg_demands": []},
    ),
    # Free capacity on an alive node is used before anything launches;
    # a dead node's is not.
    "free_capacity": (
        {"cpu": {"resources": {"CPU": 2.0}}},
        [{"alive": True, "available": {"CPU": 2.0}},
         {"alive": False, "available": {"CPU": 8.0}}],
        {"task_demands": [{"CPU": 1.0}] * 5, "pg_demands": []},
    ),
    # A shape no node type can ever hold launches nothing.
    "unplaceable": (
        {"cpu": {"resources": {"CPU": 2.0}}},
        [],
        {"task_demands": [{"GPU": 1.0}, {"CPU": 4.0}], "pg_demands": [[{}]]},
    ),
}


@pytest.mark.parametrize("case", sorted(SCALE_UP_CASES))
def test_scale_up_launches_what_the_references_reconciler_launches(case):
    """Two rounds of `_scale_up` on the same reply: the second must
    count the first round's pending instances, on both."""
    from ray_tpu.autoscaler.v2 import Reconciler as RefReconciler

    node_types, nodes, reply = SCALE_UP_CASES[case]
    got = {}
    for name, cls in (("ray_tpu", RefReconciler), ("ray_tpu_torch", Reconciler)):
        provider = _Recording()
        rec = cls(json.loads(json.dumps(node_types)), provider)
        for _ in range(2):
            rec._scale_up(json.loads(json.dumps(reply)), json.loads(json.dumps(nodes)))
        got[name] = provider.launched
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"] == {
        "gang": [("g", 2)],
        "mixed": [("cpu", 1), ("cpu", 1), ("cpu", 1), ("gpu", 1)],
        "free_capacity": [("cpu", 1), ("cpu", 1)],
        "unplaceable": [],
    }[case]


def _wait(pred, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.2)
    return False


def _daemon_cluster(name):
    cu = importlib.import_module(f"{name}.cluster_utils")
    return cu.DaemonCluster(head_node_args={"num_cpus": 1, "tcp_port": 0})


@pytest.mark.parametrize("name", NAMES)
def test_a_node_holding_a_live_objects_primary_copy_is_not_idle(name):
    """Pinned divergence: on the port a node is not idle (and so not
    scaled down) while it holds the primary copy of an object its owner
    still references; the reference counts it idle."""
    rt = RUNTIMES[name]
    client = importlib.import_module(f"{name}._private.worker").global_client
    cluster = _daemon_cluster(name)
    try:
        cluster.add_node(num_cpus=1, resources={"far": 1.0}, label="far")
        far = next(n["node_id"] for n in rt.nodes() if n["label"] == "far")

        def idle():
            reply = client().request({"type": "get_pending_demand"})
            return far in reply["idle_nodes"]

        @rt.remote(resources={"far": 0.01})
        def make_big(seed):
            return np.random.default_rng(seed).random((1 << 20) // 8)

        ref = make_big.remote(7)
        want = np.random.default_rng(7).random((1 << 20) // 8)
        assert np.array_equal(rt.get(ref, timeout=GET_TIMEOUT_S), want)
        if name == "ray_tpu":
            assert _wait(idle, 20)
        else:
            assert not _wait(idle, 5)
            del ref
            assert _wait(idle, 20)
    finally:
        cluster.shutdown()


@ray_tpu_torch.remote
def _hold(sec):
    time.sleep(sec)
    return "done"


@ray_tpu_torch.remote
def _start_hold_from_here(sec):
    """Submits `_hold` from a worker of this node (its daemon's local
    lease route) and returns without waiting for it."""
    return [_hold.remote(sec)]


@pytest.mark.parametrize("name", NAMES)
def test_a_quiet_daemon_node_drains_before_its_deadline_on_the_port_only(name):
    """Pinned divergence: the GCS holds a node daemon's own pool workers
    as LEASED for good. The reference's drain counts them busy and so
    waits out the deadline of every daemon node; the port's counts them
    only while the daemon's heartbeat, sent after the drain began,
    reports a local lease held."""
    rt = RUNTIMES[name]
    cluster = _daemon_cluster(name)
    try:
        cluster.add_node(num_cpus=2, label="b")
        b = next(n["node_id"] for n in rt.nodes() if n["label"] == "b")
        state = importlib.import_module(f"{name}.util.state")
        # The daemon's pool: one worker of its own per CPU, each held as
        # LEASED by the GCS from its registration on.
        assert _wait(lambda: sum(
            w["node_id"] == b.hex() and w["state"] == "LEASED"
            for w in state.list_workers()) == 2, 30)

        def gone():
            return not any(n["node_id"] == b and n["alive"] for n in rt.nodes())

        t0 = time.time()
        assert rt.drain_node(b, reason="test", deadline_s=8.0)
        if name == "ray_tpu":
            assert not _wait(gone, 5)
            assert _wait(gone, 20)
            assert time.time() - t0 >= 8.0
        else:
            assert _wait(gone, 5)
    finally:
        cluster.shutdown()


def test_the_ports_drain_still_waits_for_a_task_started_on_the_node():
    """The port's early end of a drain does not cut short a task that a
    worker of the node started after its own task returned."""
    cluster = _daemon_cluster("ray_tpu_torch")
    try:
        cluster.add_node(num_cpus=2, resources={"b": 1.0}, label="b")
        b = next(n["node_id"] for n in ray_tpu_torch.nodes() if n["label"] == "b")
        inner, = ray_tpu_torch.get(
            _start_hold_from_here.options(resources={"b": 0.01}).remote(4.0),
            timeout=GET_TIMEOUT_S)
        t0 = time.time()
        assert ray_tpu_torch.drain_node(b, reason="test", deadline_s=30.0)
        assert ray_tpu_torch.get(inner, timeout=GET_TIMEOUT_S) == "done"
        assert _wait(lambda: not any(n["node_id"] == b and n["alive"]
                                     for n in ray_tpu_torch.nodes()), 20)
        assert time.time() - t0 >= 2.0, "node removed before its task finished"
    finally:
        cluster.shutdown()
