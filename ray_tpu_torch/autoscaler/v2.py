"""Autoscaler v2: instance manager + reconciler over a cloud provider.

Reference: python/ray/autoscaler/v2/ — the instance manager owns a
per-instance lifecycle state machine
(instance_manager/common.py InstanceUtil):

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING -> RAY_STOPPED
                      \\-> ALLOCATION_FAILED (retry)   -> TERMINATING
                                                       -> TERMINATED

and the Reconciler (instance_manager/reconciler.py) drives it by
diffing three views every tick: the CLOUD view (provider instances),
the RAY view (GCS nodes), and DEMAND (unplaceable shapes). Scale-down
is graceful: idle nodes are DRAINED (no new placements, running work
finishes) before their instance is released.

The ProcessCloudProvider launches REAL node daemons
(`ray_tpu_torch._private.raylet` subprocesses over the TCP control
plane) — the same daemon a GCE or GPU-host provider would start on a
fresh VM — so the whole loop is testable end-to-end on one box. A real
cloud provider implements the same 3-method surface against its VM API.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .._private.gcs import _fits

# Lifecycle states (reference: instance_manager/common.py).
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
RAY_STOPPED = "RAY_STOPPED"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

_TRANSITIONS = {
    QUEUED: {REQUESTED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED},
    ALLOCATED: {RAY_RUNNING, RAY_STOPPED, TERMINATING},
    RAY_RUNNING: {RAY_STOPPED, TERMINATING},
    RAY_STOPPED: {TERMINATING},
    TERMINATING: {TERMINATED},
    ALLOCATION_FAILED: {QUEUED, TERMINATED},
    TERMINATED: set(),
}


@dataclass
class Instance:
    instance_id: str
    node_type: str
    resources: Dict[str, float]
    hosts: int = 1  # >1: an atomic multi-host slice (all-or-nothing)
    status: str = QUEUED
    cloud_instance_id: Optional[str] = None
    node_id: Optional[bytes] = None  # GCS node id once RAY_RUNNING
    launch_attempts: int = 0
    status_since: float = field(default_factory=time.monotonic)
    history: List[str] = field(default_factory=list)


class InstanceManager:
    """Owns instance records; every transition is validated and logged
    (reference: instance_manager/instance_manager.py)."""

    def __init__(self):
        self._instances: Dict[str, Instance] = {}

    def create(self, node_type: str, resources: Dict[str, float],
               hosts: int = 1) -> Instance:
        inst = Instance(
            instance_id=uuid.uuid4().hex[:12],
            node_type=node_type,
            resources=dict(resources),
            hosts=hosts,
        )
        inst.history.append(QUEUED)
        self._instances[inst.instance_id] = inst
        return inst

    def transition(self, inst: Instance, new_status: str) -> None:
        if new_status not in _TRANSITIONS.get(inst.status, set()):
            raise ValueError(
                f"invalid transition {inst.status} -> {new_status} "
                f"for instance {inst.instance_id}"
            )
        inst.status = new_status
        inst.status_since = time.monotonic()
        inst.history.append(new_status)

    def instances(self, *statuses: str) -> List[Instance]:
        if not statuses:
            return list(self._instances.values())
        return [i for i in self._instances.values() if i.status in statuses]

    def get(self, instance_id: str) -> Optional[Instance]:
        return self._instances.get(instance_id)


class CloudProvider:
    """3-method provider surface (reference:
    instance_manager/cloud_providers/cloud_provider.py)."""

    def launch(self, instance: Instance) -> str:
        """Start a VM/process for the instance; returns cloud id.
        May raise — the reconciler retries with backoff."""
        raise NotImplementedError

    def terminate(self, cloud_instance_id: str) -> None:
        raise NotImplementedError

    def running_instances(self) -> Dict[str, Any]:
        """cloud_instance_id -> opaque metadata for live instances."""
        raise NotImplementedError


def node_daemon_command(head_address: str, authkey: bytes,
                        resources: Dict[str, float], label: str,
                        transfer_host: str = "127.0.0.1") -> List[str]:
    """The command a fresh host runs to join the head: the port's node
    daemon with its CPUs and GPUs as flags (``--num-gpus`` sets how many
    cards its workers are pinned to) and every other resource as JSON."""
    extra = {k: v for k, v in resources.items() if k not in ("CPU", "GPU")}
    return [
        sys.executable,
        "-m",
        "ray_tpu_torch._private.raylet",
        "--address",
        head_address,
        "--authkey",
        authkey.hex(),
        "--num-cpus",
        str(float(resources.get("CPU", 1))),
        "--num-gpus",
        str(int(resources.get("GPU", 0))),
        "--resources",
        json.dumps(extra),
        "--label",
        label,
        "--transfer-host",
        transfer_host,
    ]


class ProcessCloudProvider(CloudProvider):
    """Each 'instance' is a real node-daemon subprocess joining the
    head over TCP — the exact process a cloud VM's startup script would
    run (`python -m ray_tpu_torch start --address=<head>`)."""

    def __init__(self, head_address: str, authkey: bytes):
        self.head_address = head_address
        self.authkey = authkey
        self._procs: Dict[str, subprocess.Popen] = {}

    def launch(self, instance: Instance) -> str:
        proc = subprocess.Popen(
            node_daemon_command(
                self.head_address, self.authkey, instance.resources,
                f"v2:{instance.instance_id}",
            ),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        cloud_id = f"proc-{proc.pid}"
        self._procs[cloud_id] = proc
        return cloud_id

    def terminate(self, cloud_instance_id: str) -> None:
        proc = self._procs.pop(cloud_instance_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()

    def running_instances(self) -> Dict[str, Any]:
        return {
            cid: {"pid": p.pid}
            for cid, p in self._procs.items()
            if p.poll() is None
        }


class Reconciler:
    """One step() = one reconciliation pass over cloud/ray/demand views
    (reference: instance_manager/reconciler.py Reconciler.reconcile)."""

    def __init__(
        self,
        node_types: Dict[str, Dict[str, Any]],
        provider: CloudProvider,
        *,
        idle_timeout_s: float = 30.0,
        request_timeout_s: float = 60.0,
        max_launch_attempts: int = 3,
        drain_deadline_s: float = 30.0,
    ):
        self.node_types = node_types
        self.provider = provider
        self.im = InstanceManager()
        self.idle_timeout_s = idle_timeout_s
        self.request_timeout_s = request_timeout_s
        self.max_launch_attempts = max_launch_attempts
        self.drain_deadline_s = drain_deadline_s
        self._idle_since: Dict[str, float] = {}  # instance_id -> t
        self._draining: set = set()

    # ------------------------------------------------------------- views
    def _client(self):
        from .._private.worker import global_client

        return global_client()


    # -------------------------------------------------------------- step
    def step(self) -> None:
        now = time.monotonic()
        cloud = self.provider.running_instances()
        info = self._client().cluster_info()
        # instance_id -> [host nodes]; single-host instances are
        # labeled "v2:<iid>", slice hosts "v2:<iid>:h<k>".
        ray_view: Dict[str, List[Dict]] = {}
        for n in info["nodes"]:
            label = n.get("label", "")
            if label.startswith("v2:"):
                iid = label[3:].split(":", 1)[0]
                ray_view.setdefault(iid, []).append(n)
        reply = self._client().request({"type": "get_pending_demand"})
        self._sync_cloud(cloud, now)
        self._sync_ray(ray_view, cloud)
        self._scale_up(reply, info["nodes"])
        self._scale_down(reply, ray_view, now)

    # ------------------------------------------------------ cloud sync
    def _sync_cloud(self, cloud: Dict[str, Any], now: float) -> None:
        for inst in self.im.instances(REQUESTED):
            if inst.cloud_instance_id in cloud:
                self.im.transition(inst, ALLOCATED)
            elif now - inst.status_since > self.request_timeout_s:
                self.im.transition(inst, ALLOCATION_FAILED)
        for inst in self.im.instances(ALLOCATION_FAILED):
            if inst.launch_attempts < self.max_launch_attempts:
                self.im.transition(inst, QUEUED)
            else:
                self.im.transition(inst, TERMINATED)
        # Cloud instance vanished under a live record (preempted VM,
        # crashed daemon): mark stopped so it gets cleaned up.
        for inst in self.im.instances(ALLOCATED, RAY_RUNNING):
            if inst.cloud_instance_id not in cloud:
                self.im.transition(inst, RAY_STOPPED)
        # Allocated but never (fully) joined — e.g. one slice host died
        # before registering: the survivors pin phantom capacity and
        # the demand they were launched for can never place. Recycle.
        for inst in self.im.instances(ALLOCATED):
            if now - inst.status_since > self.request_timeout_s:
                self.im.transition(inst, RAY_STOPPED)

    # -------------------------------------------------------- ray sync
    def _sync_ray(self, ray_view: Dict[str, List[Dict]], cloud) -> None:
        for inst in self.im.instances(ALLOCATED):
            alive = [
                n for n in ray_view.get(inst.instance_id, []) if n["alive"]
            ]
            # A slice runs only when EVERY host has joined (atomic).
            if len(alive) >= inst.hosts:
                inst.node_id = alive[0]["node_id"]
                self.im.transition(inst, RAY_RUNNING)
        for inst in self.im.instances(RAY_RUNNING):
            alive = [
                n for n in ray_view.get(inst.instance_id, []) if n["alive"]
            ]
            # Losing ANY host kills the whole slice.
            if len(alive) < inst.hosts:
                self.im.transition(inst, RAY_STOPPED)
        for inst in self.im.instances(RAY_STOPPED):
            self.im.transition(inst, TERMINATING)
            if inst.cloud_instance_id:
                self.provider.terminate(inst.cloud_instance_id)
            self.im.transition(inst, TERMINATED)
            self._draining.discard(inst.instance_id)

    # -------------------------------------------------------- scale up
    def _pending_shapes(self, reply) -> List[Dict[str, float]]:
        shapes = list(reply["task_demands"])
        for bundle_list in reply["pg_demands"]:
            shapes.extend(bundle_list)
        # Head/gang resources exist on exactly one host per slice; fit
        # those shapes first so a plain bundle never squats the head
        # host and forces a spurious extra slice.
        return sorted(
            (s for s in shapes if s),
            key=lambda s: not any(k.endswith("-head") for k in s),
        )

    def _scale_up(self, reply, nodes: List[Dict[str, Any]]) -> None:
        demands = self._pending_shapes(reply)
        if not demands:
            return
        # The demand list is the scheduler's whole pending queue — a
        # shape that fits an alive node's FREE capacity will be placed
        # as soon as a worker spawns, and capacity already launched but
        # not yet serving counts too (otherwise every tick re-launches
        # the same need while a daemon is still registering).
        capacities: List[Dict[str, float]] = [
            dict(n["available"]) for n in nodes if n["alive"]
        ]
        for i in self.im.instances(QUEUED, REQUESTED, ALLOCATED):
            cfg = self.node_types.get(i.node_type, {"resources": i.resources})
            capacities.extend(self._host_capacities(cfg))
        to_launch: List[str] = []
        counts: Dict[str, int] = {}
        for i in self.im.instances():
            if i.status not in (TERMINATED, ALLOCATION_FAILED):
                counts[i.node_type] = counts.get(i.node_type, 0) + 1
        for shape in demands:
            placed = False
            for cap in capacities:
                if _fits(cap, shape):
                    for k, v in shape.items():
                        cap[k] -= v
                    placed = True
                    break
            if placed:
                continue
            for t, cfg in self.node_types.items():
                if counts.get(t, 0) + to_launch.count(t) >= cfg.get(
                    "max_workers", 10
                ):
                    continue
                host_caps = self._host_capacities(cfg)
                hit = next(
                    (c for c in host_caps if _fits(c, shape)), None
                )
                if hit is not None:
                    for k, v in shape.items():
                        hit[k] -= v
                    # Remaining bundles of the same gang can land on
                    # the other hosts of this pending slice.
                    capacities.extend(host_caps)
                    to_launch.append(t)
                    break
        for t in to_launch:
            cfg = self.node_types[t]
            inst = self.im.create(
                t, cfg["resources"], hosts=cfg.get("hosts", 1)
            )
            self._launch(inst)
        # Re-launch retried instances.
        for inst in self.im.instances(QUEUED):
            self._launch(inst)

    @staticmethod
    def _host_capacities(cfg: Dict[str, Any]) -> List[Dict[str, float]]:
        """Per-host capacity dicts for a node type (slice types have
        several hosts; host 0 carries the gang head resource)."""
        hosts = cfg.get("hosts", 1)
        caps = [dict(cfg["resources"]) for _ in range(hosts)]
        head = cfg.get("head_resource")
        if head:
            caps[0][head] = caps[0].get(head, 0) + 1.0
        return caps

    def _launch(self, inst: Instance) -> None:
        inst.launch_attempts += 1
        try:
            cloud_id = self.provider.launch(inst)
        except Exception:  # noqa: BLE001 - provider failure -> retry
            self.im.transition(inst, REQUESTED)
            self.im.transition(inst, ALLOCATION_FAILED)
            return
        inst.cloud_instance_id = cloud_id
        self.im.transition(inst, REQUESTED)

    # ------------------------------------------------------ scale down
    def _scale_down(self, reply, ray_view: Dict[str, List[Dict]],
                    now: float) -> None:
        idle_node_ids = set(reply.get("idle_nodes", []))
        for inst in self.im.instances(RAY_RUNNING):
            if inst.instance_id in self._draining:
                continue
            nodes = ray_view.get(inst.instance_id)
            if not nodes:
                continue
            if all(n["node_id"] in idle_node_ids for n in nodes):
                since = self._idle_since.setdefault(inst.instance_id, now)
                if now - since >= self.idle_timeout_s:
                    from .._private.worker import drain_node

                    for n in nodes:
                        drain_node(
                            n["node_id"],
                            reason="autoscaler v2 idle scale-down",
                            deadline_s=self.drain_deadline_s,
                        )
                    self._draining.add(inst.instance_id)
                    self._idle_since.pop(inst.instance_id, None)
            else:
                self._idle_since.pop(inst.instance_id, None)

    # ----------------------------------------------------------- status
    def summary(self) -> Dict[str, Any]:
        by_status: Dict[str, int] = {}
        for i in self.im.instances():
            by_status[i.status] = by_status.get(i.status, 0) + 1
        return {
            "instances": by_status,
            "draining": len(self._draining),
        }
