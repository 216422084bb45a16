"""GCE-shaped cloud provider: the real API surface, offline-testable.

Reference: python/ray/autoscaler/_private/gcp/node_provider.py +
.../gcp/node.py (operation polling, label-filtered listing) — rebuilt
against an injectable transport so the v2 reconciler is exercised on
*recorded response shapes* (the tests make no network call; the
fixture transport replays the JSON bodies the live API returns,
including its error taxonomy).

The surface mirrors GCE semantics faithfully:

- mutations are ASYNC: ``instances.insert`` / ``instances.bulkInsert``
  return an operation that must be polled to DONE, and a DONE operation
  can still carry ``error`` (quota, stockout);
- errors are TYPED: HTTP 403 quotaExceeded, 409 alreadyExists,
  404 notFound, 429 rateLimit, 5xx backend — each with a distinct
  handling rule (retry / adopt / ignore / backoff);
- GPU host groups are ATOMIC (the reference's TPU slices): one
  ``instances.bulkInsert`` of ``a3-highgpu-8g`` VMs (8 H100 80GB each)
  with ``minCount`` equal to ``count``, so GCE creates all of them or
  none; a failed operation's named VMs are deleted whole before the
  error is raised, so quota never leaks.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .v2 import CloudProvider, Instance

# HTTP status -> canonical GCE error reasons (the subset the provider
# must react to; reference gcp/node_provider.py error handling).
QUOTA_EXCEEDED = "quotaExceeded"
ALREADY_EXISTS = "alreadyExists"
NOT_FOUND = "notFound"
RATE_LIMITED = "rateLimitExceeded"
BACKEND_ERROR = "backendError"
STOCKOUT = "ZONE_RESOURCE_POOL_EXHAUSTED"


class GceApiError(Exception):
    """An HTTP-level or operation-level API failure."""

    def __init__(self, code: int, reason: str, message: str = ""):
        super().__init__(f"HTTP {code} {reason}: {message or reason}")
        self.code = code
        self.reason = reason

    @property
    def retryable(self) -> bool:
        """Transient for the reconciler's launch-retry/backoff loop.
        Quota and stockout ARE retryable — capacity frees up — while
        4xx request errors (bad template, permissions) are not."""
        return (
            self.code in (429, 500, 502, 503)
            or self.reason in (QUOTA_EXCEEDED, RATE_LIMITED, STOCKOUT)
        )


class GceCompute:
    """The mockable transport seam, method-per-endpoint (reference:
    gcp/node.py GCPCompute wraps googleapiclient's compute.instances()).
    Every method returns the decoded JSON body the REST API would."""

    def insert_instance(self, zone: str, body: Dict[str, Any]) -> Dict:
        raise NotImplementedError

    def bulk_insert_instances(self, zone: str, body: Dict[str, Any]) -> Dict:
        """``instances.bulkInsert``: one operation for ``count`` VMs, of
        which at least ``minCount`` must be created or none are."""
        raise NotImplementedError

    def delete_instance(self, zone: str, name: str) -> Dict:
        raise NotImplementedError

    def list_instances(self, zone: str, label_filter: Dict[str, str]) -> List[Dict]:
        raise NotImplementedError

    def get_operation(self, zone: str, op_name: str) -> Dict:
        raise NotImplementedError


# The label that ties the VMs of one host group together.
GROUP_LABEL = "ray-host-group"


class GceNodeProvider(CloudProvider):
    """CloudProvider over the GCE surface.

    node_types config entries (per node type name):
      machine_type: "n2-standard-8"            (plain VM types)
      accelerator_type: "nvidia-h100-80gb"     (GPU host-group types; the
                                                machine type defaults to
                                                "a3-highgpu-8g")
      hosts: N                                 (group host count)
      source_image / disks / network: template passthrough
    """

    def __init__(
        self,
        api: GceCompute,
        *,
        cluster_name: str,
        zone: str,
        node_type_templates: Dict[str, Dict[str, Any]],
        op_poll_interval_s: float = 0.0,
        op_poll_limit: int = 120,
    ):
        self.api = api
        self.cluster_name = cluster_name
        self.zone = zone
        self.templates = node_type_templates
        self.op_poll_interval_s = op_poll_interval_s
        self.op_poll_limit = op_poll_limit

    # ------------------------------------------------------------ labels
    def _labels(self, inst: Instance) -> Dict[str, str]:
        # The label pair the reference uses to find its own nodes
        # (gcp/config.py: ray-cluster-name / ray-node-type).
        return {
            "ray-cluster-name": self.cluster_name,
            "ray-node-type": inst.node_type,
        }

    def _cluster_filter(self) -> Dict[str, str]:
        return {"ray-cluster-name": self.cluster_name}

    # --------------------------------------------------------- operations
    def _wait_operation(self, op: Dict) -> Dict:
        """Poll an async mutation to DONE; a DONE op may itself carry a
        typed error (quota at insert time is synchronous 403, but
        stockouts surface HERE, on the completed operation)."""
        polls = 0
        while op.get("status") != "DONE":
            if polls >= self.op_poll_limit:
                raise GceApiError(
                    504, BACKEND_ERROR,
                    f"operation {op.get('name')} did not finish",
                )
            polls += 1
            if self.op_poll_interval_s:
                time.sleep(self.op_poll_interval_s)
            op = self.api.get_operation(self.zone, op["name"])
        err = op.get("error")
        if err:
            first = (err.get("errors") or [{}])[0]
            raise GceApiError(
                int(op.get("httpErrorStatusCode", 409)),
                first.get("code", BACKEND_ERROR),
                first.get("message", ""),
            )
        return op

    # ------------------------------------------------------------- launch
    def launch(self, instance: Instance) -> str:
        tmpl = self.templates[instance.node_type]
        name = f"ray-{self.cluster_name}-{instance.instance_id}"
        if tmpl.get("accelerator_type"):
            return self._launch_gpu_group(instance, name, tmpl)
        body = {
            "name": name,
            "machineType": tmpl.get("machine_type", "n2-standard-8"),
            "labels": self._labels(instance),
            "disks": tmpl.get("disks", []),
            "networkInterfaces": tmpl.get("network", []),
            "metadata": {
                "items": [
                    {"key": "ray-start", "value": tmpl.get("startup", "")}
                ]
            },
        }
        try:
            op = self.api.insert_instance(self.zone, body)
        except GceApiError as e:
            if e.reason == ALREADY_EXISTS:
                # Reconciler retried a launch whose first insert DID go
                # through (response lost): adopt the live instance
                # instead of erroring — names are deterministic.
                return name
            raise
        self._wait_operation(op)
        return name

    @staticmethod
    def host_names(name: str, hosts: int) -> List[str]:
        """The VM names of a group (deterministic, as adoption needs)."""
        return [f"{name}-h{i}" for i in range(hosts)]

    def _launch_gpu_group(self, instance: Instance, name: str,
                          tmpl: Dict[str, Any]) -> str:
        hosts = int(tmpl.get("hosts", 1))
        names = self.host_names(name, hosts)
        body = {
            "count": hosts,
            # All or nothing: GCE creates every VM of the group or none.
            "minCount": hosts,
            "perInstanceProperties": {n: {} for n in names},
            "instanceProperties": {
                "machineType": tmpl.get("machine_type", "a3-highgpu-8g"),
                "labels": {**self._labels(instance), GROUP_LABEL: name},
                "disks": tmpl.get("disks", []),
                "networkInterfaces": tmpl.get("network", []),
                # GPU VMs cannot live-migrate.
                "scheduling": {"onHostMaintenance": "TERMINATE"},
                "metadata": {
                    "items": [
                        {"key": "ray-start", "value": tmpl.get("startup", "")}
                    ]
                },
            },
        }
        try:
            op = self.api.bulk_insert_instances(self.zone, body)
        except GceApiError as e:
            if e.reason == ALREADY_EXISTS:
                return name
            raise
        try:
            self._wait_operation(op)
        except GceApiError:
            # Atomic group: a stocked-out or failed bulk insert must not
            # leave a VM holding quota — delete every named host before
            # surfacing the (retryable) error.
            self._delete_hosts(names)
            raise
        return name

    def _delete_hosts(self, names: List[str]) -> None:
        for n in names:
            try:
                self._wait_operation(self.api.delete_instance(self.zone, n))
            except GceApiError as e:
                if e.reason != NOT_FOUND:
                    raise

    # ---------------------------------------------------------- terminate
    def terminate(self, cloud_instance_id: str) -> None:
        group = [
            vm["name"]
            for vm in self.api.list_instances(
                self.zone,
                {**self._cluster_filter(), GROUP_LABEL: cloud_instance_id},
            )
        ]
        if group:
            self._delete_hosts(group)
            return
        try:
            op = self.api.delete_instance(self.zone, cloud_instance_id)
            self._wait_operation(op)
        except GceApiError as e:
            if e.reason == NOT_FOUND:
                return  # already gone: terminate is idempotent
            raise

    # ------------------------------------------------------------ listing
    def running_instances(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for vm in self.api.list_instances(self.zone, self._cluster_filter()):
            if vm.get("status") != "RUNNING":
                continue
            labels = vm.get("labels", {})
            group = labels.get(GROUP_LABEL)
            if group is None:
                out[vm["name"]] = {
                    "kind": "vm",
                    "node_type": labels.get("ray-node-type"),
                }
                continue
            entry = out.setdefault(group, {
                "kind": "gpu_group",
                "node_type": labels.get("ray-node-type"),
                "hosts": 0,
            })
            entry["hosts"] += 1
        return out
