"""GPU host-group cloud provider: atomic groups of 8xH100 hosts for
autoscaler v2.

Reference: the reference's TPU-slice provider (autoscaler/tpu_slice.py),
itself after python/ray/autoscaler/_private/gcp/node_provider.py and the
GCE queued-resource model. Here the unit is a group of GPU hosts (A3
VMs of 8 H100 80GB each) that a gang of workers needs together, joined
by their fabric; as with a TPU slice there is no such thing as half a
group. The provider therefore:

- launches a whole group per instance (one Instance record == one group
  of N hosts, each joining the cluster as its own node);
- rolls the entire group back if ANY host fails to come up (partial
  creation must never leak quota);
- terminates whole groups only.

Host 0 carries the gang resource ``GPU-<accelerator>-head``, in the role
of the reference's ``TPU-<accelerator>-head``, so a placement group that
asks for it lands on exactly one group.

The API surface (``GpuHostApi``) is the mockable seam: a real
implementation calls a cloud's API (``gce.GceNodeProvider`` speaks
GCE's); ``MockGpuHostApi`` runs each "host VM" as a real node-daemon
subprocess (the same ``ray_tpu_torch._private.raylet`` a VM startup
script would exec, with ``--num-gpus``), with injectable per-host
creation failures — so the reconciler loop is tested end-to-end against
honest group semantics on one box, and on a machine with a card the
daemon's workers get it through CUDA_VISIBLE_DEVICES.
"""
from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .v2 import CloudProvider, Instance, node_daemon_command


class PartialGroupError(RuntimeError):
    """Some hosts of a group failed to create; the group is unusable
    and must be rolled back whole."""

    def __init__(self, name: str, failed_hosts: List[int]):
        super().__init__(f"host group {name}: hosts {failed_hosts} failed")
        self.name = name
        self.failed_hosts = failed_hosts


@dataclass
class HostGroupType:
    """Shape of one group node type (e.g. 2 hosts x 8 H100)."""

    accelerator: str = "h100-80gb"
    hosts: int = 1
    # Per host; the default is an a3-highgpu-8g VM's.
    host_resources: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 208.0, "GPU": 8.0})
    max_groups: int = 4

    @property
    def head_resource(self) -> str:
        # Host 0 carries group leadership (the reference's TPU-{acc}-head).
        return f"GPU-{self.accelerator}-head"

    def node_type_config(self) -> Dict[str, Any]:
        """The autoscaler v2 node_types entry for this group type."""
        return {
            "resources": dict(self.host_resources),
            "hosts": self.hosts,
            "head_resource": self.head_resource,
            "max_workers": self.max_groups,
        }


class GpuHostApi:
    """Mockable group-granular cloud API: create/delete/list of whole
    host groups, never individual hosts."""

    def create_group(self, name: str, accelerator: str,
                     host_commands: List[List[str]]) -> None:
        """Create all hosts of a group; raises PartialGroupError if any
        host fails (leaving the survivors up, as a real partially
        fulfilled request would)."""
        raise NotImplementedError

    def delete_group(self, name: str) -> None:
        """Tear down every host of the group (idempotent)."""
        raise NotImplementedError

    def list_groups(self) -> Dict[str, Dict[str, Any]]:
        """name -> {"hosts": n_alive} for groups with any live host."""
        raise NotImplementedError


class MockGpuHostApi(GpuHostApi):
    """Each host "VM" is a real node-daemon subprocess. Failure
    injection: ``fail_next`` holds per-call lists of host indices that
    must fail to create (consumed one list per create_group call).
    ``log_dir``, where given, keeps each host's console output as
    ``<group>-h<i>.log`` (a VM's serial console); it is discarded
    otherwise."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._groups: Dict[str, List[subprocess.Popen]] = {}
        self.fail_next: List[List[int]] = []
        self.create_calls = 0
        self.deleted: List[str] = []

    def create_group(self, name, accelerator, host_commands):
        self.create_calls += 1
        failures = self.fail_next.pop(0) if self.fail_next else []
        procs: List[subprocess.Popen] = []
        failed: List[int] = []
        for i, cmd in enumerate(host_commands):
            if i in failures:
                failed.append(i)
                continue
            if self.log_dir is None:
                out = subprocess.DEVNULL
            else:
                out = open(os.path.join(self.log_dir, f"{name}-h{i}.log"), "ab")
            try:
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT))
            finally:
                if out is not subprocess.DEVNULL:
                    out.close()
        self._groups[name] = procs
        if failed:
            raise PartialGroupError(name, failed)

    def delete_group(self, name):
        for proc in self._groups.pop(name, []):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self.deleted.append(name)

    def list_groups(self):
        return {
            name: {"hosts": sum(1 for p in procs if p.poll() is None)}
            for name, procs in self._groups.items()
            if any(p.poll() is None for p in procs)
        }

    def shutdown(self):
        for name in list(self._groups):
            self.delete_group(name)


class GpuHostProvider(CloudProvider):
    """Autoscaler v2 provider with whole-group atomicity."""

    def __init__(
        self,
        api: GpuHostApi,
        group_types: Dict[str, HostGroupType],
        head_address: Optional[str] = None,
        authkey: Optional[bytes] = None,
        transfer_host: str = "127.0.0.1",
    ):
        """Without ``head_address``, the hosts join the connected head at
        its network address and key (a standalone head started with
        ``--port``, or ``init(tcp_port=0)``)."""
        if head_address is None:
            from .._private.worker import head_tcp_address

            head_address, authkey = head_tcp_address()
        self.api = api
        self.group_types = group_types
        self.head_address = head_address
        self.authkey = authkey
        self.transfer_host = transfer_host

    def node_types(self) -> Dict[str, Dict[str, Any]]:
        return {
            t: gt.node_type_config() for t, gt in self.group_types.items()
        }

    def _host_command(self, instance: Instance, gt: HostGroupType,
                      host_index: int) -> List[str]:
        resources = dict(gt.host_resources)
        if host_index == 0:
            resources[gt.head_resource] = 1.0
        return node_daemon_command(
            self.head_address, self.authkey, resources,
            f"v2:{instance.instance_id}:h{host_index}", self.transfer_host,
        )

    def launch(self, instance: Instance) -> str:
        gt = self.group_types[instance.node_type]
        name = f"group-{instance.instance_id}"
        cmds = [
            self._host_command(instance, gt, i) for i in range(gt.hosts)
        ]
        try:
            self.api.create_group(name, gt.accelerator, cmds)
        except PartialGroupError:
            # Atomic rollback: a partially created group is deleted
            # whole; the reconciler retries from QUEUED.
            self.api.delete_group(name)
            raise
        return name

    def terminate(self, cloud_instance_id: str) -> None:
        self.api.delete_group(cloud_instance_id)

    def running_instances(self) -> Dict[str, Any]:
        return dict(self.api.list_groups())
