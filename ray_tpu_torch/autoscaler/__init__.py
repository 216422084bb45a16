"""Autoscaler: scale nodes to unplaceable demand.

Reference: python/ray/autoscaler/v2 — an instance-manager loop reads
pending resource demand from the GCS (AutoscalerStateService,
autoscaler.proto:315), bin-packs it against node types, asks a
NodeProvider to launch/terminate instances, and downsizes idle nodes.
The FakeNodeProvider (reference:
autoscaler/_private/fake_multi_node/node_provider.py) "launches" nodes
as logical GCS nodes so the full loop is testable in one process;
``GpuHostProvider`` (gpu_hosts.py) launches atomic groups of GPU hosts
as real node daemons, and ``GceNodeProvider`` (gce.py) creates GCE VMs,
A3 groups of 8 H100 among them.
"""
from __future__ import annotations

from .autoscaler import Autoscaler, NodeProvider, FakeNodeProvider  # noqa: F401
from .gce import GceNodeProvider  # noqa: F401
from .gpu_hosts import GpuHostProvider  # noqa: F401
from .v2 import (  # noqa: F401
    CloudProvider,
    InstanceManager,
    ProcessCloudProvider,
    Reconciler,
)

__all__ = [
    "Autoscaler",
    "CloudProvider",
    "FakeNodeProvider",
    "GceNodeProvider",
    "GpuHostProvider",
    "InstanceManager",
    "NodeProvider",
    "ProcessCloudProvider",
    "Reconciler",
]
