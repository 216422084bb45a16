"""Autoscaler loop + node providers."""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Plugin surface (reference: autoscaler/node_provider.py)."""

    def create_node(self, node_type: str, resources: Dict[str, float]) -> Any:
        raise NotImplementedError

    def terminate_node(self, node: Any) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Any]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Logical in-GCS nodes (reference fake_multi_node provider)."""

    def __init__(self):
        from ..cluster_utils import Cluster

        self._cluster = Cluster(initialize_head=False)
        self._nodes: List[Any] = []

    def create_node(self, node_type: str, resources: Dict[str, float]):
        node = self._cluster.add_node(
            num_cpus=resources.get("CPU", 1),
            num_gpus=resources.get("GPU", 0),
            resources={
                k: v for k, v in resources.items() if k not in ("CPU", "GPU")
            },
            label=f"autoscaled:{node_type}",
        )
        self._nodes.append(node)
        return node

    def terminate_node(self, node) -> None:
        self._cluster.remove_node(node)
        if node in self._nodes:
            self._nodes.remove(node)

    def non_terminated_nodes(self):
        return list(self._nodes)


from .._private.gcs import _fits  # same predicate the scheduler uses


class Autoscaler:
    """Reconcile unplaceable demand against node types.

    node_types: {name: {"resources": {...}, "max_workers": N}}.
    """

    def __init__(
        self,
        node_types: Dict[str, Dict[str, Any]],
        provider: Optional[NodeProvider] = None,
        *,
        idle_timeout_s: float = 30.0,
        interval_s: float = 1.0,
    ):
        self.node_types = node_types
        self.provider = provider or FakeNodeProvider()
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        self._counts: Dict[str, int] = {t: 0 for t in node_types}
        self._node_type: Dict[bytes, str] = {}
        self._idle_since: Dict[bytes, float] = {}
        self._draining: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_launches = 0
        self.num_terminations = 0

    # -------------------------------------------------------------- loop
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.update()
            except Exception:  # noqa: BLE001 - survive transient errors
                pass
            self._stop.wait(self.interval_s)

    # ------------------------------------------------------------ update
    def _demand(self) -> Dict[str, Any]:
        from .._private.worker import global_client

        reply = global_client().request({"type": "get_pending_demand"})
        if not reply.get("ok"):
            raise RuntimeError("get_pending_demand failed")
        return reply

    def update(self):
        reply = self._demand()
        demands: List[Dict[str, float]] = list(reply["task_demands"])
        for bundle_list in reply["pg_demands"]:
            demands.extend(bundle_list)

        # Bin-pack unmet demand onto hypothetical new nodes (reference:
        # resource_demand_scheduler.py).
        to_launch: Dict[str, int] = {}
        capacities: List[Dict[str, float]] = []
        for shape in demands:
            if not shape:
                continue
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
                if self._counts[t] + to_launch.get(t, 0) >= cfg.get(
                    "max_workers", 10
                ):
                    continue
                if _fits(cfg["resources"], shape):
                    cap = dict(cfg["resources"])
                    for k, v in shape.items():
                        cap[k] -= v
                    capacities.append(cap)
                    to_launch[t] = to_launch.get(t, 0) + 1
                    break
        for t, n in to_launch.items():
            for _ in range(n):
                node = self.provider.create_node(t, self.node_types[t]["resources"])
                self._counts[t] += 1
                self._node_type[node.node_id] = t
                self.num_launches += 1

        # Scale down nodes idle beyond the timeout: drain gracefully
        # first (no new placements; the GCS finalizes removal when the
        # node is quiet — reference: autoscaler DrainNode before
        # termination), then release the provider instance.
        from .._private.worker import global_client

        now = time.monotonic()
        idle = set(reply["idle_nodes"])
        alive = {
            n["node_id"]
            for n in global_client().cluster_info()["nodes"]
            if n["alive"]
        }
        for node in list(self.provider.non_terminated_nodes()):
            nid = node.node_id
            if nid in self._draining:
                if nid not in alive:  # drain finalized by the GCS
                    t = self._node_type.pop(nid, None)
                    if t:
                        self._counts[t] -= 1
                    self.provider.terminate_node(node)
                    self._draining.discard(nid)
                    self.num_terminations += 1
                continue
            if nid in idle:
                since = self._idle_since.setdefault(nid, now)
                if now - since >= self.idle_timeout_s:
                    from .._private.worker import drain_node

                    drain_node(
                        nid, reason="idle scale-down", deadline_s=30.0
                    )
                    self._draining.add(nid)
                    self._idle_since.pop(nid, None)
            else:
                self._idle_since.pop(nid, None)
