"""Per-process global runtime state + the public API implementations.

Reference: python/ray/_private/worker.py — the module-level ``global_worker``
holding the core-worker connection, and the ``init/get/put/wait`` entry
points (worker.py:1225,2539,2679,2744).
"""
from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .client import CoreClient
from .config import RayConfig
from .node import Node, default_resources
from ..exceptions import RayTpuError
from ..object_ref import ObjectRef

DRIVER_MODE = "driver"
WORKER_MODE = "worker"


class _GlobalState:
    def __init__(self):
        self.client: Optional[CoreClient] = None
        self.node: Optional[Node] = None
        self.mode: Optional[str] = None
        self.transfer = None  # remote driver's object transfer server
        self.lock = threading.RLock()

    @property
    def connected(self) -> bool:
        return self.client is not None


_global = _GlobalState()


def global_client() -> CoreClient:
    if _global.client is None:
        import threading

        if threading.current_thread() is not threading.main_thread():
            # A background thread finding no session is a component that
            # outlived shutdown() — auto-initing here would silently
            # spawn a fresh cluster (observed: a serve handle's metrics
            # thread re-initing after the driver shut down). Only the
            # main thread auto-inits like the reference does.
            from ..exceptions import RayTpuError

            raise RayTpuError(
                "ray_tpu_torch API used from a background thread with no "
                "initialized session; call ray_tpu_torch.init() first"
            )
        # Auto-init like the reference does on first API use.
        init()
    return _global.client


def is_initialized() -> bool:
    return _global.connected


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
    _temp_dir: Optional[str] = None,
    tcp_port: Optional[int] = None,
):
    """Start a local cluster (head) or connect to an existing one.

    ``address`` is the head's session socket path (from ``node.address``)
    or ``host:port?authkey`` for a network head; None starts a new local
    head in-process, as the reference does (reference:
    _private/worker.py:1225 → Node head bring-up). ``tcp_port`` (0 = any
    free port) makes the new head listen on the network so node daemons
    (`python -m ray_tpu_torch._private.raylet --address=...`) can join.
    """
    with _global.lock:
        if _global.connected:
            if ignore_reinit_error:
                return _global.client
            raise RayTpuError("ray_tpu_torch.init() called twice; shutdown() first")
        RayConfig.initialize(_system_config)
        # Rebuild the chaos schedule from the final config (a
        # _system_config chaos/delay spec only exists after initialize).
        from . import chaos as _chaos

        _chaos.refresh()
        transfer_addr = None
        if address is None:
            node = Node(
                default_resources(num_cpus, num_gpus, resources),
                temp_dir=_temp_dir,
                tcp_port=tcp_port,
            )
            _global.node = node
            address_, authkey = node.address, node.authkey
        else:
            # address format: "<socket_path_or_host:port>?<authkey_hex>"
            address_, authkey_hex = address.rsplit("?", 1)
            authkey = bytes.fromhex(authkey_hex)
            from . import transport

            if transport.is_tcp_address(address_):
                # Remote driver: objects it puts live in its own local
                # store; run a transfer server so cluster nodes can pull
                # them (the GCS registers us as a zero-resource node).
                import os as _os
                import secrets as _secrets

                _os.environ.setdefault(
                    "RAY_TPU_TORCH_NODE_NS", _secrets.token_hex(4) + "_"
                )
                from .object_store import ObjectStore
                from .object_transfer import ObjectTransferServer

                _global.transfer = ObjectTransferServer(
                    ObjectStore(), f"{transport.node_ip()}:0", authkey
                )
                transfer_addr = _global.transfer.address
        _global.client = CoreClient(
            address_, authkey, role=DRIVER_MODE, transfer_addr=transfer_addr,
            push_handler=_driver_push,
            # External heads can be restarted under this driver (a
            # supervisor relaunches them on the same address): ride the
            # failover. An in-process head dies with this process — no
            # reconnect target exists.
            reconnect=address is not None,
        )
        _global.mode = DRIVER_MODE
        if os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0":
            # Worker stdout/stderr stream to this driver (reference:
            # log_monitor shipping lines to the driver's console).
            try:
                _global.client.request({"type": "subscribe_logs"}, timeout=5)
            except Exception:  # noqa: BLE001
                pass
        atexit.register(_atexit_shutdown)
        return _global.client


def _driver_push(msg):
    if msg.get("type") == "log_lines":
        import sys as _sys

        for node, worker_tag, line in msg["entries"]:
            print(
                f"({node} worker={worker_tag}) {line}",
                file=_sys.stdout, flush=True,
            )


def connect_existing(client: CoreClient, mode: str):
    """Adopt an already-connected client (worker processes)."""
    with _global.lock:
        _global.client = client
        _global.mode = mode


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown():
    try:
        from . import usage_stats

        if _global.mode == DRIVER_MODE:
            usage_stats.flush()  # local-only sink (zero egress)
    except Exception:  # noqa: BLE001
        pass
    with _global.lock:
        if _global.client is not None and _global.mode == DRIVER_MODE:
            try:
                # Ship this driver's flight-recorder ring before the
                # connection closes: an external driver's submission
                # events otherwise die with the process and its tasks
                # lose their submit/queue/lease phases.
                _global.client.flush_runtime_events()
            except Exception:  # noqa: BLE001
                pass
            try:
                _global.client.close()
            except Exception:
                pass
        if _global.node is not None:
            _global.node.shutdown()
        if _global.transfer is not None:
            try:
                _global.transfer.shutdown()
            except Exception:
                pass
        _global.client = None
        _global.node = None
        _global.mode = None
        _global.transfer = None


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None
) -> Any:
    client = global_client()
    if isinstance(refs, ObjectRef):
        return client.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")
    return client.get(list(refs), timeout=timeout)


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return global_client().put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    # Uniqueness on raw id bytes — but only where duplicates corrupt
    # the partition count (num_returns > 1). The drain-by-wait loop
    # (num_returns=1, called per result) must not pay an O(remaining)
    # set build per call: that alone made the 1k-ref drain O(n^2)
    # (the single_client_wait_1k_refs regression); with num_returns=1
    # a duplicate is harmless (first hit wins, the rest stay pending).
    if num_returns > 1 and len({r._id._bytes for r in refs}) != len(refs):
        raise ValueError("wait() requires unique ObjectRefs")
    return global_client().wait(refs, num_returns=num_returns, timeout=timeout)


def free(refs: Sequence[ObjectRef]):
    global_client().free(list(refs))


def kill(actor_handle, *, no_restart: bool = True):
    from ..actor import ActorHandle

    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    global_client().request(
        {
            "type": "kill_actor",
            "actor_id": actor_handle._actor_id.binary(),
            "reason": "ray_tpu_torch.kill",
        }
    )


def get_actor(name: str):
    from ..actor import ActorHandle
    from .ids import ActorID

    reply = global_client().request({"type": "get_actor", "name": name})
    if not reply.get("ok"):
        raise ValueError(f"Failed to look up actor '{name}'")
    return ActorHandle(ActorID(reply["actor_id"]))


def cluster_resources() -> Dict[str, float]:
    return global_client().cluster_info()["total"]


def available_resources() -> Dict[str, float]:
    return global_client().cluster_info()["available"]


def nodes() -> List[Dict[str, Any]]:
    return global_client().cluster_info()["nodes"]


def drain_node(
    node_id: bytes, *, reason: str = "", deadline_s: float = 30.0
) -> bool:
    """Gracefully drain a node: no new work lands on it; it is removed
    once running tasks finish, or forcibly at the deadline (reference:
    node_manager.h:551 HandleDrainRaylet / autoscaler DrainNode)."""
    reply = global_client().request(
        {
            "type": "drain_node",
            "node_id": node_id,
            "reason": reason,
            "deadline_s": deadline_s,
        }
    )
    return bool(reply.get("accepted"))
