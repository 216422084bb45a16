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


def current_session() -> Optional[CoreClient]:
    """What identifies the session this process is in: its client, or
    None outside one. A background loop that calls into the runtime keeps
    the one it started under and ends once this changes (a shutdown, or
    a shutdown and a new init), so it never reaches a later session."""
    return _global.client


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
    client_server_port: Optional[int] = None,
):
    """Start a local cluster (head) or connect to an existing one.

    ``address`` is the head's session socket path (from ``node.address``)
    or ``host:port?authkey`` for a network head, or ``"auto"`` for the
    head that ``python -m ray_tpu_torch start --head`` runs on this
    machine (its session file); None starts a new local
    head in-process, as the reference does (reference:
    _private/worker.py:1225 → Node head bring-up). ``tcp_port`` (0 = any
    free port) makes the new head listen on the network so node daemons
    (`python -m ray_tpu_torch._private.raylet --address=...`) can join.
    ``client_server_port`` (0 = any free port) makes it accept thin
    remote drivers at ``client_server_address()``; ``address`` of the form
    ``ray_tpu_torch://host:port?authkey`` connects as one.
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
        if address == "auto":
            # Connect to the machine's running head via its session file
            # (written by `python -m ray_tpu_torch start --head`).
            import json

            from .config import session_file

            path = session_file()
            try:
                with open(path) as f:
                    info = json.load(f)
                address = f"{info['address']}?{info['authkey']}"
            except (FileNotFoundError, json.JSONDecodeError, KeyError):
                raise RayTpuError(
                    "address='auto' but no running head found "
                    f"({path} missing or stale); run "
                    "`python -m ray_tpu_torch start --head`"
                ) from None
        if address is not None and address.startswith("ray_tpu_torch://"):
            # Thin remote driver (reference: ray://, util/client/worker.py):
            # one TCP connection to a head-side session process that owns
            # everything this driver creates and cleans up on disconnect.
            from .client_proxy import ProxyClient, parse_proxy_address

            hostport, pkey = parse_proxy_address(address)
            _global.client = ProxyClient(
                hostport, pkey, push_handler=_driver_push
            )
            _global.mode = DRIVER_MODE
            if os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0":
                try:
                    _global.client.request(
                        {"type": "subscribe_logs"}, timeout=5
                    )
                except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- logs to the driver are best-effort; the workers' log files keep every line
                    pass
            atexit.register(_atexit_shutdown)
            return _global.client
        transfer_addr = None
        if address is None:
            node = Node(
                default_resources(num_cpus, num_gpus, resources),
                temp_dir=_temp_dir,
                tcp_port=tcp_port,
                client_server_port=client_server_port,
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

        from ..experimental import tqdm_ray

        for node, worker_tag, line in msg["entries"]:
            # Progress-bar control lines multiplex onto the driver's
            # bar renderer instead of echoing (experimental/tqdm_ray).
            if line.startswith(tqdm_ray.MAGIC):
                if tqdm_ray.handle_magic_line(line):
                    continue
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
    try:
        from ..util import pubsub as _pubsub

        _pubsub._reset_for_shutdown()
    except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
        pass
    with _global.lock:
        if _global.client is not None and _global.mode == DRIVER_MODE:
            try:
                # Ship this driver's flight-recorder ring before the
                # connection closes: an external driver's submission
                # events otherwise die with the process and its tasks
                # lose their submit/queue/lease phases.
                _global.client.flush_runtime_events()
            except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- the events die with the process, as they would without the flush
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
            except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
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


def cancel(object_ref: ObjectRef) -> bool:
    """Cancels the task of `object_ref` while it still waits at the head
    for resources: its returns then raise TaskCancelledError. Returns
    whether it was cancelled; a task already placed runs on. The
    reference has no cancel."""
    reply = global_client().request(
        {"type": "cancel_task", "object_id": object_ref.id().binary()}
    )
    return bool(reply.get("cancelled"))


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


def client_server_address() -> Optional[str]:
    """The ``ray_tpu_torch://`` address remote drivers can connect to,
    when this head was started with ``client_server_port`` (reference:
    the ray:// address printed by `ray start --head`)."""
    node = _global.node
    return None if node is None else node.client_server_address


def head_tcp_address() -> Tuple[str, bytes]:
    """The connected head's network address and key, which a node
    daemon joins with: the in-process head's, the address this driver
    connected to over TCP, or, for a driver on a standalone head's
    socket (``init(address="auto")``), the TCP address in its session
    file. Raises where the head does not listen on the network."""
    node = _global.node
    if node is not None:
        if node.tcp_address:
            return node.tcp_address, node.authkey
        raise RayTpuError("the head does not listen on TCP; init(tcp_port=0)")
    from . import transport

    client = global_client()
    if transport.is_tcp_address(client._address):
        return client._address, client._authkey
    import json

    from .config import session_file

    try:
        with open(session_file()) as f:
            info = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        info = {}
    if info.get("address") == client._address and info.get("tcp_address"):
        return info["tcp_address"], bytes.fromhex(info["authkey"])
    raise RayTpuError(
        "the head does not listen on TCP; start it with "
        "`python -m ray_tpu_torch start --head --port 0`"
    )


def head_node_id() -> bytes:
    """The head node's id: where the job supervisors and the dashboard
    run, as in upstream Ray, so no autoscaled node is kept busy by them."""
    for n in nodes():
        if n["alive"] and n.get("label") == "head":
            return n["node_id"]
    raise RayTpuError("the cluster has no live head node")
